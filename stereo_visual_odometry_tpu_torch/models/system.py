"""System runtime: config -> per-frame VO loop -> trajectory.

Port of ``stereo_visual_odometry_tpu/models/system.py``: ``step`` processes
one stereo pair, ``run`` is the blocking per-frame loop, ``run_chunked`` the
offline-throughput loop over frame chunks. The tracking state machine
(INITING / TRACKING_GOOD / LOST) runs on the host with LOST->reinit after a
few feature-starved frames, preserving the pose chain.

``System`` runs on the card (``device="cuda"``) unless the caller asks for
the CPU with ``device="cpu"``; without a GPU, the default raises. The
frontend is chosen by ``VOConfig.mode`` (LK or ORB); its state is opaque
here. RANSAC draws come from a ``torch.Generator`` on the device seeded from
``RunConfig.seed``. With ``RunConfig.overlay_dir`` set, ``step`` writes the
frame's association overlay every ``overlay_every`` frames (not on an init
frame; ``utils/viz.draw_tracks``), as JAX's; ``run_chunked`` writes none.
``run_kitti`` runs the configured KITTI directory. Logs go through
``utils/logging.get_logger``.

``backend_cfg`` adds the sliding-window BA backend (``models/backend.py``,
JAX config 3), which needs ``persistent_tracks``: ``step`` hands it the
frame's track slots, makes keyframes, solves on the ``System``'s device
and applies the latest keyframe's correction to the live pose, which is
also the pose ``step`` records. ``run_chunked`` is frontend-only.

On cuda, ``step`` and ``run_chunked`` replay the frontend step from one CUDA
graph per ``System`` (``models/step_graph.py``, the counterpart of the JAX
package's jitted step): the frontend state lives in the graph's buffers, a
frame is copied into its static inputs, and its RANSAC draws are taken from
the generator outside the graph with the eager step's own call, so both
routes draw the same values in the same order. ``graph=False`` runs the
step eagerly instead: an A/B switch, like ``jax.disable_jit``, for holding
the graph to the eager step. The CPU always runs eagerly. Each frame hands
the host only what it consumes (``frontend.frame_outputs``: the overlay's
arrays only when it dumps overlays), in one copy (``utils/hostcopy.py``).
``step`` and ``run_chunked``'s chunks are spans (``system.step``,
``run_chunked.chunk`` and their stages; ``utils/profiling.span``), recorded
while a recorder is on.
"""
from __future__ import annotations

import os
import time
from typing import Iterable

import numpy as np
import torch

from . import frontend as frontend_mod
from . import step_graph
from .backend import SlidingWindowBA
from ..ops import pnp
from ..utils import profiling
from ..utils import trajectory as traj_mod
from ..utils.config import RunConfig, rig_from_config
from ..utils.hostcopy import device_get_tree
from ..utils.logging import get_logger


class System:
    """End-to-end VO runtime around the LK or ORB frontend."""

    def __init__(self, config: RunConfig, device="cuda", backend_cfg=None,
                 graph: bool = True):
        """``graph``: on cuda, replay the step from a CUDA graph (the
        default); False runs it eagerly (the A/B switch). The CPU runs
        eagerly either way. ``backend_cfg``: a ``backend.BackendConfig``
        for the BA backend, or None."""
        frontend_mod.check_supported(config.vo)
        if backend_cfg is not None and not config.vo.persistent_tracks:
            raise ValueError("the BA backend needs VOConfig(persistent_tracks=True)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"System(device={device!r}) needs an NVIDIA GPU and "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "on the CPU")
        self.config = config
        self.log = get_logger("models.system")
        self._overlays = bool(config.overlay_dir)
        self.rig = rig_from_config(config.camera, device=self.device)
        self.vo_cfg = config.vo
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.init_fn, self.step_fn = frontend_mod.make_frontend(
            self.vo_cfg, self.rig, device=self.device, generator=self.generator)
        self.graph = (step_graph.StepGraph(self.step_fn, self.vo_cfg, self.device,
                                           overlays=self._overlays)
                      if graph and self.device.type == "cuda" else None)
        self.state = None
        self.status = frontend_mod.INITING
        self.lost_count = 0
        self.max_lost_before_reinit = 3
        self.poses: list[np.ndarray] = []
        self.metrics: list[dict] = []
        self.frame_idx = 0
        self.backend = (None if backend_cfg is None else SlidingWindowBA(
            self.rig.left, backend_cfg, T_rl=self.rig.T_rl.cpu().numpy(),
            device=self.device))

    # ------------------------------------------------------------------ #

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _set_state(self, state: dict) -> None:
        """Make ``state`` the live frontend state; under the graph, copied
        into the graph's state buffers, which stay the live state."""
        self.state = state if self.graph is None else self.graph.load_state(state)

    def _advance(self, img_l, img_r) -> dict:
        """One step from the live state: the frame's ``frame_outputs``
        tensors (under the graph its output buffers, valid until the next
        step)."""
        if self.graph is None:
            self.state, metrics = self.step_fn(self.state, img_l, img_r)
            return frontend_mod.frame_outputs(self.state, metrics, self._overlays)
        u = pnp.draw_uniforms(self.vo_cfg.num_hypotheses, self.generator, device=self.device)
        return self.graph.replay(img_l, img_r, u)

    def _init(self, img_l, img_r) -> tuple[dict, np.ndarray]:
        """Detect on this frame (the INITING step); returns its metric dict
        and pose."""
        self._set_state(self.init_fn(img_l, img_r))
        h = device_get_tree({k: self.state[k] for k in ("status", "n_detected", "T_wc")})
        self.status = int(h["status"])
        m = {"accept": False, "init": True, "n_detected": int(h["n_detected"])}
        return m, h["T_wc"].astype(np.float64)

    def _reinit(self, img_l, img_r) -> None:
        """Fresh detection on this frame, keeping the pose chain.

        ``self.status`` is left as it is (LOST): the next frame steps from
        the fresh detections instead of re-initialising, which would reset
        the pose to identity (as the JAX ``System.step`` behaves).
        """
        state = self.init_fn(img_l, img_r)
        state["T_wc"] = self.state["T_wc"]
        self._set_state(state)
        self.lost_count = 0

    def step(self, img_l: np.ndarray, img_r: np.ndarray) -> dict:
        """Process one stereo pair; returns the per-frame metric dict."""
        with profiling.span("system.step"):
            t0 = time.perf_counter()
            if self.state is None or self.status == frontend_mod.INITING:
                m, pose = self._init(img_l, img_r)
            else:
                frame = self._advance(img_l, img_r)
                with profiling.span("system.fetch"):
                    m = device_get_tree(frame)
                self.status = int(m.pop("status"))
                pose = m.pop("T_wc").astype(np.float64)  # a reinit keeps it
                m["accept"] = bool(m["accept"])
                m["init"] = False
                if self.status == frontend_mod.LOST:
                    self.lost_count += 1
                    if self.lost_count >= self.max_lost_before_reinit:
                        self.log.warning("tracking lost %d frames; reinitializing",
                                         self.lost_count)
                        self._reinit(img_l, img_r)
                else:
                    self.lost_count = 0
                # The association overlay (the reference's displayTracking
                # window, tracking.cpp:354-382, rendered offline).
                if self._overlays and self.frame_idx % max(self.config.overlay_every, 1) == 0:
                    self._dump_overlay(img_l, m)
                if self.backend is not None:
                    pose = self._refine(m, pose)
            m["time_s"] = time.perf_counter() - t0
            self.poses.append(pose)
            self.metrics.append(m)
            self.frame_idx += 1
            return m

    step_online = step  # ``Step_ros`` equivalent: externally-fed frames.

    def _dump_overlay(self, img_l, m: dict) -> None:
        """Write this frame's association overlay PNG."""
        from ..utils.viz import draw_tracks

        os.makedirs(self.config.overlay_dir, exist_ok=True)
        path = os.path.join(self.config.overlay_dir, f"tracks_{self.frame_idx:06d}.png")
        draw_tracks(path, torch.as_tensor(img_l).cpu().numpy(), m["tracked_prev"],
                    m["tracked_cur"], m["tracked_valid"])

    def _refine(self, m: dict, T_wc: np.ndarray) -> np.ndarray:
        """The backend's part of a tracked frame (JAX ``models/system.py:
        107-124``): tick, maybe a keyframe and a window solve. A solve's
        correction of the latest keyframe goes into the live pose, copied
        into the state's tensor (under the graph the graph's buffer, which
        the next replay reads); returns the pose to record."""
        be = self.backend
        be.tick()
        if not be.should_add_keyframe(self.frame_idx, int(m["n_tracked"])):
            return T_wc
        be.add_keyframe(self.frame_idx, T_wc, m["track_id"], m["track_xy"],
                        m["track_valid"], m["pts3d_cur"], m["pts3d_cur_valid"],
                        track_xy_r=m["track_xy_r"],
                        track_stereo_valid=m["track_stereo_valid"],
                        n_tracked=int(m["n_tracked"]))
        res = be.optimize()
        if res is None:
            return T_wc
        corrected = (res["correction"] @ T_wc).astype(np.float32)
        self.state["T_wc"].copy_(torch.from_numpy(corrected))
        m["ba"] = res
        return corrected.astype(np.float64)

    # ------------------------------------------------------------------ #

    def _finish(self) -> np.ndarray:
        traj = np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))
        if self.config.trajectory_out:
            traj_mod.save_kitti(self.config.trajectory_out, traj)
            self.log.info("wrote %d poses to %s", len(traj), self.config.trajectory_out)
        return traj

    def run(self, frames: Iterable[tuple[np.ndarray, np.ndarray]],
            max_frames: int = -1) -> np.ndarray:
        """Blocking loop over stereo pairs; returns the (N, 4, 4) trajectory
        (also written to ``config.trajectory_out`` if set)."""
        for i, (il, ir) in enumerate(frames):
            if 0 <= max_frames <= i:
                break
            m = self.step(il, ir)
            if i % 50 == 0:
                self.log.info("frame %d status=%d time=%.1fms", i, self.status,
                              1e3 * m["time_s"])
        return self._finish()

    def run_chunked(self, frames: Iterable[tuple[np.ndarray, np.ndarray]],
                    chunk: int = 8, max_frames: int = -1) -> np.ndarray:
        """Offline-throughput loop: one host round trip per ``chunk`` frames.

        Per-frame metric dicts land in ``self.metrics`` (timing is the chunk
        wall clock split evenly across its frames), and LOST->reinit runs at
        chunk granularity, as in the JAX ``run_chunked``. A chunk is uploaded
        once; each frame's outputs are copied into the chunk's (T, ...)
        tensors on the device, which reach the host in one copy. With
        persistent tracks each frame's dict also holds its ``TRACK_KEEP``
        arrays. Refuses a ``System`` with a backend, as the JAX one does:
        the backend needs the host after every frame (use ``run``).
        """
        if self.backend is not None:
            raise ValueError("run_chunked is frontend-only: a System with a BA "
                             "backend runs frame by frame (System.run)")
        buf_l: list[np.ndarray] = []
        buf_r: list[np.ndarray] = []

        def flush():
            if buf_l:
                with profiling.span("run_chunked.chunk"):
                    advance_chunk()

        def advance_chunk():
            with profiling.span("run_chunked.upload"):
                il = torch.as_tensor(np.stack(buf_l), device=self.device)
                ir = torch.as_tensor(np.stack(buf_r), device=self.device)
            buf_l.clear()
            buf_r.clear()
            if self.state is None:
                m, pose = self._init(il[0], ir[0])
                self.poses.append(pose)
                self.metrics.append(dict(m, time_s=0.0))
                il, ir = il[1:], ir[1:]
                if il.shape[0] == 0:
                    return
            with profiling.span("run_chunked.sync"):
                self._sync()
            t0 = time.perf_counter()
            n = il.shape[0]
            out = {}
            with profiling.span("run_chunked.replays"):
                for t in range(n):  # the chunk's (T, ...) outputs, one host copy
                    frame = self._advance(il[t], ir[t])
                    if not out:
                        out = {k: v.new_empty((n,) + v.shape) for k, v in frame.items()}
                    for k, v in frame.items():
                        out[k][t].copy_(v)
            with profiling.span("run_chunked.fetch"):
                m = device_get_tree(out)
            per_frame = (time.perf_counter() - t0) / n
            with profiling.span("run_chunked.unpack"):
                for t in range(n):
                    self.poses.append(m["T_wc"][t].astype(np.float64))
                    self.metrics.append({
                        "accept": bool(m["accept"][t]), "init": False,
                        "n_tracked": int(m["n_tracked"][t]),
                        "n_detected": int(m["n_detected"][t]),
                        "n_inliers": int(m["n_inliers"][t]),
                        "inlier_ratio": float(m["inlier_ratio"][t]),
                        "t_norm": float(m["t_norm"][t]),
                        "T_21": m["T_21"][t].astype(np.float64),
                        "time_s": per_frame,
                        **{k: m[k][t] for k in frontend_mod.TRACK_KEEP if k in m},
                    })
                    self.lost_count = (self.lost_count + 1
                                       if m["status"][t] == frontend_mod.LOST else 0)
            self.status = int(m["status"][-1])
            if self.lost_count >= self.max_lost_before_reinit:
                self.log.warning("tracking lost %d frames; reinitializing (chunked)",
                                 self.lost_count)
                self._reinit(il[-1], ir[-1])
                self.status = int(self.state["status"])

        for i, (il, ir) in enumerate(frames):
            if 0 <= max_frames <= i:
                break
            buf_l.append(il)
            buf_r.append(ir)
            if len(buf_l) == chunk + (1 if self.state is None else 0):
                flush()
        flush()
        self.frame_idx = len(self.poses)
        return self._finish()

    def run_kitti(self) -> np.ndarray:
        """Run on the configured KITTI sequence directory (``run`` over its
        frames, decoded ahead on the loader's threads)."""
        from ..utils.kitti import KittiStereoDataset

        ds = KittiStereoDataset(self.config.dataset_dir,
                                static_hw=(self.vo_cfg.height, self.vo_cfg.width))
        return self.run(ds.iter_prefetch(), self.config.max_frames)

    # ------------------------------------------------------------------ #

    @property
    def fps(self) -> float:
        ts = [m["time_s"] for m in self.metrics[1:]]  # skip the init frame
        return len(ts) / sum(ts) if ts else 0.0

    def summary(self) -> dict:
        acc = [m.get("accept", False) for m in self.metrics if not m.get("init")]
        return {
            "frames": len(self.poses),
            "fps": self.fps,
            "accept_rate": float(np.mean(acc)) if acc else 0.0,
            "status": self.status,
        }
