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
``RunConfig.seed``. The overlay dump and the BA backend are later slices and
raise.
"""
from __future__ import annotations

import logging
import time
from typing import Iterable

import numpy as np
import torch

from . import frontend as frontend_mod
from ..utils import trajectory as traj_mod
from ..utils.config import RunConfig, rig_from_config

log = logging.getLogger(__name__)


def _to_host(tree: dict) -> dict:
    """Copy a dict of tensors to numpy (one sync for the whole dict)."""
    return {k: v.cpu().numpy() for k, v in tree.items()}


class System:
    """End-to-end VO runtime around the LK or ORB frontend."""

    def __init__(self, config: RunConfig, device="cuda", backend_cfg=None):
        frontend_mod.check_supported(config.vo, backend_cfg)
        if config.overlay_dir:
            raise NotImplementedError(
                "overlay_dir is not ported yet: ROADMAP.md Queue 1, slice 5 "
                "(the CLI, online feed and checkpoint)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"System(device={device!r}) needs an NVIDIA GPU and "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "on the CPU")
        self.config = config
        self.rig = rig_from_config(config.camera, device=self.device)
        self.vo_cfg = config.vo
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.init_fn, self.step_fn = frontend_mod.make_frontend(
            self.vo_cfg, self.rig, device=self.device, generator=self.generator)
        self.state = None
        self.status = frontend_mod.INITING
        self.lost_count = 0
        self.max_lost_before_reinit = 3
        self.poses: list[np.ndarray] = []
        self.metrics: list[dict] = []
        self.frame_times: list[float] = []
        self.frame_idx = 0

    # ------------------------------------------------------------------ #

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reinit(self, init_fn, img_l, img_r) -> None:
        """Fresh detection on this frame, keeping the pose chain.

        ``self.status`` is left as it is (LOST): the next frame steps from
        the fresh detections instead of re-initialising, which would reset
        the pose to identity (as the JAX ``System.step`` behaves).
        """
        T_wc = self.state["T_wc"]
        self.state = init_fn(img_l, img_r)
        self.state["T_wc"] = T_wc
        self.lost_count = 0

    def step(self, img_l: np.ndarray, img_r: np.ndarray) -> dict:
        """Process one stereo pair; returns the per-frame metric dict."""
        t0 = time.perf_counter()
        if self.state is None or self.status == frontend_mod.INITING:
            self.state = self.init_fn(img_l, img_r)
            self.status = int(self.state["status"])
            m = {"accept": False, "init": True,
                 "n_detected": int(self.state["n_detected"])}
        else:
            self.state, metrics = self.step_fn(self.state, img_l, img_r)
            m = _to_host(metrics)
            self.status = int(self.state["status"])
            m["accept"] = bool(m["accept"])
            m["init"] = False
            if self.status == frontend_mod.LOST:
                self.lost_count += 1
                if self.lost_count >= self.max_lost_before_reinit:
                    log.warning("tracking lost %d frames; reinitializing",
                                self.lost_count)
                    self._reinit(self.init_fn, img_l, img_r)
            else:
                self.lost_count = 0
        pose = self.state["T_wc"].cpu().numpy().astype(np.float64)
        dt = time.perf_counter() - t0
        self.frame_times.append(dt)
        self.poses.append(pose)
        m["time_s"] = dt
        self.metrics.append(m)
        self.frame_idx += 1
        return m

    step_online = step

    # ------------------------------------------------------------------ #

    def _finish(self) -> np.ndarray:
        traj = np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))
        if self.config.trajectory_out:
            traj_mod.save_kitti(self.config.trajectory_out, traj)
            log.info("wrote %d poses to %s", len(traj), self.config.trajectory_out)
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
                log.info("frame %d status=%d time=%.1fms", i, self.status,
                         1e3 * m["time_s"])
        return self._finish()

    def run_chunked(self, frames: Iterable[tuple[np.ndarray, np.ndarray]],
                    chunk: int = 8, max_frames: int = -1) -> np.ndarray:
        """Offline-throughput loop: one host round trip per ``chunk`` frames.

        Per-frame metric dicts land in ``self.metrics`` (timing is the chunk
        wall clock split evenly across its frames), and LOST->reinit runs at
        chunk granularity, as in the JAX ``run_chunked``.
        """
        init_fn, chunk_fn = frontend_mod.make_chunked_frontend(
            self.vo_cfg, self.rig, device=self.device, generator=self.generator)
        buf_l: list[np.ndarray] = []
        buf_r: list[np.ndarray] = []

        def flush():
            if not buf_l:
                return
            il = torch.as_tensor(np.stack(buf_l), device=self.device)
            ir = torch.as_tensor(np.stack(buf_r), device=self.device)
            buf_l.clear()
            buf_r.clear()
            if self.state is None:
                self.state = init_fn(il[0], ir[0])
                self.poses.append(self.state["T_wc"].cpu().numpy().astype(np.float64))
                self.metrics.append({"accept": False, "init": True,
                                     "n_detected": int(self.state["n_detected"]),
                                     "time_s": 0.0})
                self.frame_times.append(0.0)
                il, ir = il[1:], ir[1:]
                if il.shape[0] == 0:
                    return
            self._sync()
            t0 = time.perf_counter()
            self.state, m = chunk_fn(self.state, il, ir)
            m = _to_host(m)
            dt = time.perf_counter() - t0
            n = len(m["T_wc"])
            per_frame = dt / max(n, 1)
            statuses = np.where(m["n_detected"] >= self.vo_cfg.min_features_detect,
                                frontend_mod.TRACKING_GOOD, frontend_mod.LOST)
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
                })
                self.frame_times.append(per_frame)
                self.lost_count = (self.lost_count + 1
                                   if statuses[t] == frontend_mod.LOST else 0)
            self.status = int(self.state["status"])
            if self.lost_count >= self.max_lost_before_reinit:
                log.warning("tracking lost %d frames; reinitializing (chunked)",
                            self.lost_count)
                self._reinit(init_fn, il[-1], ir[-1])
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

    # ------------------------------------------------------------------ #

    @property
    def fps(self) -> float:
        ts = self.frame_times[1:]  # skip the init frame
        return len(ts) / sum(ts) if ts else 0.0

    def summary(self) -> dict:
        acc = [m.get("accept", False) for m in self.metrics if not m.get("init")]
        return {
            "frames": len(self.poses),
            "fps": self.fps,
            "accept_rate": float(np.mean(acc)) if acc else 0.0,
            "status": self.status,
        }
