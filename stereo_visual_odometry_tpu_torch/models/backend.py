"""Sliding-window backend: keyframes, landmark bookkeeping, local BA.

Port of ``stereo_visual_odometry_tpu/models/backend.py``. The host
bookkeeping stays in numpy, as in JAX: per keyframe a dict track_id ->
(left pixel, right pixel or None), a landmark dict track_id -> world xyz,
the float64 keyframe poses and their inversions. The window solve
(``models/ba.py``) and the prior build (``models/marg.py``) run on the
backend's device, over fixed-capacity tables.

Flow (JAX config 3): the frontend, with persistent tracks, hands each
frame's track slots and the current pair's depths; every ``kf_every``
frames, or when the tracks thin out, a keyframe is made; landmarks start
from a keyframe's stereo triangulation (world frame); the local BA refines
the window's poses and landmarks with the oldest pose fixed; the latest
keyframe's correction goes back to the live pose (``System``).

On the card the window solve replays from a CUDA graph
(``models/ba_graph.py``), one per problem key: the backend's tables have
fixed capacities, so a backend captures two, before its first slide (no
prior) and after it. Elsewhere it runs ``ba.bundle_adjust`` eagerly.

Spans (``utils/profiling.span``, recorded while a recorder is on):
``backend.keyframe`` (``add_keyframe``), ``backend.marginalize`` (a slide's
``_marginalize_oldest`` with its prior build, inside ``backend.keyframe``)
and ``backend.solve`` (``optimize``; a CUDA event pair on the card) with its
stages ``backend.problem``, ``backend.lm`` and ``backend.fetch``; on the
card ``backend.lm`` holds the graphed solve's ``backend.capture`` (a key's
first solve) and ``backend.replay`` (timed).

A caller that checks the backend's work sets ``SlidingWindowBA.log`` to a
list (or anything with ``append``): each slide that marginalizes appends
``("slide", inputs, prior)`` and each solve ``("solve", problem, solved)``,
by reference (no copy, no wait). ``inputs`` are ``marg.build_prior``'s
arguments before the carried prior (the pre-slide window's camera_from_world
poses, the consumed landmarks and every observation of them, ``T_rl``,
``huber_px``), ``prior`` the new prior as the backend keeps it (numpy, over
the slid window); a slide that consumes no landmark keeps the prior as it
was and appends ``("slide", None, None)``. ``problem`` is the keyword
arguments of the solve, ``solved`` what it returned.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import ba, ba_graph, marg
from .frontend import resolve_device
from ..ops.camera import Pinhole
from ..utils import profiling
from ..utils.hostcopy import device_get_tree


# What a solve brings back to the host, in one copy.
FETCHED = ("poses", "points", "cost_initial", "cost_final", "lm_accepted")


@dataclasses.dataclass
class BackendConfig:
    """The JAX ``BackendConfig``'s fields and defaults (a test holds them
    equal)."""

    window: int = 6            # keyframes in the optimization window
    kf_every: int = 5          # frames between keyframes
    max_landmarks: int = 512   # landmark capacity per window
    max_obs: int = 4096        # observation capacity per window
    ba_iters: int = 8
    huber_px: float = 2.0
    min_track_obs: int = 2     # a landmark needs >= 2 observing keyframes
    # Schur-marginalize sliding keyframes into a pose prior (models/marg.py)
    # instead of dropping their information.
    marginalize: bool = True
    # Exponential forgetting of the carried prior at each slide: a
    # first-order prior is never relinearized, so an undecayed chain
    # accumulates stale-linearization bias.
    prior_decay: float = 0.5
    # Which landmarks a slide consumes: "dying" (every landmark of the
    # oldest keyframe whose track ended) or, for any other value as in JAX,
    # "underconstrained" (only those with <= 1 other observing keyframe).
    marg_policy: str = "dying"


class SlidingWindowBA:
    """Keyframe window + local bundle adjustment with stereo residuals (the
    right-camera observations pin the scale a monocular window leaves
    free). ``cam`` is the left camera, on ``device`` (the card unless the
    caller asks for another); ``T_rl`` the rig's right_from_left.
    ``self.solve`` is the window solve: on the card ``self.solve_graph``,
    a ``ba_graph.SolveGraph`` (``ba.bundle_adjust`` replayed from a CUDA
    graph), elsewhere ``ba.bundle_adjust`` itself (``solve_graph`` None). A
    caller may put in its place a function of the same keyword arguments
    that returns what it returns (a check's stand-in)."""

    def __init__(self, cam: Pinhole, cfg: BackendConfig = BackendConfig(),
                 T_rl: np.ndarray | None = None, device="cuda"):
        self.device = resolve_device(device, (cam.fx, cam.fy, cam.cx, cam.cy),
                                     what="BA backend", inputs="camera")
        self.cam = cam
        self.cfg = cfg
        self.T_rl = np.eye(4) if T_rl is None else np.asarray(T_rl, np.float64)
        self._T_rl = torch.tensor(self.T_rl, dtype=torch.float32, device=self.device)
        self.kf_poses: list[np.ndarray] = []                 # T_wc per keyframe
        self.kf_obs: list[dict[int, tuple]] = []             # track_id -> (uv, uv_r)
        self.landmarks: dict[int, np.ndarray] = {}           # track_id -> world xyz
        self.frame_of_kf: list[int] = []
        self._frames_since_kf = 10 ** 9
        self._last_kf_n_tracked = 0
        # The marginalization prior over the window's pose slots, as numpy
        # (``marg`` layout, capacity cfg.window); None until the first slide.
        self.prior: dict | None = None
        self.solve_graph = ba_graph.SolveGraph() if self.device.type == "cuda" else None
        self.solve = ba.bundle_adjust if self.solve_graph is None else self.solve_graph
        self.log = None              # where slides and solves are logged (above)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ #

    def should_add_keyframe(self, frame_idx: int, n_tracked: int) -> bool:
        """Cadence, or the tracks thinning to half of the last keyframe's."""
        if not self.kf_obs:
            return True
        return (self._frames_since_kf >= self.cfg.kf_every or
                n_tracked < 0.5 * max(self._last_kf_n_tracked, 1))

    def add_keyframe(self, frame_idx: int, T_wc: np.ndarray, track_id, track_xy,
                     track_valid, pts3d_cur, pts3d_valid, track_xy_r=None,
                     track_stereo_valid=None, n_tracked: int | None = None) -> None:
        """Record a keyframe from a frame's track arrays (copied)."""
        with profiling.span("backend.keyframe"):
            self._last_kf_n_tracked = (int(np.sum(np.asarray(track_valid)))
                                       if n_tracked is None else int(n_tracked))
            track_id = np.array(track_id)
            track_xy = np.array(track_xy)
            track_valid = np.array(track_valid)
            pts3d_cur = np.array(pts3d_cur)
            pts3d_valid = np.array(pts3d_valid)
            track_xy_r = None if track_xy_r is None else np.array(track_xy_r)
            track_stereo_valid = (np.zeros(len(track_id), bool) if track_stereo_valid is None
                                  else np.array(track_stereo_valid))
            T_wc = np.asarray(T_wc, np.float64)

            obs = {}
            for i, t in enumerate(track_id):
                if track_valid[i] and t >= 0:
                    uv_r = (track_xy_r[i] if track_xy_r is not None and track_stereo_valid[i]
                            else None)
                    obs[int(t)] = (track_xy[i], uv_r)
            self.kf_poses.append(T_wc)
            self.kf_obs.append(obs)
            self.frame_of_kf.append(frame_idx)
            # Landmark init: the first stereo depth wins (a stable anchor).
            R, t = T_wc[:3, :3], T_wc[:3, 3]
            for i, tid in enumerate(track_id):
                tid = int(tid)
                if tid >= 0 and track_valid[i] and pts3d_valid[i] and tid not in self.landmarks:
                    self.landmarks[tid] = R @ pts3d_cur[i] + t
            # Slide the window: marginalize, or drop the oldest.
            if len(self.kf_poses) > self.cfg.window:
                if self.cfg.marginalize:
                    with profiling.span("backend.marginalize"):
                        self._marginalize_oldest()
                self.kf_obs.pop(0)
                self.kf_poses.pop(0)
                self.frame_of_kf.pop(0)
                live = set()
                for o in self.kf_obs:
                    live.update(o.keys())
                for tid in list(self.landmarks):
                    if tid not in live:
                        del self.landmarks[tid]
            self._frames_since_kf = 0

    def _obs_table(self, tid_to_idx: dict, consume: bool = False):
        """The fixed-capacity observation table (numpy) of the landmarks in
        ``tid_to_idx`` over the window's keyframes, left then right pixel;
        ``consume`` deletes each listed observation from keyframes 1.. (as
        JAX does, also past ``max_obs``). Returns (obs_kf, obs_lm, obs_uv,
        obs_w, obs_right, m)."""
        n = self.cfg.max_obs
        obs_kf, obs_lm = np.zeros(n, np.int32), np.zeros(n, np.int32)
        obs_uv, obs_w = np.zeros((n, 2), np.float32), np.zeros(n, np.float32)
        obs_right = np.zeros(n, bool)
        m = 0
        for k, o in enumerate(self.kf_obs):
            for tid in list(o):
                i = tid_to_idx.get(tid)
                if i is None or (m >= n and not consume):
                    continue
                uv, uv_r = o[tid]
                if m < n:
                    obs_kf[m], obs_lm[m], obs_uv[m], obs_w[m] = k, i, uv, 1.0
                    m += 1
                if uv_r is not None and m < n:
                    obs_kf[m], obs_lm[m], obs_uv[m] = k, i, uv_r
                    obs_right[m], obs_w[m] = True, 1.0
                    m += 1
                if consume and k > 0:
                    del o[tid]  # keyframe 0's own dict is popped anyway
        return obs_kf, obs_lm, obs_uv, obs_w, obs_right, m

    def _points(self, tid_to_idx: dict) -> np.ndarray:
        points = np.zeros((self.cfg.max_landmarks, 3), np.float32)
        for t, i in tid_to_idx.items():
            points[i] = self.landmarks[t]
        return points

    def _table_on_device(self, tid_to_idx: dict, consume: bool = False) -> tuple[dict, int]:
        """The landmarks and their observation table on the device, as
        keyword arguments of ``ba.bundle_adjust`` / ``marg.build_prior``,
        and the number of observations."""
        obs_kf, obs_lm, obs_uv, obs_w, obs_right, m = self._obs_table(tid_to_idx, consume)
        kw = {"points": self._dev(self._points(tid_to_idx)), "obs_kf": self._dev(obs_kf),
              "obs_lm": self._dev(obs_lm), "obs_uv": self._dev(obs_uv),
              "obs_w": self._dev(obs_w), "obs_right": self._dev(obs_right),
              "T_rl": self._T_rl}
        return kw, m

    def _poses_cw(self, pad_to: int | None = None) -> np.ndarray:
        """The keyframes' camera_from_world poses (float64 inversions, then
        float32), padded with identities to ``pad_to`` slots."""
        poses = np.stack([np.linalg.inv(T) for T in self.kf_poses]).astype(np.float32)
        pad = 0 if pad_to is None else pad_to - len(poses)
        if pad:
            poses = np.concatenate([poses, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        return poses

    def _marginalize_oldest(self) -> None:
        """Schur-marginalize keyframe 0 and the landmarks ``marg_policy``
        consumes into a pose prior over the surviving window (JAX
        ``backend.py:149``); the carried prior is shifted to the current
        poses and decayed by ``prior_decay`` first."""
        Kp1 = len(self.kf_poses)              # window + 1 at slide time
        W = self.cfg.window
        live_now = set(self.kf_obs[-1])
        if self.cfg.marg_policy == "dying":
            m_tids = [t for t in self.kf_obs[0] if t in self.landmarks and t not in live_now]
        else:  # "underconstrained"
            n_other = {t: 0 for t in self.kf_obs[0]}
            for o in self.kf_obs[1:]:
                for t in o:
                    if t in n_other:
                        n_other[t] += 1
            m_tids = [t for t in self.kf_obs[0]
                      if t in self.landmarks and t not in live_now and n_other[t] <= 1]
        if not m_tids:
            if self.log is not None:
                self.log.append(("slide", None, None))
            return
        m_tids = m_tids[: self.cfg.max_landmarks]
        kw, _ = self._table_on_device({t: i for i, t in enumerate(m_tids)}, consume=True)

        poses_cw = self._dev(self._poses_cw())            # (W+1, 4, 4)
        carry_H = carry_b = None
        if self.prior is not None:
            # The prior over slots 0..W-1 of the pre-slide window, at the
            # current poses, embedded into W+1 slots.
            H_s, b_s = marg.shift_prior(self._prior_on_device(), poses_cw[:W])
            g = self.cfg.prior_decay
            carry_H = H_s.new_zeros((Kp1, Kp1, 6, 6))
            carry_H[:W, :W] = g * H_s
            carry_b = b_s.new_zeros((Kp1, 6))
            carry_b[:W] = g * b_s
        prior = marg.build_prior(self.cam, poses_cw, huber_px=self.cfg.huber_px,
                                 carry_H=carry_H, carry_b=carry_b, **kw)
        # Truncate the (W+1)-slot output to the W-slot slid window.
        self.prior = {k: v[:W, :W] if k == "H" else v[:W]
                      for k, v in device_get_tree(prior).items()}
        if self.log is not None:
            self.log.append(("slide", dict(kw, cam=self.cam, poses=poses_cw,
                                           huber_px=self.cfg.huber_px), self.prior))
        for t in m_tids:
            del self.landmarks[t]

    def _prior_on_device(self) -> dict:
        return {k: self._dev(v) for k, v in self.prior.items()}

    def tick(self) -> None:
        self._frames_since_kf += 1

    # ------------------------------------------------------------------ #

    def window_problem(self) -> dict | None:
        """The current window as a BA problem on the device, or None when
        the window is too small (< 2 keyframes, < 8 landmarks seen by
        ``min_track_obs`` keyframes): dict(solve: the keyword arguments of
        ``ba.bundle_adjust``, tid_to_idx, n_kf, n_obs)."""
        K = len(self.kf_poses)
        if K < 2:
            return None
        cfg = self.cfg
        counts: dict[int, int] = {}
        for o in self.kf_obs:
            for tid in o:
                if tid in self.landmarks:
                    counts[tid] = counts.get(tid, 0) + 1
        tids = [t for t, c in counts.items() if c >= cfg.min_track_obs]
        if len(tids) < 8:
            return None
        tid_to_idx = {t: i for i, t in enumerate(tids[: cfg.max_landmarks])}
        kw, m = self._table_on_device(tid_to_idx)
        # The carried prior joins the solve over the window's pose slots.
        solve = dict(cam=self.cam, poses=self._dev(self._poses_cw(pad_to=cfg.window)),
                     n_iters=cfg.ba_iters, n_fixed=1, huber_px=cfg.huber_px,
                     prune_px=4 * cfg.huber_px,
                     prior=None if self.prior is None else self._prior_on_device(), **kw)
        return {"solve": solve, "tid_to_idx": tid_to_idx, "n_kf": K, "n_obs": m}

    def optimize(self) -> dict | None:
        """Local BA over the current window; updates the keyframe poses and
        landmarks. Returns dict(correction (4, 4): the left-multiplied fix
        of the latest keyframe's pose, cost_initial, cost_final,
        n_landmarks, n_obs, n_kf, lm_iters, lm_accepted: the LM steps run and
        accepted, graphed: whether the solve replayed from a CUDA graph,
        wall_s) or None if the window is too small. ``wall_s`` spans
        assembly, the device solve and the copy back."""
        with profiling.span("backend.solve", timed=self.device.type == "cuda"):
            return self._optimize()

    def _optimize(self) -> dict | None:
        t_start = time.perf_counter()
        with profiling.span("backend.problem"):
            problem = self.window_problem()
        if problem is None:
            return None
        K = problem["n_kf"]
        replays = 0 if self.solve_graph is None else self.solve_graph.replays
        with profiling.span("backend.lm"):
            solved = self.solve(**problem["solve"])
        graphed = self.solve_graph is not None and self.solve_graph.replays > replays
        if self.log is not None:
            self.log.append(("solve", problem["solve"], solved))
        with profiling.span("backend.fetch"):
            out = device_get_tree({k: solved[k] for k in FETCHED})
        new_cw = out["poses"].astype(np.float64)[:K]
        old_last_wc = self.kf_poses[-1].copy()
        for k in range(K):
            self.kf_poses[k] = np.linalg.inv(new_cw[k])
        for t, i in problem["tid_to_idx"].items():
            self.landmarks[t] = out["points"][i].astype(np.float64)
        # T_new = correction @ T_old: the same fix applies to the live pose.
        correction = self.kf_poses[-1] @ np.linalg.inv(old_last_wc)
        return {"correction": correction, "cost_initial": float(out["cost_initial"]),
                "cost_final": float(out["cost_final"]),
                "n_landmarks": len(problem["tid_to_idx"]), "n_obs": problem["n_obs"],
                "n_kf": K, "lm_iters": int(solved["lm_iters"]),
                "lm_accepted": int(out["lm_accepted"]), "graphed": graphed,
                "wall_s": time.perf_counter() - t_start}
