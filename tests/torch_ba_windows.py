"""Seeded random BA windows for the port's solve and its plain reference
(``vobench/reference_ba.py``), in numpy; no JAX.

A window is K keyframes driving forward with a slow turn, L landmarks in
front of them, each seen by every keyframe whose image it falls in (with
0.3 px of pixel noise), every second observation also by the rig's right
camera, some pixels made outliers, the first pose fixed and the others and
the landmarks started off their truth; the tables padded with dead rows, as
the backend pads them. With ``prior`` it carries a marginalization prior
over the first K - 1 slots: a random positive definite information
around poses near the truth.
"""
from __future__ import annotations

import numpy as np
import torch

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
HW = (480, 640)
T_RL = np.eye(4, dtype=np.float32)
T_RL[0, 3] = -0.5                                   # right_from_left: 0.5 m baseline


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _exp(xi: np.ndarray) -> np.ndarray:
    """A small twist [v, w] as a transform (first order in v, exact in w)."""
    w = xi[3:]
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) if th < 1e-12 else (np.eye(3) + np.sin(th) / th * K
                                      + (1 - np.cos(th)) / th ** 2 * K @ K)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, xi[:3]
    return T


def window(seed: int, K: int = 5, L: int = 60, stereo: bool = True, outliers: int = 0,
           prior: bool = False, pad_obs: int = 16, pad_lm: int = 4) -> dict:
    """The problem as ``bundle_adjust``'s keyword arguments (numpy, float32;
    ``obs_right`` and ``T_rl`` only with ``stereo``; ``prior`` a dict or
    None), and the truth: ``poses_gt`` (K, 4, 4) camera_from_world."""
    rng = np.random.default_rng(seed)
    poses_gt = []
    for k in range(K):
        T_wc = np.eye(4)
        T_wc[:3, :3] = _rot_y(0.02 * k)
        T_wc[:3, 3] = [0.1 * k, 0.0, 1.0 * k]
        poses_gt.append(np.linalg.inv(T_wc))
    poses_gt = np.stack(poses_gt)
    pts = np.stack([rng.uniform(-8, 8, L), rng.uniform(-3, 3, L),
                    rng.uniform(8, 30, L) + K], -1)
    obs_kf, obs_lm, obs_uv, obs_right = [], [], [], []
    for k in range(K):
        for sel, T in ((False, poses_gt[k]), (True, T_RL @ poses_gt[k])):
            if sel and not stereo:
                continue
            pc = pts @ T[:3, :3].T + T[:3, 3]
            uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
            seen = (pc[:, 2] > 1) & (uv[:, 0] > 0) & (uv[:, 0] < HW[1]) & (uv[:, 1] > 0) \
                & (uv[:, 1] < HW[0])
            if sel:
                seen &= np.arange(L) % 2 == 0
            for i in np.flatnonzero(seen):
                obs_kf.append(k)
                obs_lm.append(i)
                obs_uv.append(uv[i] + rng.normal(0, 0.3, 2))
                obs_right.append(sel)
    M = len(obs_kf)
    obs_uv = np.array(obs_uv)
    if outliers:
        idx = rng.choice(M, M // outliers, replace=False)
        obs_uv[idx] += rng.uniform(20, 60, (len(idx), 2)) * rng.choice([-1, 1], (len(idx), 2))
    p0 = poses_gt.copy()
    for k in range(1, K):
        p0[k] = _exp(np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.004, 3)]) @ p0[k]
    x0 = pts + rng.normal(0, 0.05, pts.shape)
    pad = lambda a, n, dt: np.concatenate([np.asarray(a, dt), np.zeros((n,) + np.shape(a)[1:],
                                                                       dt)])
    # Dead landmark rows come last; dead observations point at them.
    kw = {"poses": p0.astype(np.float32), "points": pad(x0, pad_lm, np.float32),
          "obs_kf": pad(obs_kf, pad_obs, np.int32),
          "obs_lm": np.r_[np.asarray(obs_lm, np.int32), np.full(pad_obs, L, np.int32)],
          "obs_uv": pad(obs_uv, pad_obs, np.float32),
          "obs_w": pad(np.ones(M), pad_obs, np.float32), "obs_right": None, "T_rl": None,
          "prior": None}
    if stereo:
        kw["obs_right"], kw["T_rl"] = pad(obs_right, pad_obs, bool), T_RL.copy()
    if prior:
        n = 6 * (K - 1)
        scale = np.array([30.0, 30.0, 30.0, 300.0, 300.0, 300.0])[np.arange(n) % 6]
        A = rng.normal(size=(n, n)) * scale[:, None]
        H = np.zeros((6 * K, 6 * K))
        H[:n, :n] = A @ A.T / n + np.diag(np.tile([1e2] * 3 + [1e4] * 3, K - 1))
        lin = np.stack([_exp(np.r_[rng.normal(0, 0.02, 3), rng.normal(0, 0.002, 3)]) @ T
                        for T in poses_gt])
        b = np.zeros((K, 6))
        b[:K - 1] = rng.normal(0, 1.0, (K - 1, 6))
        kw["prior"] = {"H": H.reshape(K, 6, K, 6).transpose(0, 2, 1, 3).astype(np.float32),
                       "b": b.astype(np.float32), "T_lin": lin.astype(np.float32),
                       "mask": np.arange(K) < K - 1}
    return {"kw": kw, "poses_gt": poses_gt}


def on(kw: dict, device="cpu") -> dict:
    """``window``'s keyword arguments as tensors on ``device``, with the
    camera (``cam``)."""
    from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole

    def t(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: t(v) for k, v in a.items()}
        return torch.as_tensor(np.asarray(a), device=device)
    out = {k: t(v) for k, v in kw.items()}
    out["cam"] = Pinhole.create(FX, FY, CX, CY, device=device)
    return out
