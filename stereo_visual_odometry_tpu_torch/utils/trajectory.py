"""Trajectory output + ATE/RPE evaluation.

A numpy copy of ``stereo_visual_odometry_tpu/utils/trajectory.py`` (the JAX
package pulls in ``jax`` on any import).

The reference never persists a trajectory — its only output is an on-screen
canvas (the reference's ``src/tracking.cpp:345-353``), so its accuracy was
never measurable. This module adds the KITTI-format pose writer and the
ATE/RPE evaluator that BASELINE.md's targets require.
"""
from __future__ import annotations

import numpy as np


def save_kitti(path: str, poses: np.ndarray) -> None:
    """Write (N, 4, 4) world_from_camera poses as KITTI 12-number rows."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(T)[:3].reshape(-1)) + "\n")


def load_kitti(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = rows
    return out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/SE(3) alignment src -> dst for (N, 3) points."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    scale = (np.trace(np.diag(D) @ S) / (xs ** 2).sum() * len(src)) if with_scale else 1.0
    t = mu_d - scale * R @ mu_s
    return R, t, scale


def ate_rmse(poses_est: np.ndarray, poses_gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation) after SE(3) alignment."""
    p_est = poses_est[:, :3, 3]
    p_gt = poses_gt[:, :3, 3]
    if align:
        R, t, s = umeyama_alignment(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe(poses_est: np.ndarray, poses_gt: np.ndarray, delta: int = 1):
    """Relative pose error over frame gap ``delta``.

    Returns (rmse translational drift per step [m], rmse rotational drift
    per step [rad]).
    """
    t_errs, r_errs = [], []
    for i in range(len(poses_est) - delta):
        dT_est = np.linalg.inv(poses_est[i]) @ poses_est[i + delta]
        dT_gt = np.linalg.inv(poses_gt[i]) @ poses_gt[i + delta]
        E = np.linalg.inv(dT_gt) @ dT_est
        t_errs.append(np.linalg.norm(E[:3, 3]))
        cos_t = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cos_t))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(np.sqrt(np.mean(np.square(r_errs))))
