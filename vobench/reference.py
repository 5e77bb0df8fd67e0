"""The plain reference and the comparison that decides ``correct``.

A frame's answer is the camera's motion since the previous frame (``T_21``,
or nothing where a gate rejects it), and the user reads it as the pose chain
composed from those answers. On the rendered circuit the true motion is
known exactly: the reference works it out again here, in float64 NumPy, from
the circuit's own poses (``render.circuit_poses``), independent of the
program; it reads the program's poses only to judge them.

The numbers compared over every frame the timed window completed (``judge``):

* ``ate_max_m``: the largest ATE RMSE (SE(3)-aligned, metres) of a segment:
  a sequence of an offline batch, or a fixed count of consecutive frames of
  a drive;
* ``step_rot_max_rad``: the largest angle between a frame's estimated and
  true rotation since the previous frame (a frame a gate rejected keeps the
  pose, so its estimated motion is none), taken from the skew part of the
  rotation between them (``angle``), so that rounding shows as no angle;
* ``step_trans_max_m``: the largest distance between a frame's estimated and
  true translation since the previous frame.

Beside them the kernels that feed the step are held to plain versions
written here from their contracts (``windows`` for K1, ``patches`` for K2),
on the inputs and outputs of every call of the last replay of the window
(``kernel_errors``).

``ate_rmse`` and ``umeyama_alignment`` are copies of the program's
``utils/trajectory.py``, frozen with the yardstick. ``control_chain`` is the
reference's answers rounded to bfloat16, the precision below the program's
float32, put in the program's place; ``windows`` and ``patches`` with
``dtype=torch.bfloat16`` are the kernels' control.
"""
from __future__ import annotations

import numpy as np
import torch


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Least-squares rotation and translation src -> dst for (N, 3) points."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(poses_est: np.ndarray, poses_gt: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of translation, metres) after SE(3)
    alignment of the estimated positions onto the true ones."""
    p_est, p_gt = poses_est[:, :3, 3], poses_gt[:, :3, 3]
    R, t = umeyama_alignment(p_est, p_gt)
    err = np.linalg.norm(p_est @ R.T + t - p_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def relative(poses: np.ndarray) -> np.ndarray:
    """(N-1, 4, 4) motions between consecutive poses: inv(P[t-1]) @ P[t]."""
    return np.linalg.inv(poses[:-1]) @ poses[1:]


def truth(lap_poses: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """The true world_from_camera poses of drive frames ``frames`` (indices
    that run on past the lap's end, lap after lap), relative to the first."""
    poses = lap_poses[np.asarray(frames) % len(lap_poses)]
    return np.linalg.inv(poses[0]) @ poses


def segments(frames: np.ndarray, poses: np.ndarray, length: int):
    """Consecutive whole segments of ``length`` frames of a drive: (frame
    indices, poses) pairs; a last partial segment is dropped."""
    return [(frames[i:i + length], poses[i:i + length])
            for i in range(0, len(frames) - length + 1, length)]


def angle(R: np.ndarray) -> np.ndarray:
    """The rotation angles of (..., 3, 3) matrices: atan2 of the skew part's
    norm over the symmetric part's, so that a matrix rounded off the
    rotations reads the angle it turns, not the rounding."""
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    trace = np.trace(R, axis1=-2, axis2=-1)
    return np.arctan2(0.5 * np.linalg.norm(skew, axis=-1), 0.5 * (trace - 1.0))


def judge(pieces, lap_poses: np.ndarray) -> dict:
    """The compared numbers over ``pieces``, a list of (frame indices, (n, 4,
    4) estimated poses) segments, and ``ate_m``, the mean segment ATE."""
    ates, rot, trans = [], [0.0], [0.0]
    for frames, est in pieces:
        gt = truth(lap_poses, frames)
        ates.append(ate_rmse(est, gt))
        d = np.linalg.inv(relative(gt)) @ relative(est)
        rot.append(float(np.max(angle(d[:, :3, :3]), initial=0.0)))
        gap = relative(est)[:, :3, 3] - relative(gt)[:, :3, 3]
        trans.append(float(np.max(np.linalg.norm(gap, axis=1), initial=0.0)))
    return {"ate_m": float(np.mean(ates)) if ates else None,
            "segments": len(ates),
            "ate_max_m": max(ates) if ates else None,
            "step_rot_max_rad": max(rot), "step_trans_max_m": max(trans)}


def control_chain(lap_poses: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """The control of the pose numbers: each frame's answer (its motion since
    the previous frame, in the segment's own frame as ``judge`` takes it)
    worked out as the reference does and rounded to bfloat16, then composed
    on the host in float64 as the program's entries compose theirs."""
    T_12 = relative(truth(lap_poses, frames))
    T_12 = torch.as_tensor(T_12).to(torch.bfloat16).to(torch.float64).numpy()
    chain = [np.eye(4)]
    for step in T_12:
        chain.append(chain[-1] @ step)
    return np.stack(chain)


def windows(imgs: torch.Tensor, corners: torch.Tensor, sh: int, sw: int,
            dtype=torch.float64) -> torch.Tensor:
    """K1's contract, plainly: (Hp, Wp) or (B, Hp, Wp) images and (N, 2) or
    (B, N, 2) integer [row, col] corners -> the (Sh, Sw) window at each
    corner, the corner clamped to [0, Hp-Sh] x [0, Wp-Sw]; (N, Sh, Sw) or
    (B, N, Sh, Sw), read from the images cast to ``dtype``."""
    flat = imgs.dim() == 2
    img = (imgs[None] if flat else imgs).to(dtype)
    rc = (corners[None] if flat else corners).long()
    b, hp, wp = img.shape
    r = rc[..., 0].clamp(0, hp - sh)[..., None, None] + torch.arange(sh, device=img.device)[:, None]
    c = rc[..., 1].clamp(0, wp - sw)[..., None, None] + torch.arange(sw, device=img.device)
    out = img.reshape(b, -1).gather(1, (r * wp + c).reshape(b, -1)).reshape(r.shape[:2] + (sh, sw))
    return out[0] if flat else out


def patches(imgs: torch.Tensor, centers: torch.Tensor, P: int,
            dtype=torch.float64) -> torch.Tensor:
    """K2's contract, plainly: (H, W) or (B, H, W) images and (N, 2) or
    (B, N, 2) float32 [x, y] centres -> (P, P) bilinear patches centred on
    them over the image edge-replicated by ``pad = P // 2 + 2``: the corner
    ``centre + pad - (P - 1) / 2`` (float32, as the contract states it),
    its integer part clipped to the padded image less P + 1, the fraction
    left over, and the four taps blended in ``dtype``."""
    flat = imgs.dim() == 2
    img = imgs[None] if flat else imgs
    xy = centers[None] if flat else centers
    b, h, w = img.shape
    pad, half = P // 2 + 2, (P - 1) / 2.0
    t = (xy.to(torch.float32) + pad) - half                       # (B, N, 2) [x, y]
    top = torch.floor(t[..., 1]).long().clamp(0, h + 2 * pad - P - 1)
    left = torch.floor(t[..., 0]).long().clamp(0, w + 2 * pad - P - 1)
    fy = (t[..., 1] - top.to(torch.float32)).to(dtype)[..., None, None]
    fx = (t[..., 0] - left.to(torch.float32)).to(dtype)[..., None, None]
    off = torch.arange(P + 1, device=img.device) - pad
    rows = (top[..., None] + off).clamp(0, h - 1)[..., :, None]
    cols = (left[..., None] + off).clamp(0, w - 1)[..., None, :]
    win = img.to(dtype).reshape(b, -1).gather(1, (rows * w + cols).reshape(b, -1))
    win = win.reshape(rows.shape[:2] + (P + 1, P + 1))
    out = ((1 - fy) * (1 - fx) * win[..., :-1, :-1] + (1 - fy) * fx * win[..., :-1, 1:]
           + fy * (1 - fx) * win[..., 1:, :-1] + fy * fx * win[..., 1:, 1:])
    return out[0] if flat else out


def _storages(tree) -> set[int]:
    """The storage addresses of every tensor in a nest of dicts, lists and
    tuples."""
    if isinstance(tree, torch.Tensor):
        return {tree.untyped_storage().data_ptr()}
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(
        tree, (list, tuple)) else ()
    return set().union(*(_storages(x) for x in items))


def kernel_errors(calls, states=()) -> dict:
    """Every recorded K1 and K2 call (``trace.KernelCalls``: its inputs and
    output as the last replay left them) against ``windows`` and ``patches``
    in float64: the largest absolute gap of each kernel (``k1_err``,
    ``k2_err``; None where no call was checked) and the calls checked. A
    call that read a buffer of ``states`` (the step's carried state, which
    the step overwrites after reading it) is not checked: its input no
    longer holds what the kernel read."""
    carried = _storages(list(states))
    out = {}
    for key, ref in (("k1", windows), ("k2", patches)):
        worst, checked, skipped = None, 0, 0
        for imgs, where, *size, got in getattr(calls, key, ()):
            if {imgs.untyped_storage().data_ptr(), where.untyped_storage().data_ptr()} & carried:
                skipped += 1
                continue
            gap = float((got.double() - ref(imgs, where, *size)).abs().max()) if got.numel() else 0.0
            worst = gap if worst is None else max(worst, gap)
            checked += 1
        out.update({f"{key}_err": worst, f"{key}_checked": checked, f"{key}_skipped": skipped})
    return out
