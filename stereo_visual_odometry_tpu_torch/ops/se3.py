"""SE(3)/SO(3) Lie-group operations on batched tensors.

Port of ``stereo_visual_odometry_tpu/ops/se3.py``. Rotations are (..., 3, 3),
rigid transforms (..., 4, 4) homogeneous matrices, twists ``[v, w]``
(translation first). Every function broadcasts over leading batch dims and
keeps the input dtype (float32 under the package's numerics policy, with
TF32 off, so the small matmuls are exact float32 like ``Precision.HIGHEST``).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector. (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    WW = W @ W
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * WW


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_vee = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    scale = torch.where(theta < 1e-5, 1.0 + theta * theta / 6.0,
                        theta / torch.clamp(sin_t, min=_EPS))
    w_generic = w_vee * scale[..., None]
    # Near theta = pi the generic formula is unstable: axis from the diagonal.
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos_t[..., None]) /
                        torch.clamp(1.0 - cos_t[..., None], min=_EPS), 0.0, 1.0)
    axis_abs = torch.sqrt(axis2)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    syz = R[..., 1, 2] + R[..., 2, 1]
    sign = lambda s: torch.where(s < 0, -1.0, 1.0)
    ax = axis_abs[..., 0]
    ay = axis_abs[..., 1] * sign(sxy)
    az = axis_abs[..., 2] * sign(sxz)
    ay2 = axis_abs[..., 1]
    az2 = axis_abs[..., 2] * sign(syz)
    use_y = ax < 1e-3
    axis = torch.where(use_y[..., None], torch.stack([ax, ay2, az2], dim=-1),
                       torch.stack([ax, ay, az], dim=-1))
    w_pi = axis * theta[..., None]
    near_pi = theta > torch.pi - 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V such that the se3_exp translation part = V @ v."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    WW = W @ W
    return _eye3(W) + B[..., None, None] * W + C[..., None, None] * WW


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(theta2, min=_EPS))
    W = hat(w)
    WW = W @ W
    return _eye3(W) - 0.5 * W + cot[..., None, None] * WW


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) ``[v, w]`` -> homogeneous transform (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return from_Rt(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) ``[v, w]``."""
    R, t = to_Rt(T)
    w = so3_log(R)
    v = (_so3_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)  # a fill on the device, not a copy from the host
    return torch.cat([top, bottom], dim=-2)


def to_Rt(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid-transform inverse (no linear solve)."""
    R, t = to_Rt(T)
    Rt = R.transpose(-1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R, t = to_Rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def orthonormalize_newton(R: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Project a near-rotation onto SO(3) by Newton-Schulz polar iteration.

    ``X <- 1.5 X - 0.5 X X^T X`` after a Frobenius pre-normalization that
    puts the singular values inside (0, sqrt(3)). Keeps the determinant's
    sign (use only after a cheirality sign fix).
    """
    fro = torch.sqrt(torch.sum(R * R, dim=(-1, -2), keepdim=True) / 3.0)
    X = R / torch.clamp(fro, min=1e-12)
    for _ in range(iters):
        X = 1.5 * X - 0.5 * ((X @ X.transpose(-1, -2)) @ X)
    return X


def euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """R -> (roll, pitch, yaw) for the Z-Y-X convention (the motion gate)."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                       torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    pitch = torch.atan2(-R[..., 2, 0], sy)
    yaw = torch.where(singular, torch.zeros_like(sy),
                      torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([roll, pitch, yaw], dim=-1)
