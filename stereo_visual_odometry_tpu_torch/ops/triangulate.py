"""Batched two-view triangulation.

Port of ``stereo_visual_odometry_tpu/ops/triangulate.py``: the closed-form
rectified-stereo depth (the main path, KITTI rigs) and the linear DLT for
general rigs.
"""
from __future__ import annotations

import torch

from .camera import StereoRig


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor,
                    pts2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear (DLT) triangulation of N correspondences.

    Returns (points (N, 3) in the P1 frame, valid (N,) bool: positive depth
    and a well-conditioned homogeneous scale).
    """
    dtype = pts1.dtype

    def rows(P, pts):
        u = pts[..., 0:1]
        v = pts[..., 1:2]
        return u * P[2] - P[0], v * P[2] - P[1]

    a0, a1 = rows(P1.to(dtype), pts1)
    a2, a3 = rows(P2.to(dtype), pts2)
    A = torch.stack([a0, a1, a2, a3], dim=-2)  # (N, 4, 4)
    A = A / (torch.linalg.vector_norm(A, dim=-1, keepdim=True) + 1e-12)
    AtA = A.transpose(-1, -2) @ A
    _, eigvecs = torch.linalg.eigh(AtA)  # ascending eigenvalues
    X_h = eigvecs[..., :, 0]
    w = X_h[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-10, 1e-10, w)
    X = X_h[..., :3] / safe_w[..., None]
    valid = (torch.abs(w) > 1e-8) & (X[..., 2] > 0)
    return X, valid


def is_rectified(rig: StereoRig) -> bool:
    """True for a purely lateral baseline rig (R_rl = I, t = (tx, 0, 0))."""
    T = rig.T_rl.detach().cpu().double()
    R, t = T[:3, :3], T[:3, 3]
    return bool(torch.allclose(R, torch.eye(3, dtype=R.dtype), atol=1e-6, rtol=1e-5)
                and abs(float(t[1])) < 1e-9 and abs(float(t[2])) < 1e-9)


def stereo_depth_closed_form(rig: StereoRig, pts_l: torch.Tensor,
                             pts_r: torch.Tensor, min_disparity: float = 0.25,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form depth for a rectified rig: ``z = fx * b / (u_l - u_r)``."""
    disp = pts_l[..., 0] - pts_r[..., 0]
    valid = disp > min_disparity
    safe_disp = torch.clamp(disp, min=min_disparity)
    z = rig.left.fx * rig.baseline / safe_disp
    return rig.left.unproject(pts_l, z), valid


def triangulate_stereo(rig: StereoRig, pts_l: torch.Tensor, pts_r: torch.Tensor,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Triangulate stereo correspondences: the closed-form depth for a
    rectified rig, the DLT otherwise (the reference's
    ``cv::triangulatePoints``)."""
    if is_rectified(rig):
        return stereo_depth_closed_form(rig, pts_l, pts_r)
    return triangulate_dlt(rig.P_left, rig.P_right, pts_l, pts_r)


def reprojection_error(cam, T_cw: torch.Tensor, pts_w: torch.Tensor,
                       px: torch.Tensor) -> torch.Tensor:
    """Per-point pixel reprojection error norm (N,)."""
    from . import se3

    pc = se3.transform_points(T_cw, pts_w)
    return torch.linalg.vector_norm(cam.project(pc) - px, dim=-1)
