"""Pinhole camera + rectified stereo rig model.

Port of ``stereo_visual_odometry_tpu/ops/camera.py``: the JAX pytrees become
frozen dataclasses whose fields are 0-d (``Pinhole``) or (4, 4)
(``StereoRig.T_rl``) tensors on the rig's device.
"""
from __future__ import annotations

import dataclasses

import torch

from . import se3


@dataclasses.dataclass(frozen=True)
class Pinhole:
    """Intrinsics of one camera; each field is a 0-d tensor."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, dtype=torch.float32, device=None) -> "Pinhole":
        a = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return Pinhole(a(fx), a(fy), a(cx), a(cy))

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, z, self.cx]),
                            torch.stack([z, self.fy, self.cy]),
                            torch.stack([z, z, o])])

    def project(self, pts_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D points (..., 3) -> pixels (..., 2)."""
        z = pts_cam[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = self.fx * pts_cam[..., 0] / safe_z + self.cx
        v = self.fy * pts_cam[..., 1] / safe_z + self.cy
        return torch.stack([u, v], dim=-1)

    def unproject(self, px: torch.Tensor, depth=1.0) -> torch.Tensor:
        """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
        depth = torch.as_tensor(depth, dtype=px.dtype, device=px.device)
        x = (px[..., 0] - self.cx) / self.fx * depth
        y = (px[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth * torch.ones_like(x)], dim=-1)


@dataclasses.dataclass(frozen=True)
class StereoRig:
    """Rectified stereo pair; ``T_rl`` maps left-camera to right-camera
    coordinates (KITTI: R = I, t = (-baseline, 0, 0))."""

    left: Pinhole
    right: Pinhole
    T_rl: torch.Tensor  # (4, 4)

    @staticmethod
    def create(left: Pinhole, right: Pinhole, R_rl=None, t_rl=None) -> "StereoRig":
        kw = dict(dtype=left.fx.dtype, device=left.fx.device)
        R = torch.eye(3, **kw) if R_rl is None else torch.as_tensor(R_rl, **kw)
        t = torch.zeros(3, **kw) if t_rl is None else torch.as_tensor(t_rl, **kw)
        return StereoRig(left, right, se3.from_Rt(R, t))

    @staticmethod
    def kitti(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, baseline=0.537,
              dtype=torch.float32, device=None) -> "StereoRig":
        cam = Pinhole.create(fx, fy, cx, cy, dtype=dtype, device=device)
        t = torch.tensor([-baseline, 0.0, 0.0], dtype=dtype, device=device)
        return StereoRig(cam, cam, se3.from_Rt(torch.eye(3, dtype=dtype,
                                                         device=device), t))

    @property
    def baseline(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.T_rl[:3, 3])

    @property
    def P_left(self) -> torch.Tensor:
        """3x4 projection of the left camera: ``[K1 | 0]``."""
        K = self.left.K
        return torch.cat([K, torch.zeros((3, 1), dtype=K.dtype, device=K.device)],
                         dim=1)

    @property
    def P_right(self) -> torch.Tensor:
        """3x4 projection of the right camera: ``[K2 R | K2 t]``."""
        K = self.right.K
        R, t = se3.to_Rt(self.T_rl)
        return torch.cat([K @ R, (K @ t)[:, None]], dim=1)


def world2camera(T_cw: torch.Tensor, pts_w: torch.Tensor) -> torch.Tensor:
    """World points -> camera frame given the camera-from-world pose."""
    return se3.transform_points(T_cw, pts_w)


def camera2world(T_cw: torch.Tensor, pts_c: torch.Tensor) -> torch.Tensor:
    return se3.transform_points(se3.se3_inv(T_cw), pts_c)


def world2pixel(cam: Pinhole, T_cw: torch.Tensor, pts_w: torch.Tensor) -> torch.Tensor:
    """``Sensors::world2pixel``: world points (..., N, 3) -> pixels (..., N, 2)."""
    return cam.project(world2camera(T_cw, pts_w))


def pixel2world(cam: Pinhole, T_cw: torch.Tensor, px: torch.Tensor, depth) -> torch.Tensor:
    """``Sensors::pixel2world``: pixels (..., N, 2) at ``depth`` -> world points."""
    return camera2world(T_cw, cam.unproject(px, depth))
