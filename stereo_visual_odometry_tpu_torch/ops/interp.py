"""Bilinear image sampling: ORB's generic sampler.

Port of ``stereo_visual_odometry_tpu/ops/interp.py``: an explicit batched
gather with border-replicating clamps. ``sample_patches`` is the JAX CPU
route of ``extract_patches``; the port's K2 path (``ops/patch.py``) keeps
it as a second reference for the patch kernel.
"""
from __future__ import annotations

import torch


def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (H, W) at continuous pixel coords ``xy`` (..., 2) [x, y].

    Out-of-bounds coordinates clamp to the border (BORDER_REPLICATE).
    """
    h, w = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def patch_grid(patch_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Centered (P, P, 2) offset grid: offsets[-r..r] for odd patch_size."""
    r = (patch_size - 1) / 2.0
    ys = torch.arange(patch_size, dtype=dtype, device=device) - r
    xs = torch.arange(patch_size, dtype=dtype, device=device) - r
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def sample_patch(img: torch.Tensor, center_xy: torch.Tensor,
                 patch_size: int) -> torch.Tensor:
    """Bilinear (patch_size, patch_size) patch around ``center_xy`` (2,)."""
    grid = patch_grid(patch_size, dtype=center_xy.dtype, device=center_xy.device)
    return bilinear(img, grid + center_xy)


def sample_patches(img: torch.Tensor, centers_xy: torch.Tensor,
                   patch_size: int) -> torch.Tensor:
    """Batched: (N, 2) centers -> (N, P, P) patches via one gather."""
    grid = patch_grid(patch_size, dtype=centers_xy.dtype, device=centers_xy.device)
    coords = centers_xy[:, None, None, :] + grid[None]
    return bilinear(img, coords)
