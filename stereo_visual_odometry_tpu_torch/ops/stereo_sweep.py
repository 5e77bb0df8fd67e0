"""Dense plane-sweep stereo: integer disparity priors for the LK stereo legs.

Port of ``stereo_visual_odometry_tpu/ops/stereo_sweep.py``. The shifted stack
is built by indexing (the JAX one-hot einsum is exact, so the values are the
same); the box sums keep the JAX form — two banded 0/1 matrices applied with
``torch.matmul`` — so the cost volume is summed the same way up to the
matmul's own accumulation order. Near-ties of the argmin can still flip.
"""
from __future__ import annotations

import torch


def _box_band(n: int, win: int, device) -> torch.Tensor:
    """(n, n) 0/1 band matrix: (B @ a) = windowed sums of a (win wide)."""
    idx = torch.arange(n, device=device)
    return (torch.abs(idx[:, None] - idx[None, :]) <= win // 2).to(torch.float32)


def disparity_sweep(left: torch.Tensor, right: torch.Tensor, d_max: int = 48,
                    win: int = 9) -> torch.Tensor:
    """(H, W) left/right level images -> (H, W) integer disparity (float32).

    Brute-force box-SAD over ``d_max`` disparities; columns x < d never see
    a correspondence and are masked to +inf before the argmin (first index
    wins on ties, as ``jnp.argmin``).
    """
    h, w = left.shape
    dev = left.device
    L = left.to(torch.float32)
    R = right.to(torch.float32)
    d = torch.arange(d_max, device=dev)[:, None]            # (D, 1)
    col = torch.arange(w, device=dev)[None, :]              # (1, W)
    src = col - d                                           # (D, W)
    inside = src >= 0
    X = R[:, src.clamp(min=0)].permute(1, 0, 2)             # (D, H, W)
    X = torch.where(inside[:, None, :], X, 0.0)
    C = torch.abs(L[None] - X)
    C = torch.matmul(_box_band(h, win, dev), C)             # vertical box sum
    C = torch.matmul(C, _box_band(w, win, dev))             # horizontal box sum
    C = torch.where(inside[:, None, :], C, torch.inf)
    return torch.argmin(C, dim=0).to(torch.float32)


def sample_map(dmap: torch.Tensor, xy: torch.Tensor, scale: float) -> torch.Tensor:
    """Sample a level-L map at level-0 positions; returns level-0 disparity."""
    h, w = dmap.shape
    ix = torch.clamp((xy[:, 0] / scale).to(torch.int64), 0, w - 1)
    iy = torch.clamp((xy[:, 1] / scale).to(torch.int64), 0, h - 1)
    return dmap[iy, ix] * scale
