"""Factor-2 image pyramids for LK.

Port of ``downsample2`` / ``build_pyramid`` from
``stereo_visual_odometry_tpu/ops/pyramid.py``. The JAX code halves with two
banded 0.5-entry matmuls (rows, then columns); each output of a matmul there
is ``0.5*a + 0.5*b`` plus exact zeros, so the same two-step pairwise mean
written elementwise gives the same float32 values without a matmul.
"""
from __future__ import annotations

import torch


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//2, W//2) by 2x2 mean pooling (rows, then cols)."""
    h, w = img.shape[-2:]
    h2, w2 = h // 2, w // 2
    x = img[..., 0:2 * h2:2, :] * 0.5 + img[..., 1:2 * h2:2, :] * 0.5
    return x[..., 0:2 * w2:2] * 0.5 + x[..., 1:2 * w2:2] * 0.5


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Factor-2 pyramid [level0=img, level1=half, ...]."""
    out = [img.to(torch.float32)]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return out
