"""Image pyramids: factor-2 levels for LK, scale-1.2 levels for ORB.

Port of ``stereo_visual_odometry_tpu/ops/pyramid.py``. The JAX code halves
with two banded 0.5-entry matmuls (rows, then columns); each output of a
matmul there is ``0.5*a + 0.5*b`` plus exact zeros, so the same two-step
pairwise mean written elementwise gives the same float32 values without a
matmul.

The ORB resize and the Gaussian blur keep the JAX banded-matrix form as
``torch.matmul`` in float32 (TF32 is off package-wide): plain matrix
products, which keep the level images within rounding of the JAX ones, so
FAST thresholds fall on the same side. ``scale_pyramid`` resizes every
level from level 0; it does not cascade.
"""
from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear resampling matrix (align-corners=False)."""
    s = n_in / n_out
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * s - 0.5
    i0 = np.clip(np.floor(pos).astype(int), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    f = np.clip(pos - np.floor(pos), 0.0, 1.0)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] += 1.0 - f
    m[np.arange(n_out), i1] += f
    return m


@functools.lru_cache(maxsize=128)
def _on_device(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)`` as a tensor on ``device``, copied there once."""
    return torch.from_numpy(make(*args)).to(device)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Arbitrary-size bilinear resize (align-corners=False, like cv::resize),
    as two banded matmuls; batch dims broadcast."""
    h, w = img.shape[-2:]
    img = img.to(torch.float32)
    mr = _on_device(_resize_matrix, (out_h, h), img.device)
    mc = _on_device(_resize_matrix, (out_w, w), img.device)
    return torch.matmul(torch.matmul(mr, img), mc.T)


def scale_pyramid(img: torch.Tensor, levels: int,
                  scale_factor: float) -> list[torch.Tensor]:
    """ORB-style pyramid with per-level scale ``1/scale_factor**level``, each
    level resized from level 0. Accepts (..., H, W)."""
    h, w = img.shape[-2:]
    out = [img.to(torch.float32)]
    for lvl in range(1, levels):
        s = 1.0 / (scale_factor ** lvl)
        out.append(resize_bilinear(img, max(int(round(h * s)), 8),
                                   max(int(round(w * s)), 8)))
    return out


@functools.lru_cache(maxsize=64)
def _blur_matrix(n: int, ksize: int, sigma: float) -> np.ndarray:
    """Banded (n, n) separable-Gaussian matrix (edge-clamped taps)."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, kv in zip(range(i - r, i + r + 1), k):
            m[i, min(max(t, 0), n - 1)] += kv
    return m


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur (the 7x7 sigma-2 blur before BRIEF sampling),
    as B_row @ img @ B_col^T; batch dims broadcast."""
    h, w = img.shape[-2:]
    img = img.to(torch.float32)
    br = _on_device(_blur_matrix, (h, ksize, sigma), img.device)
    bc = _on_device(_blur_matrix, (w, ksize, sigma), img.device)
    return torch.matmul(torch.matmul(br, img), bc.T)
