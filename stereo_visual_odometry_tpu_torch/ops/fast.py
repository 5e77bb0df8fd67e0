"""Dense FAST-9/16 corner detection.

Port of ``stereo_visual_odometry_tpu/ops/fast.py``: the segment test is
evaluated for every pixel at once from a (16, H, W) ring stack, the arc
minima by doubling rotate-and-min, the score is OpenCV's (the largest
threshold at which the pixel stays a corner), and NMS is a 3x3 max filter.
All elementwise, so the scores equal the JAX ones exactly.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 in OpenCV's ring order, (dy, dx), starting
# straight up and going clockwise.
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9
BORDER = 3


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W): image sampled at each ring offset (wrapping;
    callers mask the border where the ring wraps)."""
    return torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1))
                        for (dy, dx) in RING_OFFSETS])


@functools.lru_cache(maxsize=None)
def _run_plan(n: int) -> tuple[int, ...]:
    """Decompose n into powers of two (binary)."""
    return tuple(1 << b for b in range(n.bit_length()) if n & (1 << b))


def _min_over_arcs(vals16: torch.Tensor, n: int) -> torch.Tensor:
    """m[i] = min of vals[i..i+n-1] circularly along dim 0."""
    pow_runs = {1: vals16}
    p = 1
    while p * 2 <= n:
        pow_runs[p * 2] = torch.minimum(pow_runs[p],
                                        torch.roll(pow_runs[p], -p, dims=0))
        p *= 2
    acc = None
    offset = 0
    for part in _run_plan(n):
        r = torch.roll(pow_runs[part], -offset, dims=0)
        acc = r if acc is None else torch.minimum(acc, r)
        offset += part
    return acc


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 corner score map, (H, W) float32; 0 where not a corner."""
    img = img.to(torch.float32)
    diff = _ring_stack(img) - img[None]
    bright = torch.amax(_min_over_arcs(diff, ARC_LEN), dim=0)
    dark = torch.amax(_min_over_arcs(-diff, ARC_LEN), dim=0)
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold, score, 0.0)
    h, w = img.shape
    row = torch.arange(h, device=img.device)[:, None]
    col = torch.arange(w, device=img.device)[None, :]
    inside = ((row >= BORDER) & (row < h - BORDER) &
              (col >= BORDER) & (col < w - BORDER))
    return torch.where(inside, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression: keep pixels equal to their window max."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= neigh) & (score > 0), score, 0.0)


def detect(img: torch.Tensor, threshold: float = 20.0, nms: bool = True) -> torch.Tensor:
    """Dense FAST detection -> score map (0 = not a keypoint)."""
    s = fast_score(img, threshold)
    return nms3x3(s) if nms else s
