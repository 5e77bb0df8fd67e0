"""Metric arithmetic: percentiles, the union of device intervals, idle
shares, and the least time of a K1 or K2 call (its roofline bound).

The interval union is a copy of the program's
``utils/profiling.device_activity``, the bounds a copy of the arithmetic
that ``chip_smoke.py`` applies to K1 and K2 (distinct bytes over the HBM
rate against operations over the float32 rate), kept here so that the
yardstick does not move with the program.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value (a sample that
    occurred: the ceil(q/100 * n)-th smallest)."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return float(ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)])


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals: the time anything ran."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy(intervals) -> float:
    """The length of the union of ``intervals``."""
    return sum(b - a for a, b in union(intervals))


def idle_share(busy_s: float, wall_s: float) -> float:
    """1 - busy / wall, as a percentage."""
    return 100.0 * (1.0 - busy_s / wall_s)


def least_seconds(n_bytes: float, flops: float, kind: str) -> float | None:
    """The least time on the card named ``kind``: the larger of the bytes
    over its memory rate and the operations over its float32 rate, from its
    published peaks (``peaks.json``); None for a card the table lacks."""
    p = PEAKS.get(kind)
    if p is None:
        return None
    return max(n_bytes / p["hbm_bytes_per_s"], flops / p["f32_flops_per_s"])


def window_pixels(hp: int, wp: int, rows: torch.Tensor, cols: torch.Tensor, sh: int,
                  sw: int) -> int:
    """Distinct pixels of one (hp, wp) image that (sh, sw) windows at the
    corners (rows, cols) cover, clamped to the image: the least a gather
    of them must read."""
    r = (rows[:, None] + torch.arange(sh, device=rows.device)).clamp(0, hp - 1)
    c = (cols[:, None] + torch.arange(sw, device=cols.device)).clamp(0, wp - 1)
    seen = torch.zeros((hp, wp), dtype=torch.bool, device=rows.device)
    seen[r[:, :, None].expand(-1, sh, sw), c[:, None, :].expand(-1, sh, sw)] = True
    return int(seen.sum())


def k1_work(img_shape, corners: torch.Tensor, sh: int, sw: int) -> tuple[int, int]:
    """(bytes, flops) of one K1 call: (B, Hp, Wp) or (Hp, Wp) float32 images,
    (B, N, 2) or (N, 2) int32 [row, col] corners, (N, Sh, Sw) windows per
    image. Every output byte is written once, every corner read once, and
    each distinct pixel the clamped windows cover read once; no arithmetic."""
    hp, wp = img_shape[-2:]
    corners = corners.reshape(-1, corners.shape[-2], 2).long()
    pix = 0
    for c in corners:
        pix += window_pixels(hp, wp, c[:, 0].clamp(0, hp - sh), c[:, 1].clamp(0, wp - sw),
                             sh, sw)
    b, n = corners.shape[:2]
    return 4 * (pix + b * n * sh * sw) + 8 * b * n, 0


def k2_work(img_shape, centers: torch.Tensor, P: int) -> tuple[int, int]:
    """(bytes, flops) of one K2 call: (B, H, W) or (H, W) float32 images
    (unpadded), (B, N, 2) or (N, 2) float32 [x, y] centres, (N, P, P)
    bilinear patches per image. Every output byte written once, every centre
    read once, each distinct pixel the edge-clamped (P+1)^2 windows cover
    read once; 11 operations per output pixel (four taps, the blend)."""
    h, w = img_shape[-2:]
    centers = centers.reshape(-1, centers.shape[-2], 2)
    pad, r = P // 2 + 2, (P - 1) / 2.0
    pix = 0
    for xy in centers:
        iy = torch.floor((xy[:, 1] + pad) - r).long().clamp(0, h + 2 * pad - P - 1) - pad
        ix = torch.floor((xy[:, 0] + pad) - r).long().clamp(0, w + 2 * pad - P - 1) - pad
        pix += window_pixels(h, w, iy, ix, P + 1, P + 1)
    b, n = centers.shape[:2]
    return 4 * (pix + b * n * P * P) + 8 * b * n, 11 * b * n * P * P
