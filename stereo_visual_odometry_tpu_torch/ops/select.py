"""Fixed-shape keypoint selection from dense score maps.

Port of ``grid_top_k``, ``subpixel_refine`` and ``dedup_by_bin`` from
``stereo_visual_odometry_tpu/ops/select.py``. Ties break the JAX way: the
per-cell rounds keep the first maximal index (``torch.argmax`` does), and
the global top-K is a stable descending sort, so equal scores keep their
flat order as ``lax.top_k`` does (``torch.topk`` promises no order).
"""
from __future__ import annotations

import torch

from . import patch


def grid_top_k(score: torch.Tensor, k_total: int, cell: int = 32,
               k_per_cell: int = 8):
    """Spatially-uniform top-K: per-cell top-k, then a global top-K.

    Returns (xy (K, 2) float32 [x, y], scores (K,), valid (K,) bool);
    invalid slots carry xy = (0, 0). H and W must be multiples of ``cell``.
    """
    h, w = score.shape
    if h % cell or w % cell:
        raise ValueError(f"score map {(h, w)} is not a multiple of cell={cell}")
    gh, gw = h // cell, w // cell
    cells = (score.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3)
             .reshape(gh, gw, cell * cell))
    lane = torch.arange(cell * cell, device=score.device)
    vals_l, idx_l = [], []
    work = cells
    for _ in range(k_per_cell):
        am = torch.argmax(work, dim=-1)                    # first max wins
        vals_l.append(torch.amax(work, dim=-1))
        idx_l.append(am)
        work = torch.where(lane == am[..., None], -torch.inf, work)
    vals = torch.stack(vals_l, dim=-1)                     # (gh, gw, k)
    idx = torch.stack(idx_l, dim=-1)
    row0 = torch.arange(gh, device=score.device)[:, None, None] * cell
    col0 = torch.arange(gw, device=score.device)[None, :, None] * cell
    ys = (row0 + idx // cell).reshape(-1)
    xs = (col0 + idx % cell).reshape(-1)
    flat_vals = vals.reshape(-1)
    k_total = min(k_total, flat_vals.shape[0])
    order = torch.sort(flat_vals, descending=True, stable=True).indices[:k_total]
    best = flat_vals[order]
    valid = best > 0
    xy = torch.stack([xs[order].to(torch.float32), ys[order].to(torch.float32)],
                     dim=-1)
    xy = xy * valid[:, None]
    return xy, torch.where(valid, best, 0.0), valid


def subpixel_refine(score: torch.Tensor, xy: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Parabolic subpixel refinement of integer corner locations.

    One K1 call reads each point's 3x3 score neighbourhood; a 1-D parabola
    through the centre and its two neighbours along each axis gives the
    offset, clamped to [-0.5, 0.5].
    """
    h, w = score.shape
    xi = torch.clamp(xy[:, 0].to(torch.int32), 1, w - 2)
    yi = torch.clamp(xy[:, 1].to(torch.int32), 1, h - 2)

    def axis_offset(sm, sc, sp):
        denom = sm - 2.0 * sc + sp
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (sm - sp) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    corners = torch.stack([yi - 1, xi - 1], dim=-1)
    W = patch.extract_windows_int(score.contiguous(), corners, 3)
    sc = W[:, 1, 1]
    dx = axis_offset(W[:, 1, 0], sc, W[:, 1, 2])
    dy = axis_offset(W[:, 0, 1], sc, W[:, 2, 1])
    refined = xy + torch.stack([dx, dy], dim=-1)
    return torch.where(valid[:, None], refined, xy)


def dedup_by_bin(xy: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
                 height: int, width: int, radius: float = 3.0) -> torch.Tensor:
    """Suppress near-duplicate keypoints: keep the best-scoring one per
    ``radius``-px spatial bin, in two half-shifted grids.

    Ranks are unique (a stable ascending sort of the scores, so equal
    scores rank by slot index, as ``jnp.argsort``); a scatter-max per bin
    finds each bin's champion, and a slot survives iff it is its own bin's
    champion in both grids.
    """
    k = xy.shape[0]
    order = torch.sort(torch.where(valid, score, -torch.inf), stable=True).indices
    rank = torch.empty(k, dtype=torch.int64, device=xy.device)
    rank[order] = torch.arange(k, device=xy.device)
    rank = torch.where(valid, rank, -1)

    keep = valid
    nbx = int(width / radius) + 3
    nby = int(height / radius) + 3
    for shift in (0.0, 0.5):
        bx = torch.clamp(xy[:, 0] / radius + shift, 0, nbx - 1).to(torch.int64)
        by = torch.clamp(xy[:, 1] / radius + shift, 0, nby - 1).to(torch.int64)
        bid = torch.where(valid, by * nbx + bx, nbx * nby)
        champ = torch.full((nbx * nby + 1,), -1, dtype=torch.int64, device=xy.device)
        champ = champ.scatter_reduce(0, bid, rank, reduce="amax")
        keep = keep & (rank == champ[bid])
    return keep
