"""Brute-force Hamming descriptor matching with reference filter semantics.

Port of ``stereo_visual_odometry_tpu/ops/match.py``: the (N, M) Hamming
matrix by XOR and a SWAR popcount, per-row argmin, the reference's
``dist <= max(ratio * min_dist, floor)`` gate, the two-matching association
of the ORB pipeline and its geometric premasks — all dense tensor ops.

Descriptors are (N, 8) int64 words holding 32-bit patterns (``ops/orb.py``);
the popcount runs in int64, where the SWAR multiply cannot overflow. The
distance matrix is accumulated one word at a time, so no (N, M, 8)
intermediate exists (268 MB at N = M = 2048). ``torch.argmin`` returns the
first minimal index, as ``jnp.argmin`` does; Hamming distances tie often.
"""
from __future__ import annotations

import torch

_BIG = 1 << 30


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit patterns held in an int64 tensor -> int32."""
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   valid_a: torch.Tensor | None = None,
                   valid_b: torch.Tensor | None = None) -> torch.Tensor:
    """(N, W) x (M, W) packed descriptors -> (N, M) int32 distances.

    Invalid rows/cols get the sentinel ``_BIG`` so they never match.
    """
    d = torch.zeros((desc_a.shape[0], desc_b.shape[0]), dtype=torch.int32,
                    device=desc_a.device)
    for w in range(desc_a.shape[1]):
        d += popcount_u32(desc_a[:, w, None] ^ desc_b[None, :, w])
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, _BIG)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, _BIG)
    return d


def match_best(dist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row best match: (N,) int32 target index (first minimum) and (N,)
    distance."""
    idx = torch.argmin(dist, dim=1)
    best = torch.take_along_dim(dist, idx[:, None], dim=1)[:, 0]
    return idx.to(torch.int32), best


def mutual_mask(dist: torch.Tensor, idx_ab: torch.Tensor) -> torch.Tensor:
    """Cross-check: row i's best column's best row must be i."""
    idx_ba = torch.argmin(dist, dim=0).to(torch.int32)
    back = idx_ba[idx_ab.long()]
    return back == torch.arange(dist.shape[0], dtype=torch.int32, device=dist.device)


def reference_distance_gate(best: torch.Tensor, valid: torch.Tensor,
                            floor: float = 30.0, ratio: float = 2.0) -> torch.Tensor:
    """``dist <= max(ratio * min_dist, floor)`` over the valid matches
    (``tracking.cpp:549-577``)."""
    min_dist = torch.min(torch.where(valid, best, _BIG))
    thr = torch.clamp(ratio * min_dist.to(torch.float32), min=floor)
    return valid & (best.to(torch.float32) <= thr)


def _level_mask(d: torch.Tensor, level_a: torch.Tensor, level_b: torch.Tensor,
                max_level_diff: int) -> torch.Tensor:
    dl = torch.abs(level_a[:, None] - level_b[None, :])
    return torch.where(dl <= max_level_diff, d, _BIG)


def _stereo_premask(d: torch.Tensor, xy_l: torch.Tensor, xy_r: torch.Tensor,
                    feature_match_error: float, max_disparity: float) -> torch.Tensor:
    dy = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    feas = (dy < feature_match_error) & (disp > 0.0) & (disp <= max_disparity)
    return torch.where(feas, d, _BIG)


def _epipolar_gate(v: torch.Tensor, xy_l: torch.Tensor, xy_r_matched: torch.Tensor,
                   feature_match_error: float) -> torch.Tensor:
    """|dy| < feature_match_error and positive disparity on the matched pair."""
    v = v & (torch.abs(xy_l[:, 1] - xy_r_matched[:, 1]) < feature_match_error)
    return v & (xy_l[:, 0] - xy_r_matched[:, 0] > 0.0)


def stereo_match(feat_l: dict, feat_r: dict, feature_match_error: float = 2.0,
                 dist_floor: float = 30.0, dist_ratio: float = 2.0,
                 max_level_diff: int | None = None, stereo_premask: bool = False,
                 max_disparity: float = 128.0) -> dict:
    """Single left<->right association of one stereo pair (the stereo half
    of ``stereo_temporal_match``). Returns dict(idx_r, valid, dist)."""
    d = hamming_matrix(feat_l["desc"], feat_r["desc"], feat_l["valid"], feat_r["valid"])
    if max_level_diff is not None:
        d = _level_mask(d, feat_l["level"], feat_r["level"], max_level_diff)
    if stereo_premask:
        d = _stereo_premask(d, feat_l["xy"], feat_r["xy"], feature_match_error,
                            max_disparity)
    idx_r, best = match_best(d)
    v = feat_l["valid"] & (best < _BIG)
    v = reference_distance_gate(best, v, dist_floor, dist_ratio)
    v = _epipolar_gate(v, feat_l["xy"], feat_r["xy"][idx_r.long()], feature_match_error)
    return {"idx_r": idx_r, "valid": v, "dist": best}


def stereo_temporal_match(feat_t1l: dict, feat_t1r: dict, feat_t2l: dict,
                          feature_match_error: float = 2.0,
                          dist_floor: float = 30.0, dist_ratio: float = 2.0,
                          use_mutual: bool = False,
                          max_level_diff: int | None = None,
                          stereo_premask: bool = False,
                          max_disparity: float = 128.0,
                          temporal_radius: float | None = None) -> dict:
    """The reference's two-matching association for the ORB pipeline
    (``tracking.cpp:534-581``): match1 = t1L <-> t1R (stereo), match2 =
    t1L <-> t2L (temporal); a t1L feature survives iff it passes the
    adaptive distance gate in both and its stereo pair passes the epipolar
    gate. Candidate masks (octave difference, stereo feasibility, temporal
    radius) fold into the distance matrices before the argmin.

    Returns dict(idx_r, idx_t2l (N,) int32; valid (N,) bool; dist_stereo,
    dist_temporal), indexed by t1L slots.
    """
    d_st = hamming_matrix(feat_t1l["desc"], feat_t1r["desc"],
                          feat_t1l["valid"], feat_t1r["valid"])
    d_tm = hamming_matrix(feat_t1l["desc"], feat_t2l["desc"],
                          feat_t1l["valid"], feat_t2l["valid"])
    if max_level_diff is not None:
        d_st = _level_mask(d_st, feat_t1l["level"], feat_t1r["level"], max_level_diff)
        d_tm = _level_mask(d_tm, feat_t1l["level"], feat_t2l["level"], max_level_diff)
    if stereo_premask:
        d_st = _stereo_premask(d_st, feat_t1l["xy"], feat_t1r["xy"],
                               feature_match_error, max_disparity)
    if temporal_radius is not None:
        d2 = torch.sum((feat_t1l["xy"][:, None, :] - feat_t2l["xy"][None, :, :]) ** 2,
                       dim=-1)
        d_tm = torch.where(d2 <= temporal_radius * temporal_radius, d_tm, _BIG)

    idx_r, best_st = match_best(d_st)
    idx_t, best_tm = match_best(d_tm)
    v = feat_t1l["valid"] & (best_st < _BIG) & (best_tm < _BIG)
    if use_mutual:
        v = v & mutual_mask(d_st, idx_r) & mutual_mask(d_tm, idx_t)
    v = (reference_distance_gate(best_st, v, dist_floor, dist_ratio) &
         reference_distance_gate(best_tm, v, dist_floor, dist_ratio))
    v = _epipolar_gate(v, feat_t1l["xy"], feat_t1r["xy"][idx_r.long()],
                       feature_match_error)
    return {"idx_r": idx_r, "idx_t2l": idx_t, "valid": v,
            "dist_stereo": best_st, "dist_temporal": best_tm}
