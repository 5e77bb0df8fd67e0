"""Batched pyramidal Lucas-Kanade and the 4-way circular matcher.

Port of ``track`` and ``circular_track`` from
``stereo_visual_odometry_tpu/ops/lk.py``, dense backend only
(``lk_kernel='dense'``): every level runs ``lk_dense.level_track_dense``
on K1. Each level is edge-padded exactly as the JAX path pads it for its
kernels — by ``(win-1)//2 + 2`` and then up to a multiple of 8 rows and 128
columns — because ``level_track_dense`` clips window corners against the
padded extents, and a smaller pad would track border points differently.
"""
from __future__ import annotations

import torch

from . import lk_dense, se3, stereo_sweep
from .patch import pad_edge

# Max flow change per level beyond the incoming guess (px).
SEARCH_RADIUS_COARSEST = 20
SEARCH_RADIUS_REFINE = 6


def track(pyr_prev, pyr_next, pts: torch.Tensor, win: int = 21, levels: int = 3,
          iters: int = 30, eps: float = 0.01, eps_coarse: float = 0.03,
          min_eig: float = 1e-4, init_flow: torch.Tensor | None = None,
          active: torch.Tensor | None = None, rounds_coarse: int = 8,
          rounds_refine: int = 2):
    """Track N points from prev to next through a factor-2 pyramid.

    Args:
      pyr_prev / pyr_next: sequences of (H/2^l, W/2^l) float32 levels.
      pts: (N, 2) [x, y] level-0 positions.
      init_flow: optional (N, 2) level-0 flow guess; each level's search
        radius applies around it.
    Returns:
      (next_pts (N, 2), ok (N,) bool): ok needs every level's gates and the
      final point inside the level-0 frame.
    """
    n_levels = min(levels, len(pyr_prev))
    if init_flow is None:
        flow = torch.zeros_like(pts)
    else:
        flow = init_flow.to(pts.dtype) * (0.5 ** (n_levels - 1))
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    pad = (win - 1) // 2 + 2
    for lvl in range(n_levels - 1, -1, -1):
        radius = SEARCH_RADIUS_COARSEST if lvl == n_levels - 1 else SEARCH_RADIUS_REFINE
        eps_l = eps if lvl == 0 else max(eps, eps_coarse)
        pts_l = pts / (2.0 ** lvl)
        ip, inx = pyr_prev[lvl], pyr_next[lvl]
        # Levels smaller than the correlation window are edge-padded first.
        ph = max(win + 2 - ip.shape[0], 0)
        pw = max(win + 2 - ip.shape[1], 0)
        ip = pad_edge(ip, 0, ph, 0, pw)
        inx = pad_edge(inx, 0, ph, 0, pw)
        eh = (-(ip.shape[0] + 2 * pad)) % 8
        ew = (-(ip.shape[1] + 2 * pad)) % 128
        ipp = pad_edge(ip, pad, pad + eh, pad, pad + ew).contiguous()
        inxp = pad_edge(inx, pad, pad + eh, pad, pad + ew).contiguous()
        rnds = rounds_coarse if lvl == n_levels - 1 else rounds_refine
        flow, ok = lk_dense.level_track_dense(
            ipp, inxp, pts_l, flow, win=win, iters=iters, eps=eps_l,
            min_eig=min_eig, search_radius=radius, pad=pad, rounds=rnds,
            active=active)
        ok_all = ok_all & ok
        if lvl > 0:
            flow = flow * 2.0
    next_pts = pts + flow
    h, w = pyr_next[0].shape
    inside = ((next_pts[:, 0] >= 0) & (next_pts[:, 0] <= w - 1) &
              (next_pts[:, 1] >= 0) & (next_pts[:, 1] <= h - 1))
    return next_pts, ok_all & inside


def circular_track(pyrs, pts_t1l: torch.Tensor, valid: torch.Tensor, rig,
                   T_pred: torch.Tensor, dmap_prev: torch.Tensor,
                   feature_match_error: float = 2.0, cycle_error: float = 2.0,
                   win: int = 21, iters: int = 30, eps: float = 0.01,
                   eps_coarse: float = 0.03, sweep_d_max: int = 48,
                   stereo_levels: int = 1, temporal_levels: int = 2,
                   max_disp: float = 192.0, max_guess: float = 160.0,
                   rounds_prior: int = 4, rounds_refine: int = 2):
    """4-way circular LK t1L -> t1R -> t2R -> t2L -> t1L with the predictive
    initialization of the main path.

    The stereo legs start from the plane-sweep disparity map (the previous
    frame's t2 map for the t1 pair, a fresh sweep for the t2 pair); the
    temporal legs start from the constant-velocity motion model ``T_pred``
    applied to the leg-1 triangulation. Every leg has a prior, so every leg
    runs with the prior round budget ``rounds_prior`` on its coarsest level
    and ``rounds_refine`` on the finer ones.
    The gates are the reference's: all four statuses, stereo |dy| <=
    ``feature_match_error`` in both pairs, and the cycle closure within
    ``cycle_error`` px.

    Args:
      pyrs: (pyr_t1l, pyr_t1r, pyr_t2r, pyr_t2l) factor-2 pyramids.
      rig: ``StereoRig``; T_pred: (4, 4) predicted T_21.
      dmap_prev: the t1 pair's disparity map (pyramid level min(2, L-1)).
    Returns:
      dict(t1l, t1r, t2r, t2l (N, 2), valid (N,), dmap: the t2 pair's map).
    """
    pyr_t1l, pyr_t1r, pyr_t2r, pyr_t2l = pyrs
    kw = dict(win=win, iters=iters, eps=eps, eps_coarse=eps_coarse,
              rounds_coarse=rounds_prior, rounds_refine=rounds_refine)
    clipg = lambda g: torch.clamp(g, -max_guess, max_guess)
    L = min(2, len(pyr_t1l) - 1)
    scale = 2.0 ** L

    d0 = torch.clamp(stereo_sweep.sample_map(dmap_prev, pts_t1l, scale), 0.0, max_disp)
    g1 = torch.stack([-d0, torch.zeros_like(d0)], dim=-1)
    p_t1r, ok1 = track(pyr_t1l, pyr_t1r, pts_t1l, init_flow=g1, active=valid,
                       levels=stereo_levels, **kw)
    ok1 = ok1 & valid

    fxB = rig.left.fx * rig.baseline
    d1 = torch.clamp(pts_t1l[:, 0] - p_t1r[:, 0], 1.0, max_disp)
    X = rig.left.unproject(pts_t1l, fxB / d1)
    X2 = se3.transform_points(T_pred, X)
    z2 = torch.clamp(X2[:, 2], min=0.5)
    X2 = torch.stack([X2[:, 0], X2[:, 1], z2], dim=-1)
    p2l_pred = rig.left.project(X2)
    d2_pred = torch.clamp(fxB / z2, 0.0, max_disp)
    p2r_pred = p2l_pred - torch.stack([d2_pred, torch.zeros_like(d2_pred)], dim=-1)
    g2 = clipg(p2r_pred - p_t1r)
    p_t2r, ok2 = track(pyr_t1r, pyr_t2r, p_t1r, init_flow=g2, active=ok1,
                       levels=temporal_levels, **kw)
    ok2 = ok2 & ok1

    dmap2 = stereo_sweep.disparity_sweep(pyr_t2l[L], pyr_t2r[L], d_max=sweep_d_max)
    d2s = torch.clamp(stereo_sweep.sample_map(dmap2, p2l_pred, scale), 0.0, max_disp)
    g3 = torch.stack([d2s, torch.zeros_like(d2s)], dim=-1)
    p_t2l, ok3 = track(pyr_t2r, pyr_t2l, p_t2r, init_flow=g3, active=ok2,
                       levels=stereo_levels, **kw)
    ok3 = ok3 & ok2

    # Back-leg guess from the motion model, not from pts_t1l: a bad forward
    # track still has to earn cycle closure through real iterations.
    g4 = clipg(pts_t1l - p2l_pred)
    p_t1l_back, ok4 = track(pyr_t2l, pyr_t1l, p_t2l, init_flow=g4, active=ok3,
                            levels=temporal_levels, **kw)

    epi1 = torch.abs(pts_t1l[:, 1] - p_t1r[:, 1]) <= feature_match_error
    epi2 = torch.abs(p_t2l[:, 1] - p_t2r[:, 1]) <= feature_match_error
    cyc = torch.sum((p_t1l_back - pts_t1l) ** 2, dim=-1) <= cycle_error * cycle_error
    ok = valid & ok1 & ok2 & ok3 & ok4 & epi1 & epi2 & cyc
    return {"t1l": pts_t1l, "t1r": p_t1r, "t2r": p_t2r, "t2l": p_t2l,
            "valid": ok, "dmap": dmap2}
