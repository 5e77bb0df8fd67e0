"""Batched pyramidal Lucas-Kanade, the disparity-grid prior and the 4-way
circular matcher.

Port of ``stereo_visual_odometry_tpu/ops/lk.py`` with its branches:

* ``track(use_pallas=True)`` edge-pads each level exactly as the JAX kernel
  path pads it — by ``(win-1)//2 + 2`` and then up to a multiple of 8 rows
  and 128 columns — because the level kernels clip window corners against
  the padded extents, and a smaller pad would track border points
  differently. Then ``pallas_kernel`` picks the level tracker: ``'cell'`` →
  K3 (``lk_cell``), ``'dense'`` → ``lk_dense`` on K1, anything else → K4
  (``lk_v1``).
* ``track(use_pallas=False)`` runs ``_level_track``, the XLA formulation,
  on levels with only the small-level pad: five bilinear gathers for the
  template, one K1 read of each point's search window, and a fixed
  ``iters`` loop with masked updates.

The JAX ``BLK`` point padding is not needed: the kernels take any N.
"""
from __future__ import annotations

import torch

from . import interp, lk_cell, lk_dense, lk_v1, patch, se3, stereo_sweep
from .patch import pad_edge

# Max flow change per level beyond the incoming guess (px).
SEARCH_RADIUS_COARSEST = 20
SEARCH_RADIUS_REFINE = 6


def _slice_windows(img: torch.Tensor, origin_rc: torch.Tensor, size_h: int,
                   size_w: int) -> torch.Tensor:
    """(N, 2) int32 [row, col] origins, pre-clipped to the image -> (N,
    size_h, size_w) windows: one K1 launch on the card."""
    return patch.extract_windows_int(img.contiguous(), origin_rc.contiguous(),
                                     (size_h, size_w))


def _shift_blend(windows: torch.Tensor, tl_rc: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinear (win, win) patches from per-point windows: every sample of a
    patch shares one fraction, so it is a (win+1)^2 integer slice of the
    window (corner clipped inside it) and a 4-tap blend.

    Args:
      windows: (N, Sh, Sw) per-point search windows.
      tl_rc: (N, 2) float patch top-left in window coords [row, col].
    """
    sh, sw = windows.shape[-2], windows.shape[-1]
    tl0 = torch.floor(tl_rc)
    f = tl_rc - tl0
    r0 = torch.clamp(tl0[:, 0].to(torch.int32), 0, sh - win - 1).long()
    c0 = torch.clamp(tl0[:, 1].to(torch.int32), 0, sw - win - 1).long()
    off = torch.arange(win + 1, device=windows.device)
    n_idx = torch.arange(windows.shape[0], device=windows.device)[:, None, None]
    sub = windows[n_idx, (r0[:, None] + off)[:, :, None], (c0[:, None] + off)[:, None, :]]
    fy = f[:, 0][:, None, None]
    fx = f[:, 1][:, None, None]
    a = sub[:, :win, :win]
    b = sub[:, :win, 1:]
    c = sub[:, 1:, :win]
    d = sub[:, 1:, 1:]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx +
            c * fy * (1 - fx) + d * fy * fx)


def _level_track(img_prev: torch.Tensor, img_next: torch.Tensor, pts: torch.Tensor,
                 guess: torch.Tensor, win: int, iters: int, eps: float,
                 min_eig: float, search_radius: int,
                 active: torch.Tensor | None = None):
    """One pyramid level of LK for all points, the XLA formulation.

    Args:
      pts: (N, 2) keypoint positions in this level's pixel coords.
      guess: (N, 2) current flow estimate in this level's coords.
    Returns: (flow (N, 2), ok (N,) bool).

    The template and its gradients are five bilinear gathers of the
    unpadded level; the iterations read only per-point (S, S) search
    windows of the next level, edge-padded by r+1 and sliced once with K1
    (origins pre-clipped to the padded level, as K1's contract wants). The
    ``iters`` iterations run for every point with masked updates: no early
    exit and no convergence gate. Flow beyond ``search_radius`` of the
    incoming guess fails the point.
    """
    h, w = img_next.shape
    r = (win - 1) // 2
    dtype, dev = pts.dtype, pts.device
    grid = interp.patch_grid(win, dtype=dtype, device=dev)  # (P, P, 2)
    base = pts[:, None, None, :] + grid[None]               # (N, P, P, 2)

    T = interp.bilinear(img_prev, base)
    dx, dy = torch.eye(2, dtype=dtype, device=dev)  # made on the device: capturable
    Ix = (interp.bilinear(img_prev, base + dx) - interp.bilinear(img_prev, base - dx)) * 0.5
    Iy = (interp.bilinear(img_prev, base + dy) - interp.bilinear(img_prev, base - dy)) * 0.5

    g00 = torch.sum(Ix * Ix, dim=(1, 2))
    g01 = torch.sum(Ix * Iy, dim=(1, 2))
    g11 = torch.sum(Iy * Iy, dim=(1, 2))
    det = g00 * g11 - g01 * g01
    tr = g00 + g11
    min_eig_val = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5 / (win * win)
    ok = min_eig_val > min_eig
    if active is not None:
        ok = ok & active
    safe_det = torch.where(torch.abs(det) < 1e-12, 1.0, det)
    inv00 = g11 / safe_det
    inv01 = -g01 / safe_det
    inv11 = g00 / safe_det

    pad = r + 1
    img_pad = pad_edge(img_next, pad, pad, pad, pad)
    hp, wp = h + 2 * pad, w + 2 * pad
    size = win + 1 + 2 * (search_radius + 1)
    size_h = min(size, hp)
    size_w = min(size, wp)
    origin_xy = torch.floor(pts + guess) - (r + search_radius + 1) + pad
    origin_rc = torch.stack([
        torch.clamp(origin_xy[:, 1].to(torch.int32), 0, hp - size_h),
        torch.clamp(origin_xy[:, 0].to(torch.int32), 0, wp - size_w)], dim=-1)
    windows = _slice_windows(img_pad, origin_rc, size_h, size_w)
    origin_f = torch.stack([origin_rc[:, 1], origin_rc[:, 0]], dim=-1).to(dtype) - pad

    v = guess
    act = ok.to(dtype)
    for _ in range(iters):
        tl_xy = pts + v - r - origin_f
        tl_rc = torch.stack([tl_xy[:, 1], tl_xy[:, 0]], dim=-1)
        rdiff = T - _shift_blend(windows, tl_rc, win)
        b0 = torch.sum(rdiff * Ix, dim=(1, 2))
        b1 = torch.sum(rdiff * Iy, dim=(1, 2))
        step = torch.stack([inv00 * b0 + inv01 * b1, inv01 * b0 + inv11 * b1], dim=-1)
        v = v + step * act[:, None]
        act = act * (torch.sum(step * step, dim=-1) > eps * eps)
    inside = torch.all(torch.abs(v - guess) <= search_radius, dim=-1)
    return v, ok & inside


def track(pyr_prev, pyr_next, pts: torch.Tensor, win: int = 21, levels: int = 3,
          iters: int = 30, eps: float = 0.01, eps_coarse: float = 0.03,
          min_eig: float = 1e-4, use_pallas: bool = False, pallas_kernel: str = "cell",
          init_flow: torch.Tensor | None = None, active: torch.Tensor | None = None,
          rounds_coarse: int = 8, rounds_refine: int = 2):
    """Track N points from prev to next through a factor-2 pyramid.

    Args:
      pyr_prev / pyr_next: sequences of (H/2^l, W/2^l) float32 levels.
      pts: (N, 2) [x, y] level-0 positions.
      use_pallas / pallas_kernel: the level tracker (module docstring).
      init_flow: optional (N, 2) level-0 flow guess; each level's search
        radius applies around it.
      rounds_coarse / rounds_refine: the dense tracker's reload rounds on
        the coarsest and the finer levels.
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
        if not use_pallas:
            flow, ok = _level_track(ip, inx, pts_l, flow, win, iters, eps_l, min_eig,
                                    radius, active=active)
        else:
            pad = (win - 1) // 2 + 2
            eh = (-(ip.shape[0] + 2 * pad)) % 8
            ew = (-(ip.shape[1] + 2 * pad)) % 128
            ipp = pad_edge(ip, pad, pad + eh, pad, pad + ew).contiguous()
            inxp = pad_edge(inx, pad, pad + eh, pad, pad + ew).contiguous()
            kw = dict(win=win, iters=iters, eps=eps_l, min_eig=min_eig,
                      search_radius=radius, pad=pad, active=active)
            if pallas_kernel == "cell":
                flow, ok = lk_cell.level_track_cell(ipp, inxp, pts_l, flow, **kw)
            elif pallas_kernel == "dense":
                rnds = rounds_coarse if lvl == n_levels - 1 else rounds_refine
                flow, ok = lk_dense.level_track_dense(ipp, inxp, pts_l, flow,
                                                      rounds=rnds, **kw)
            else:
                flow, ok = lk_v1.level_track_v1(ipp, inxp, pts_l, flow, **kw)
        ok_all = ok_all & ok
        if lvl > 0:
            flow = flow * 2.0
    next_pts = pts + flow
    h, w = pyr_next[0].shape
    inside = ((next_pts[:, 0] >= 0) & (next_pts[:, 0] <= w - 1) &
              (next_pts[:, 1] >= 0) & (next_pts[:, 1] <= h - 1))
    return next_pts, ok_all & inside


def _cells(xy: torch.Tensor, cell: int, gh: int, gw: int):
    cx = torch.clamp((xy[:, 0] / cell).to(torch.int32), 0, gw - 1)
    cy = torch.clamp((xy[:, 1] / cell).to(torch.int32), 0, gh - 1)
    return cy, cx


def disparity_grid(xy: torch.Tensor, disp: torch.Tensor, valid: torch.Tensor,
                   height: int, width: int, cell: int = 64,
                   default_disp: float = 24.0) -> torch.Tensor:
    """Rasterize sparse disparities into a coarse per-cell prior grid.

    (N, 2) pixel positions + (N,) disparities -> (H/cell, W/cell) mean
    disparity per cell; empty cells take the median of the valid
    disparities (the element at index n_valid // 2 of the sorted valid
    ones), or ``default_disp`` when nothing is valid.
    """
    gh = -(-height // cell)
    gw = -(-width // cell)
    cy, cx = _cells(xy, cell, gh, gw)
    idx = (cy * gw + cx).long()
    v = valid.to(disp.dtype)
    # index_put with accumulate sums each cell's entries in index order, on
    # the card too (sorted, no atomics): the same bits every run, and the
    # same as the CPU's sequential sums. index_add_ adds atomically there.
    # Out of place, so that vmap can batch the sums into its own zeros.
    zeros = lambda: torch.zeros(gh * gw, dtype=disp.dtype, device=disp.device)
    sums = zeros().index_put((idx,), disp * v, accumulate=True)
    cnts = zeros().index_put((idx,), v, accumulate=True)
    order = torch.sort(torch.where(valid, disp, torch.inf)).values
    n_valid = torch.sum(valid)
    med = order.index_select(0, torch.clamp(n_valid // 2, 0, disp.shape[0] - 1)
                             .reshape(1))[0]  # a 1-d index: no read back to the host
    med = torch.where(n_valid > 0, med, med.new_full((), default_disp))
    grid = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0), med)
    return grid.reshape(gh, gw)


def sample_disparity(grid: torch.Tensor, xy: torch.Tensor, cell: int = 64) -> torch.Tensor:
    """Sample the per-cell disparity prior at (N, 2) pixel positions."""
    gh, gw = grid.shape
    cy, cx = _cells(xy, cell, gh, gw)
    return grid[cy.long(), cx.long()]


def circular_track(pyrs, pts_t1l: torch.Tensor, valid: torch.Tensor,
                   feature_match_error: float = 2.0, cycle_error: float = 2.0,
                   win: int = 21, levels: int = 3, iters: int = 30,
                   eps: float = 0.01, eps_coarse: float = 0.03,
                   use_pallas: bool = False, pallas_kernel: str = "cell",
                   rig=None, T_pred: torch.Tensor | None = None,
                   disp_prior: torch.Tensor | None = None,
                   use_sweep: bool = False, sweep_d_max: int = 48,
                   stereo_levels: int | None = None,
                   temporal_levels: int | None = None,
                   max_disp: float = 192.0, max_guess: float = 160.0,
                   dmap_prev: torch.Tensor | None = None,
                   rounds_prior: int = 4, rounds_coarse: int = 8,
                   rounds_refine: int = 2):
    """4-way circular LK t1L -> t1R -> t2R -> t2L -> t1L.

    The gates are the reference's: all four statuses, stereo |dy| <=
    ``feature_match_error`` in both pairs, and the cycle closure within
    ``cycle_error`` px.

    Each leg starts from the best guess it has: the stereo legs from the
    plane-sweep map (``use_sweep``; the previous frame's t2 map
    ``dmap_prev`` for the t1 pair, a fresh sweep for the t2 pair) or from
    ``disp_prior``; the temporal legs (and, without the sweep, the t2
    stereo leg) from the constant-velocity motion model ``T_pred`` applied
    to the leg-1 triangulation. A leg with a guess runs ``rounds_prior``
    dense rounds on its coarsest level and ``stereo_levels`` /
    ``temporal_levels`` levels where given; a leg without one runs
    ``rounds_coarse`` rounds over ``levels`` levels.

    Args:
      pyrs: (pyr_t1l, pyr_t1r, pyr_t2r, pyr_t2l) factor-2 pyramids.
      rig: optional ``StereoRig`` enabling the motion-model guesses.
      T_pred: optional (4, 4) predicted T_21 (current from previous).
      disp_prior: optional (N,) per-point disparity guess (level-0 px).
    Returns:
      dict(t1l, t1r, t2r, t2l (N, 2), valid (N,)), plus ``dmap``, the t2
      pair's map (the next frame's ``dmap_prev``), when sweeping.
    """
    pyr_t1l, pyr_t1r, pyr_t2r, pyr_t2l = pyrs
    kw = dict(win=win, iters=iters, eps=eps, eps_coarse=eps_coarse,
              use_pallas=use_pallas, pallas_kernel=pallas_kernel,
              rounds_coarse=rounds_coarse, rounds_refine=rounds_refine)
    kw_prior = dict(kw, rounds_coarse=rounds_prior)
    lv_st = levels if stereo_levels is None else stereo_levels
    lv_tm = levels if temporal_levels is None else temporal_levels
    clipg = lambda g: torch.clamp(g, -max_guess, max_guess)

    def leg(pyr_a, pyr_b, pts, guess, act, lv_guess):
        if guess is None:
            return track(pyr_a, pyr_b, pts, active=act, levels=levels, **kw)
        return track(pyr_a, pyr_b, pts, init_flow=guess, active=act, levels=lv_guess,
                     **kw_prior)

    g1 = None
    if use_sweep:
        L = min(2, len(pyr_t1l) - 1)
        scale = 2.0 ** L
        dmap1 = (dmap_prev if dmap_prev is not None else
                 stereo_sweep.disparity_sweep(pyr_t1l[L], pyr_t1r[L], d_max=sweep_d_max))
        d0 = torch.clamp(stereo_sweep.sample_map(dmap1, pts_t1l, scale), 0.0, max_disp)
        g1 = torch.stack([-d0, torch.zeros_like(d0)], dim=-1)
    elif disp_prior is not None:
        d0 = torch.clamp(disp_prior, 0.0, max_disp)
        g1 = torch.stack([-d0, torch.zeros_like(d0)], dim=-1)
    p_t1r, ok1 = leg(pyr_t1l, pyr_t1r, pts_t1l, g1, valid, lv_st)
    ok1 = ok1 & valid

    g2 = g3 = g4 = None
    if rig is not None and T_pred is not None:
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
    p_t2r, ok2 = leg(pyr_t1r, pyr_t2r, p_t1r, g2, ok1, lv_tm)
    ok2 = ok2 & ok1

    if use_sweep:
        dmap2 = stereo_sweep.disparity_sweep(pyr_t2l[L], pyr_t2r[L], d_max=sweep_d_max)
        at = p2l_pred if g2 is not None else p_t2r
        d2s = torch.clamp(stereo_sweep.sample_map(dmap2, at, scale), 0.0, max_disp)
        g3 = torch.stack([d2s, torch.zeros_like(d2s)], dim=-1)
    elif g2 is not None:
        g3 = clipg(p2l_pred - p_t2r)
    p_t2l, ok3 = leg(pyr_t2r, pyr_t2l, p_t2r, g3, ok2, lv_st)
    ok3 = ok3 & ok2

    if g2 is not None:
        # Back-leg guess from the motion model, not from pts_t1l: a bad
        # forward track still has to earn cycle closure through real
        # iterations.
        g4 = clipg(pts_t1l - p2l_pred)
    p_t1l_back, ok4 = leg(pyr_t2l, pyr_t1l, p_t2l, g4, ok3, lv_tm)

    epi1 = torch.abs(pts_t1l[:, 1] - p_t1r[:, 1]) <= feature_match_error
    epi2 = torch.abs(p_t2l[:, 1] - p_t2r[:, 1]) <= feature_match_error
    cyc = torch.sum((p_t1l_back - pts_t1l) ** 2, dim=-1) <= cycle_error * cycle_error
    ok = valid & ok1 & ok2 & ok3 & ok4 & epi1 & epi2 & cyc
    out = {"t1l": pts_t1l, "t1r": p_t1r, "t2r": p_t2r, "t2l": p_t2l, "valid": ok}
    if use_sweep:
        out["dmap"] = dmap2
    return out
