"""K3: the cell-blend LK level kernel (``lk_kernel='cell'``).

Port of ``lk_pallas_cell.level_track_pallas_cell``
(``stereo_visual_odometry_tpu/ops/lk_pallas_cell.py:279-309``). The same
contract as K4 (``lk_v1``): with the integer window corner fixed, the
warped patch is bilinear in the fraction, so the right-hand side is too,

    sum((T - w) * Ix) = tIx - [(1-fy)(1-fx) sIxa + (1-fy) fx sIxb
                               + fy (1-fx) sIxc + fy fx sIxd]

and a point reloads its (win+1)^2 window only when it enters another pixel
cell: 8 dots per cell, then scalar iterations until the point converges
(step at most ``eps``), leaves the cell, or has taken ``iters`` iterations.
The iteration sequence is K4's up to summation order. No convergence gate,
as the JAX kernel.

CUDA kernel ``csrc/lk_level.cu`` (entry ``svo_lk_level_cell_batched``, B = 1
for one level pair), plain version ``level_track_cell_reference``; the wrapper routes by device as
``lk_v1.level_track_v1`` does and counts its launches in
``level_track_cell.launches`` (none at N = 0). As K4's, the kernel does the
JAX wrapper's tail (``lk_v1.finish``) itself, so a level call is one CUDA
kernel: in the JAX package XLA fuses that tail into the level's jit, and
eager PyTorch would pay six more launches for it. Under ``torch.func.vmap``
the wrapper calls the custom op ``svo::lk_level_cell`` (``ops/library.py``),
whose batch rule is the port's counterpart of the JAX kernel's stacked-image
``custom_vmap``: S sequences are one launch of ``svo_lk_level_cell_batched``
(``level_track_cell_batched``), with a sequence axis instead of a stack
(``csrc/lk_level.cu``).
"""
from __future__ import annotations

import torch

from . import lk_dense, lk_v1, patch


def level_track_cell_reference(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                               pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                               iters: int = 30, eps: float = 0.01,
                               min_eig: float = 1e-4, search_radius: int = 6,
                               pad: int = 0, active: torch.Tensor | None = None,
                               stats: dict | None = None):
    """Plain version of K3: the JAX kernel's nested loops flattened.

    The JAX outer loop reloads at the point's current clipped cell and its
    inner loop runs while the point stays in that cell, sharing one
    iteration counter; so every iteration uses the 8 dots of the cell the
    point is in. Here each of ``iters`` steps gives every running point
    exactly one iteration with the 8 dots recomputed at its current cell
    (the same values a cached reload gives). A step counts as a reload for
    a point when its cell differs from the one of its previous iteration.

    ``stats``, if given, receives per point ``iters`` and ``reloads``,
    ``corners``: the (M, 2) [row, col] corners of every window reloaded, and
    ``points``, the (M,) point of each.
    """
    n = pts.shape[0]
    hp, wp = img_prev_pad.shape
    r = (win - 1) // 2
    i32, f32 = torch.int32, torch.float32
    py, px = pts[:, 1] + pad, pts[:, 0] + pad
    gy, gx = guess[:, 1], guess[:, 0]
    tpl = lk_dense.template_phase(img_prev_pad, py, px, win, min_eig,
                                  windows=patch.extract_windows_int_reference)
    ok = tpl.ok if active is None else tpl.ok & active
    grad = lk_dense.grad8(tpl.Ix, tpl.Iy)
    Fn = (win + 1) * (win + 1)
    run = ok.clone()
    vy, vx = torch.zeros_like(py), torch.zeros_like(px)
    last = torch.full((n, 2), -1, dtype=i32, device=pts.device)
    n_it = torch.zeros(n, dtype=i32, device=pts.device)
    n_rel = torch.zeros(n, dtype=i32, device=pts.device)
    index = torch.arange(n, device=pts.device)
    corners, owners = [], []
    for _ in range(iters):
        if not bool(run.any()):
            break
        iy = torch.clamp(torch.floor(py + gy + vy - r).to(i32), 0, hp - win - 1)
        ix = torch.clamp(torch.floor(px + gx + vx - r).to(i32), 0, wp - win - 1)
        corner = torch.stack([iy, ix], dim=-1)
        W = patch.extract_windows_int_reference(img_next_pad, corner, win + 1)
        dots = torch.bmm(W.reshape(n, 1, Fn), grad)[:, 0]
        fy = (py + gy + vy - r) - iy.to(f32)
        fx = (px + gx + vx - r) - ix.to(f32)
        wy0, wx0 = 1.0 - fy, 1.0 - fx
        wIx = (wy0 * wx0 * dots[:, 0] + wy0 * fx * dots[:, 1] +
               fy * wx0 * dots[:, 2] + fy * fx * dots[:, 3])
        wIy = (wy0 * wx0 * dots[:, 4] + wy0 * fx * dots[:, 5] +
               fy * wx0 * dots[:, 6] + fy * fx * dots[:, 7])
        b0 = tpl.tIx - wIx
        b1 = tpl.tIy - wIy
        dx = tpl.inv00 * b0 + tpl.inv01 * b1
        dy = tpl.inv01 * b0 + tpl.inv11 * b1
        reload = run & torch.any(corner != last, dim=-1)
        if stats is not None:
            corners.append(corner[reload])
            owners.append(index[reload])
        n_rel += reload.to(i32)
        n_it += run.to(i32)
        last = torch.where(run[:, None], corner, last)
        vx = torch.where(run, vx + dx, vx)
        vy = torch.where(run, vy + dy, vy)
        run = run & (dx * dx + dy * dy > eps * eps)
    if stats is not None:
        stats.update(iters=n_it, reloads=n_rel, **lk_v1.reload_log(corners, owners, pts))
    return lk_v1.finish(guess, torch.stack([vx, vy], dim=-1), ok, search_radius)


def level_track_cell(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                     pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                     iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                     search_radius: int = 6, pad: int = 0,
                     active: torch.Tensor | None = None, stats: dict | None = None):
    """One LK level for N points, the same signature and return as
    ``lk_v1.level_track_v1`` (and JAX ``level_track_pallas_cell`` without
    ``interpret``)."""
    lk_v1.check_inputs(img_prev_pad, img_next_pad, pts, guess, active, win)
    if stats is None and patch.transformed():
        return torch.ops.svo.lk_level_cell(img_prev_pad, img_next_pad, pts, guess, win,
                                           iters, float(eps), float(min_eig),
                                           float(search_radius), pad, active)
    if img_prev_pad.device.type == "cpu":
        return level_track_cell_reference(img_prev_pad, img_next_pad, pts, guess, win,
                                          iters, eps, min_eig, search_radius, pad,
                                          active, stats)
    return lk_v1.launch("svo_lk_level_cell_batched", level_track_cell, img_prev_pad,
                        img_next_pad, pts, guess, win, iters, eps, min_eig, pad, active, stats,
                        search_radius)


def level_track_cell_batched(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                             pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                             iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                             search_radius: int = 6, pad: int = 0,
                             active: torch.Tensor | None = None):
    """K3 on a sequence axis: (B, Hp, Wp) level pairs, (B, N, 2) points and
    guesses, an optional (B, N) mask -> (flow (B, N, 2), ok (B, N)), sequence
    b tracked on pair b. One launch of ``svo_lk_level_cell_batched`` on
    CUDA."""
    return lk_v1.batched(level_track_cell_reference, "svo_lk_level_cell_batched",
                         level_track_cell, img_prev_pad, img_next_pad, pts, guess, win, iters,
                         eps, min_eig, search_radius, pad, active)


level_track_cell.launches = 0
