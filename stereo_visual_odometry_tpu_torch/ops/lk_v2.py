"""K6: the block per-iteration LK level kernel.

Port of ``lk_pallas_v2.level_track_pallas_v2``
(``scripts/lk_pallas_v2.py:182-221``, kernel ``_make_kernel`` :43): K4's
function (``lk_v1``: reload and re-blend the (win+1)^2 window on every
iteration), which the JAX kernel runs for BLK = 8 points in one joint loop
until all of them converge, freezing a converged point by ``vx + dx *
active``. Per point that is K4's sequence of iterations; the port's kernel
stops a converged point instead, which is the same for finite steps. Like
the JAX kernel it takes no ``active`` mask: every point is tracked.

CUDA kernel ``csrc/lk_block.cu`` (one warp per point, entry
``svo_lk_level_v2``). The wrapper routes by device as
``lk_v1.level_track_v1`` does and counts its launches in
``level_track_v2.launches``.
"""
from __future__ import annotations

import torch

from . import lk_block, lk_v1


def level_track_v2_reference(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                             pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                             iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                             search_radius: int = 6, pad: int = 0,
                             stats: dict | None = None):
    """Plain version of K6: K4's plain version
    (``lk_v1.level_track_v1_reference``) with every point active. The JAX
    kernel is a drop-in for K4 (``lk_pallas_v2.py:187``) and
    ``tests/test_torch_lk_block.py`` holds this function to it."""
    return lk_v1.level_track_v1_reference(img_prev_pad, img_next_pad, pts, guess, win,
                                          iters, eps, min_eig, search_radius, pad,
                                          None, stats)


def level_track_v2(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                   pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                   iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                   search_radius: int = 6, pad: int = 0, stats: dict | None = None):
    """One LK level for N points: the signature and return of JAX
    ``level_track_pallas_v2`` without ``interpret``, plus ``stats`` (each
    point's ``iters`` and ``reloads``). Returns (flow (N, 2) = guess + found
    delta, ok (N,) bool)."""
    lk_v1.check_inputs(img_prev_pad, img_next_pad, pts, guess, None, win)
    if img_prev_pad.device.type == "cpu":
        return level_track_v2_reference(img_prev_pad, img_next_pad, pts, guess, win,
                                        iters, eps, min_eig, search_radius, pad, stats)
    flow_d, ok = lk_v1.launch("svo_lk_level_v2", img_prev_pad, img_next_pad, pts, guess,
                              win, iters, eps, min_eig, pad, None, stats,
                              smem=lk_block.smem_bytes(win))
    level_track_v2.launches += 1
    return lk_v1.finish(guess, flow_d, ok > 0, search_radius)


level_track_v2.launches = 0
