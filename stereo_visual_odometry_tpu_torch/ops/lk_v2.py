"""K6: the block per-iteration LK level kernel.

Port of ``lk_pallas_v2.level_track_pallas_v2``
(``scripts/lk_pallas_v2.py:182-221``, kernel ``_make_kernel`` :43): K4's
function (``lk_v1``: reload and re-blend the (win+1)^2 window on every
iteration), which the JAX kernel runs for BLK = 8 points in one joint loop
until all of them converge, freezing a converged point by ``vx + dx *
active``. Per point that is K4's sequence of iterations; the port's kernel
stops a converged point instead, which is the same for finite steps. Like
the JAX kernel it takes no ``active`` mask: every point is tracked.

CUDA kernel ``csrc/lk_block.cu`` (entry ``svo_lk_level_v2``): K5's kernel
(``lk_block``: one warp per point, the template window and a region of the
next image staged once per point, a window off the region read with each
lane's loads in flight together) with K4's per-iteration body, which keeps the
template T beside the gradients (``lk_block.iter_smem_bytes``). It has
K4's C contract and finishes the level itself (flow = guess + delta, ok
with the ``search_radius`` test, ``stats`` only when asked), so a level
call is one kernel. Its C entry takes K4's bool mask, which the wrapper
leaves null (the JAX signature has no ``active``): the LK timing probe
passes K4's mask through the bare entry to time K6 on K4's calls. The
wrapper routes by device as ``lk_v1.level_track_v1`` does and counts its
launches in ``level_track_v2.launches`` (none at N = 0).
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
    return lk_v1.launch("svo_lk_level_v2", level_track_v2, img_prev_pad, img_next_pad, pts,
                        guess, win, iters, eps, min_eig, pad, None, stats, search_radius,
                        smem=lk_block.iter_smem_bytes(win))


level_track_v2.launches = 0
