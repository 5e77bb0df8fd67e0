"""K5: the block cell-blend LK level kernel, and K8: its timing split.

* K5, port of ``lk_pallas_block.level_track_pallas_block``
  (``scripts/lk_pallas_block.py:249-296``, kernel ``_make_kernel`` :58): K3's
  function (``lk_cell``), which the JAX kernel computes for BLK = 8 points at
  once as (8, 1) vectors. Its ``active`` mask is applied after the kernel
  there (inactive points iterate, then ``flow = guess``, ``ok = False``); the
  port's kernel skips them, as K3's does, with the same output, and their
  ``stats`` are 0.
* K8, port of ``probe_lk_breakdown.variant_kernel``
  (``scripts/probe_lk_breakdown.py:42-104``, called by ``run_variant`` :106):
  K5 cut into ``tmpl`` (the template phase only), ``reload`` (the template,
  then ``rounds`` forced window reloads with their 8 dots, no iterations) and
  ``full`` (K5's own kernel, as the TPU probe builds it with K5's factory),
  to time where an LK level call's time goes.

CUDA kernel ``csrc/lk_block.cu`` (``lk_block_cell_kernel``), one warp per
point, shared with K6 (``lk_v2``): it stages the template window and a
region of the next image once per point, as K3 does. K5
(``svo_lk_level_block``) finishes the level itself with K3's contract
(``lk_v1.launch``: a bool ``active`` or None, flow = guess + delta, ok with
the ``search_radius`` test, ``stats`` only when asked), so a call is one
kernel. K8 (``svo_lk_block_split``) runs every variant on the same kernel:
``full`` is K5's body with the raw delta and gate, ``tmpl`` and ``reload``
are K5's staging and template phase and (``reload``) K5's window read and
8-dot pass per forced round, so the split measures the phases of the
kernel ``full`` runs. Its C entry takes no mask and no guess (zero
guesses), so a call allocates only its outputs and is one kernel. The
wrappers route by device as ``lk_v1.level_track_v1`` does (a CPU tensor
takes the plain version, a CUDA tensor launches the kernel, anything else
raises) and count their launches in ``level_track_block.launches`` and
``level_track_block_split.launches`` (none at N = 0). The JAX wrapper's
N % 8 pad and the Mosaic shapes are not needed: any N works.
"""
from __future__ import annotations

import torch

from . import cuda_stream, lk_cell, lk_dense, lk_v1, native, patch

# Points per CTA of csrc/lk_block.cu (one warp each): K5 and K8, and K6; the
# margin (px) of the region of the next image staged around the window at
# the guess (K3's).
CELL_POINTS_PER_CTA, ITER_POINTS_PER_CTA, STAGE_MARGIN = 2, 2, 7
# K8's variants and their C mode numbers.
SPLIT_MODES = {"full": 0, "tmpl": 1, "reload": 2}
# The JAX probe's operating point for ``full`` (probe_lk_breakdown.py:36-38):
# zero guesses, 30 iterations, eps 0.01.
SPLIT_ITERS, SPLIT_EPS = 30, 0.01


def _slice_floats(win: int, template: bool) -> int:
    """Floats of one point's slice of csrc/lk_block.cu's kernel: the
    gradients (Ix, Iy), the template T if ``template``, the (win+3)^2 window
    buffer, the staged region of the next image and the (win+2)^2 field,
    rounded up to even."""
    side = win + 1 + 2 * STAGE_MARGIN
    floats = (3 if template else 2) * win * win + (win + 3) ** 2 + side * side + (win + 2) ** 2
    return floats + floats % 2


def cell_smem_bytes(win: int) -> int:
    """Shared memory of one CTA of the kernel running K5 or K8."""
    return 4 * CELL_POINTS_PER_CTA * _slice_floats(win, template=False)


def iter_smem_bytes(win: int) -> int:
    """Shared memory of one CTA of the kernel running K6, whose slice also
    keeps the template T."""
    return 4 * ITER_POINTS_PER_CTA * _slice_floats(win, template=True)


def level_track_block_reference(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                                pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                                iters: int = 30, eps: float = 0.01,
                                min_eig: float = 1e-4, search_radius: int = 6,
                                pad: int = 0, active: torch.Tensor | None = None,
                                stats: dict | None = None):
    """Plain version of K5: K3's plain version
    (``lk_cell.level_track_cell_reference``). The JAX kernel says it is K3's
    iteration sequence up to float reassociation
    (``lk_pallas_block.py:37-39``), and ``tests/test_torch_lk_block.py``
    holds this function to the JAX kernel itself; its post-kernel ``active``
    mask gives what K3's in-kernel skip gives."""
    return lk_cell.level_track_cell_reference(img_prev_pad, img_next_pad, pts, guess,
                                              win, iters, eps, min_eig, search_radius,
                                              pad, active, stats)


def level_track_block(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                      pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                      iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                      search_radius: int = 6, pad: int = 0,
                      active: torch.Tensor | None = None, stats: dict | None = None):
    """One LK level for N points: the signature and return of JAX
    ``level_track_pallas_block`` without ``interpret``, plus ``stats`` (each
    point's ``iters`` and ``reloads``) as in ``lk_cell.level_track_cell``.
    Returns (flow (N, 2) = guess + found delta, ok (N,) bool)."""
    lk_v1.check_inputs(img_prev_pad, img_next_pad, pts, guess, active, win)
    if img_prev_pad.device.type == "cpu":
        return level_track_block_reference(img_prev_pad, img_next_pad, pts, guess, win,
                                           iters, eps, min_eig, search_radius, pad,
                                           active, stats)
    out = lk_v1.launch("svo_lk_level_block", img_prev_pad, img_next_pad, pts, guess, win,
                       iters, eps, min_eig, pad, active, stats, search_radius,
                       smem=cell_smem_bytes(win))
    if len(pts):
        level_track_block.launches += 1
    return out


level_track_block.launches = 0


def _split_args(mode: str, rounds: int) -> int:
    if mode not in SPLIT_MODES:
        raise ValueError(f"mode must be one of {sorted(SPLIT_MODES)}, got {mode!r}")
    if mode == "reload" and rounds < 1:
        raise ValueError(f"the reload variant needs rounds >= 1, got {rounds}")
    return rounds if mode == "reload" else 0


def level_track_block_split_reference(img_prev_pad: torch.Tensor,
                                      img_next_pad: torch.Tensor, pts: torch.Tensor,
                                      pad: int, mode: str, rounds: int = 3,
                                      win: int = 21, min_eig: float = 1e-4):
    """Plain version of K8: the template sums from
    ``lk_dense.template_phase``, then (``reload``) each forced round's 8 dots
    of the (win+1)^2 window at ``clip(floor(p - r + round))``, which ignore
    guess and flow; ``full`` is K5's plain version at the probe's operating
    point with the raw delta and gate. Returns (flow (N, 2), ok (N,)
    float32, dots (N, rounds, 8)) as ``level_track_block_split``."""
    n_rounds = _split_args(mode, rounds)
    n = pts.shape[0]
    f32 = torch.float32
    if mode == "full":
        flow, ok = level_track_block_reference(
            img_prev_pad, img_next_pad, pts, torch.zeros_like(pts), win, SPLIT_ITERS,
            SPLIT_EPS, min_eig, float("inf"), pad)
        return flow, ok.to(f32), torch.zeros((n, 0, 8), dtype=f32, device=pts.device)
    hp, wp = img_prev_pad.shape
    r = (win - 1) // 2
    py, px = pts[:, 1] + pad, pts[:, 0] + pad
    tpl = lk_dense.template_phase(img_prev_pad, py, px, win, min_eig,
                                  windows=patch.extract_windows_int_reference)
    sums = lambda a: torch.sum(a, dim=(1, 2))
    acc = (sums(tpl.Ix * tpl.Ix) + sums(tpl.Ix * tpl.Iy) + sums(tpl.Iy * tpl.Iy)
           + tpl.tIx + tpl.tIy)
    dots = torch.zeros((n, n_rounds, 8), dtype=f32, device=pts.device)
    grad = lk_dense.grad8(tpl.Ix, tpl.Iy)
    for rd in range(n_rounds):
        iy = torch.clamp(torch.floor(py - r + rd).to(torch.int32), 0, hp - win - 1)
        ix = torch.clamp(torch.floor(px - r + rd).to(torch.int32), 0, wp - win - 1)
        W = patch.extract_windows_int_reference(img_next_pad, torch.stack([iy, ix], -1),
                                                win + 1)
        dots[:, rd] = torch.bmm(W.reshape(n, 1, (win + 1) ** 2), grad)[:, 0]
    extra = dots[:, -1, 0] if n_rounds else torch.zeros_like(acc)
    return torch.stack([acc + extra, acc], dim=-1), acc.clone(), dots


def level_track_block_split(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                            pts: torch.Tensor, pad: int, mode: str, rounds: int = 3,
                            win: int = 21, min_eig: float = 1e-4):
    """K8: one variant of K5 on (Hp, Wp) levels edge-padded by ``pad``.

    ``mode`` is ``tmpl``, ``reload`` (``rounds`` >= 1 forced reloads) or
    ``full``. Returns the JAX variant's outputs: ``tmpl``/``reload`` give the
    checksums flow = (acc [+ the last round's first dot], acc) and ok = acc,
    with acc = g00 + g01 + g11 + tIx + tIy; ``full`` gives K5's raw delta and
    gate (0/1) with zero guesses, 30 iterations, eps 0.01. Also returns every
    round's 8 dots, (N, rounds, 8) (empty but for ``reload``).
    """
    n_rounds = _split_args(mode, rounds)
    lk_v1.check_inputs(img_prev_pad, img_next_pad, pts, None, None, win)
    if img_prev_pad.device.type == "cpu":
        return level_track_block_split_reference(img_prev_pad, img_next_pad, pts, pad,
                                                 mode, rounds, win, min_eig)
    lk_v1.check_launch(img_prev_pad.device, win, cell_smem_bytes(win))
    n = pts.shape[0]
    flow, ok = pts.new_empty((n, 2)), pts.new_empty(n)
    dots = pts.new_empty((n, n_rounds, 8))
    if n == 0:
        return flow, ok, dots
    prev, nxt, pts = img_prev_pad.contiguous(), img_next_pad.contiguous(), pts.contiguous()
    (hp, wp), index = prev.shape, prev.get_device()
    err = native.entry("svo_lk_block_split")(
        prev.data_ptr(), nxt.data_ptr(), hp, wp, pts.data_ptr(), None, n, win, SPLIT_ITERS,
        SPLIT_EPS * SPLIT_EPS, min_eig, pad, flow.data_ptr(), ok.data_ptr(),
        SPLIT_MODES[mode], n_rounds, dots.data_ptr(), index,
        cuda_stream.current_stream(index))
    if err != 0:
        raise RuntimeError(f"svo_lk_block_split launch failed: cudaError {err}")
    level_track_block_split.launches += 1
    return flow, ok, dots


level_track_block_split.launches = 0
