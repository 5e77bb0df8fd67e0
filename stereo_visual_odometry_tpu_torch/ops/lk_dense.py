"""Dense LK level tracker: K1 window reads + batched tensor math.

Port of ``stereo_visual_odometry_tpu/ops/lk_dense.py``. K1
(``patch.extract_windows_int``) gathers each point's (S, S) integer-corner
window; everything else is batched over all N points: the template and its
central-difference gradients from one (win+3)^2 window, the min-eigenvalue
gate, then R rounds of (reload a (win+1)^2 window, 8 dots against the
gradient stack) each followed by K inner iterations of (N,)-shaped updates
through the bilinear-form identity. A point that crosses a pixel cell
mid-round freezes until the next round's reload.

Rounds, inner iterations, clipping against the padded extents and the
convergence gate (a point still active after the last round fails) are the
JAX ones, matched rather than changed. ``template_phase`` and ``grad8`` are
shared with the plain versions of K3 and K4 (``lk_cell``, ``lk_v1``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import patch


def _blend4_batch(sub: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """(N, S, S) windows + (N,) fractions -> (N, S-1, S-1) bilinear fields."""
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    a = sub[:, :-1, :-1]
    b = sub[:, :-1, 1:]
    c = sub[:, 1:, :-1]
    d = sub[:, 1:, 1:]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx +
            c * fy * (1 - fx) + d * fy * fx)


def _pad8(x: torch.Tensor, off_r: int, off_c: int) -> torch.Tensor:
    """Place (N, win, win) at offset (off_r, off_c) inside (N, win+1, win+1)."""
    return F.pad(x, (off_c, 1 - off_c, off_r, 1 - off_r))


def grad8(Ix: torch.Tensor, Iy: torch.Tensor) -> torch.Tensor:
    """The gradient stack for the 8 bilinear-form dots, (N, (win+1)^2, 8):
    a (win+1)^2 window dotted with it gives sum(a..d * Ix), sum(a..d * Iy)
    for its four corner sub-patches a..d."""
    n, win = Ix.shape[0], Ix.shape[-1]
    return torch.stack([
        _pad8(Ix, 0, 0), _pad8(Ix, 0, 1), _pad8(Ix, 1, 0), _pad8(Ix, 1, 1),
        _pad8(Iy, 0, 0), _pad8(Iy, 0, 1), _pad8(Iy, 1, 0), _pad8(Iy, 1, 1),
    ], dim=-1).reshape(n, (win + 1) * (win + 1), 8)


class Template(NamedTuple):
    """A level's template side: patch, gradients, gate and inverse normal
    matrix, and the template dots of the bilinear right-hand side."""
    T: torch.Tensor
    Ix: torch.Tensor
    Iy: torch.Tensor
    ok: torch.Tensor
    inv00: torch.Tensor
    inv01: torch.Tensor
    inv11: torch.Tensor
    tIx: torch.Tensor
    tIy: torch.Tensor


def template_phase(img_prev_pad: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                   win: int, min_eig: float, windows=None) -> Template:
    """Template, central-difference gradients and min-eigenvalue gate of N
    points at padded-level positions (py, px), from one (win+3)^2 window
    each (read with ``windows``: K1 by default, or its plain version) blended
    at the point's fraction — the template phase of the JAX kernels."""
    windows = windows or patch.extract_windows_int
    hp, wp = img_prev_pad.shape
    r = (win - 1) // 2
    tbr = py - r - 1.0
    tbc = px - r - 1.0
    tr0 = torch.clamp(torch.floor(tbr).to(torch.int32), 0, hp - win - 3)
    tc0 = torch.clamp(torch.floor(tbc).to(torch.int32), 0, wp - win - 3)
    tfy = tbr - tr0.to(torch.float32)
    tfx = tbc - tc0.to(torch.float32)
    sub_t = windows(img_prev_pad, torch.stack([tr0, tc0], dim=-1), win + 3)
    field = _blend4_batch(sub_t, tfy, tfx)              # (N, win+2, win+2)
    T = field[:, 1:-1, 1:-1]
    Ix = (field[:, 1:-1, 2:] - field[:, 1:-1, :-2]) * 0.5
    Iy = (field[:, 2:, 1:-1] - field[:, :-2, 1:-1]) * 0.5

    g00 = torch.sum(Ix * Ix, dim=(1, 2))
    g01 = torch.sum(Ix * Iy, dim=(1, 2))
    g11 = torch.sum(Iy * Iy, dim=(1, 2))
    det = g00 * g11 - g01 * g01
    trc = g00 + g11
    mev = (trc - torch.sqrt(torch.clamp(trc * trc - 4 * det, min=0.0))) * 0.5 / (win * win)
    safe_det = torch.where(torch.abs(det) < 1e-12, 1.0, det)
    return Template(T, Ix, Iy, mev > min_eig, g11 / safe_det, -g01 / safe_det,
                    g00 / safe_det, torch.sum(T * Ix, dim=(1, 2)),
                    torch.sum(T * Iy, dim=(1, 2)))


def level_track_dense(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                      pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                      iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                      search_radius: int = 6, pad: int = 0, rounds: int = 4,
                      active: torch.Tensor | None = None):
    """One pyramid level of LK for N points on padded level images.

    Args:
      img_prev_pad / img_next_pad: (Hp, Wp) float32, the level images
        edge-padded by ``pad`` (plus the bottom/right alignment pad).
      pts: (N, 2) [x, y] level coordinates (unpadded); guess: (N, 2) flow.
      active: optional (N,) bool; inactive points do no iterations.
    Returns: (flow (N, 2) measured from zero, i.e. guess + delta; ok (N,)).
    """
    n = pts.shape[0]
    hp, wp = img_prev_pad.shape
    r = (win - 1) // 2
    f32 = torch.float32
    i32 = torch.int32

    py = (pts[:, 1] + pad).to(f32)
    px = (pts[:, 0] + pad).to(f32)
    gy = guess[:, 1].to(f32)
    gx = guess[:, 0].to(f32)

    tpl = template_phase(img_prev_pad, py, px, win, min_eig)
    ok = tpl.ok if active is None else tpl.ok & active
    inv00, inv01, inv11, tIx, tIy = tpl.inv00, tpl.inv01, tpl.inv11, tpl.tIx, tpl.tIy
    Fn = (win + 1) * (win + 1)
    grad = grad8(tpl.Ix, tpl.Iy)

    act = ok.to(f32)
    vy = torch.zeros_like(py)
    vx = torch.zeros_like(px)
    k_inner = max(8, -(-iters // rounds))

    for _ in range(rounds):
        iy = torch.clamp(torch.floor(py + gy + vy - r).to(i32), 0, hp - win - 1)
        ix = torch.clamp(torch.floor(px + gx + vx - r).to(i32), 0, wp - win - 1)
        W = patch.extract_windows_int(img_next_pad, torch.stack([iy, ix], dim=-1),
                                      win + 1)          # (N, S, S)
        dots = torch.bmm(W.reshape(n, 1, Fn), grad)[:, 0]  # (N, 8)
        sIxa, sIxb, sIxc, sIxd = dots[:, 0], dots[:, 1], dots[:, 2], dots[:, 3]
        sIya, sIyb, sIyc, sIyd = dots[:, 4], dots[:, 5], dots[:, 6], dots[:, 7]
        iyf = iy.to(f32)
        ixf = ix.to(f32)
        stay = torch.ones_like(act)
        for _ in range(k_inner):
            fy = (py + gy + vy - r) - iyf
            fx = (px + gx + vx - r) - ixf
            wy0 = 1.0 - fy
            wx0 = 1.0 - fx
            wIx = (wy0 * wx0 * sIxa + wy0 * fx * sIxb +
                   fy * wx0 * sIxc + fy * fx * sIxd)
            wIy = (wy0 * wx0 * sIya + wy0 * fx * sIyb +
                   fy * wx0 * sIyc + fy * fx * sIyd)
            b0 = tIx - wIx
            b1 = tIy - wIy
            dx = inv00 * b0 + inv01 * b1
            dy = inv01 * b0 + inv11 * b1
            m = act * stay
            vx = vx + dx * m
            vy = vy + dy * m
            act = act * torch.where(m > 0, (dx * dx + dy * dy > eps * eps).to(f32), 1.0)
            iy2 = torch.clamp(torch.floor(py + gy + vy - r).to(i32), 0, hp - win - 1)
            ix2 = torch.clamp(torch.floor(px + gx + vx - r).to(i32), 0, wp - win - 1)
            stay = stay * ((iy2 == iy) & (ix2 == ix)).to(f32)

    flow_d = torch.stack([vx, vy], dim=-1)
    flow = guess + flow_d
    inside = torch.all(torch.abs(flow_d) <= search_radius, dim=-1)
    # Convergence gate: still active after the last round -> failed.
    converged = act == 0.0
    return flow, ok & inside & converged
