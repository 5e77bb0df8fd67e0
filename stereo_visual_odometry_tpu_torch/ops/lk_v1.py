"""K4: the per-iteration LK level kernel (``lk_kernel='v1'``).

Port of ``lk_pallas.level_track_pallas``
(``stereo_visual_odometry_tpu/ops/lk_pallas.py:164-214``). One pyramid level
of LK for N points: the template phase of the dense tracker, then up to
``iters`` iterations per point, each reloading the (win+1)^2 window of the
next image at the point's clipped corner, blending it at the point's
fraction and taking ``sum((T - w) * Ix)`` and ``sum((T - w) * Iy)``; a point
stops when its step is at most ``eps``. No convergence gate: a point still
iterating after ``iters`` keeps its ok, as the JAX kernel.

CUDA kernel ``csrc/lk_level.cu`` (entry ``svo_lk_level_v1``), plain version
``level_track_v1_reference``. The wrapper routes by the tensors' device as
``patch.py`` does: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel and adds one to ``level_track_v1.launches`` (N = 0
launches and counts nothing), anything else raises. K3 (``lk_cell``), K5
and K6 (``lk_block``, ``lk_v2``) share this module's checks and launcher,
and K8 its checks.

The kernel does the JAX wrapper's tail itself (``finish``: flow = guess +
delta and ok = gate with the search-radius test), reads ``active`` as the
caller's bool bytes and writes the statistics only when asked, so a level
call is one CUDA kernel and nothing else: eager it saves six small
launches, in a CUDA graph six nodes (PERF.md). ``finish`` stays the
definition that the plain versions apply; the kernel does the same float
add and compares, so its outputs are bit for bit those of its delta
finished here.
"""
from __future__ import annotations

import torch

from . import cuda_stream, lk_dense, native, patch

# Shared memory a CTA may hold on Hopper (opt-in maximum).
_SMEM_LIMIT = 227 * 1024
# csrc/lk_level.cu's threads per CTA and the margin (px) of the region of the
# next image it stages around the window at the guess.
THREADS, STAGE_MARGIN = 64, 7


def _smem_bytes(win: int) -> int:
    """K3/K4's shared memory (csrc/lk_level.cu): the (win+3)^2 window
    buffer, the staged region of the next image, the (win+2)^2 field,
    T/Ix/Iy and the reduction scratch."""
    side = win + 1 + 2 * STAGE_MARGIN
    return 4 * ((win + 3) ** 2 + side * side + (win + 2) ** 2 + 3 * win * win
                + (THREADS // 32) * 8)


def staged_share(pts: torch.Tensor, guess: torch.Tensor, stats: dict, hp: int, wp: int,
                 win: int = 21, pad: int = 0, margin: int = STAGE_MARGIN) -> float:
    """The share of window reloads that K3/K4 read from the region they
    stage (``margin`` px around the window at the guess, clipped to the
    level), given a plain version's ``stats`` on the same inputs: its
    ``corners`` and the ``points`` they belong to. 1.0 when nothing was
    reloaded."""
    if len(stats["corners"]) == 0:
        return 1.0
    return float(staged(pts, guess, stats, hp, wp, win, pad, margin).float().mean())


def staged(pts: torch.Tensor, guess: torch.Tensor, stats: dict, hp: int, wp: int,
           win: int = 21, pad: int = 0, margin: int = STAGE_MARGIN) -> torch.Tensor:
    """Per reload in ``stats`` (a plain version's ``corners`` and
    ``points``), whether its window lies in the staged region."""
    corners, owners = stats["corners"], stats["points"]
    r = (win - 1) // 2
    side = win + 1 + 2 * margin
    rh, rw = min(side, hp), min(side, wp)
    p, g = pts[owners] + pad, guess[owners]
    ry = torch.clamp(torch.floor(p[:, 1] + g[:, 1] - r).long(), 0, hp - win - 1) - margin
    rx = torch.clamp(torch.floor(p[:, 0] + g[:, 0] - r).long(), 0, wp - win - 1) - margin
    ry, rx = torch.clamp(ry, 0, hp - rh), torch.clamp(rx, 0, wp - rw)
    iy, ix = corners[:, 0].long(), corners[:, 1].long()
    return (iy >= ry) & (iy + win + 1 <= ry + rh) & (ix >= rx) & (ix + win + 1 <= rx + rw)


def check_inputs(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                 pts: torch.Tensor, guess: torch.Tensor | None,
                 active: torch.Tensor | None, win: int) -> None:
    """What K3-K6 and K8 take: two (Hp, Wp) float32 levels, (N, 2) float32
    points and guesses (K8: none), an optional (N,) bool mask, all on one
    device."""
    if img_prev_pad.shape != img_next_pad.shape or img_prev_pad.dim() != 2:
        raise ValueError(f"levels must be two (Hp, Wp) images of one shape, got "
                         f"{tuple(img_prev_pad.shape)} and {tuple(img_next_pad.shape)}")
    points = [("pts", pts)] + ([] if guess is None else [("guess", guess)])
    for name, t in [("img_prev_pad", img_prev_pad), ("img_next_pad", img_next_pad), *points]:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    n = pts.shape[0]
    if any(t.shape != (n, 2) for _, t in points):
        raise ValueError(f"pts and guess must be (N, 2), got "
                         f"{[tuple(t.shape) for _, t in points]}")
    if active is not None and (active.shape != (n,) or active.dtype != torch.bool):
        raise ValueError(f"active must be (N,) bool, got {active.dtype} "
                         f"{tuple(active.shape)}")
    tensors = ([img_prev_pad, img_next_pad] + [t for _, t in points]
               + ([] if active is None else [active]))
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on several devices: {[str(t.device) for t in tensors]}")
    hp, wp = img_prev_pad.shape
    if win < 1 or min(hp, wp) < win + 3:
        raise ValueError(f"window win={win} does not fit the padded level {(hp, wp)}")


def finish(guess: torch.Tensor, flow_d: torch.Tensor, ok: torch.Tensor,
           search_radius: int):
    """The JAX wrappers' tail: flow = guess + delta, ok only with
    |delta| <= search_radius on both axes."""
    inside = torch.all(torch.abs(flow_d) <= search_radius, dim=-1)
    return guess + flow_d, ok & inside


def check_launch(device: torch.device, win: int, smem: int) -> None:
    """Raise unless a kernel of ``smem`` B of shared memory per CTA can
    launch on ``device``."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"win={win} needs {smem} B of shared memory, "
                         f"more than the {_SMEM_LIMIT} B a CTA can hold")


def launch(entry: str, img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
           pts: torch.Tensor, guess: torch.Tensor, win: int, iters: int, eps: float,
           min_eig: float, pad: int, active: torch.Tensor | None,
           stats: dict | None, search_radius: float, smem: int | None = None):
    """Launch an LK level kernel (K3-K6) on CUDA tensors through the lean
    path (``native.entry``, the raw current stream); with N = 0 it launches
    nothing and returns empty outputs. The kernel finishes the level: it
    returns (flow (N, 2) = guess + delta, ok (N,) bool: the gate and the
    ``search_radius`` test). ``smem`` is the kernel's shared memory per CTA
    (K3/K4's by default). ``stats``, if given, receives each point's
    iterations and window reloads."""
    smem = _smem_bytes(win) if smem is None else smem
    check_launch(img_prev_pad.device, win, smem)
    n = pts.shape[0]
    flow = pts.new_empty((n, 2))
    ok = pts.new_empty(n, dtype=torch.bool)
    counts = None if stats is None else pts.new_empty((n, 2), dtype=torch.int32)
    if stats is not None:
        stats["iters"], stats["reloads"] = counts[:, 0], counts[:, 1]
    if n == 0:
        return flow, ok
    prev, nxt = img_prev_pad.contiguous(), img_next_pad.contiguous()
    pts, guess = pts.contiguous(), guess.contiguous()
    act = None if active is None else active.contiguous().data_ptr()
    hp, wp = prev.shape
    index = prev.get_device()
    err = native.entry(entry)(
        prev.data_ptr(), nxt.data_ptr(), hp, wp, pts.data_ptr(), guess.data_ptr(), act, n,
        win, iters, eps * eps, min_eig, pad, search_radius, flow.data_ptr(), ok.data_ptr(),
        None if counts is None else counts.data_ptr(), index,
        cuda_stream.current_stream(index))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return flow, ok


def reload_log(corners: list, owners: list, pts: torch.Tensor) -> dict:
    """The plain versions' record of the windows they read: ``corners``
    (M, 2) int32 and the ``points`` (M,) they belong to."""
    if not corners:
        return {"corners": torch.zeros((0, 2), dtype=torch.int32, device=pts.device),
                "points": torch.zeros(0, dtype=torch.long, device=pts.device)}
    return {"corners": torch.cat(corners), "points": torch.cat(owners)}


def level_track_v1_reference(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                             pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                             iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                             search_radius: int = 6, pad: int = 0,
                             active: torch.Tensor | None = None,
                             stats: dict | None = None):
    """Plain version of K4, batched over the N points: up to ``iters``
    steps, each reloading every running point's window with K1's plain
    version; a point leaves the batch when its step is at most ``eps``.

    ``stats``, if given, receives per point ``iters`` and ``reloads`` (the
    same here), ``corners``, the (M, 2) [row, col] corners of every window
    read from the next image, and ``points``, the (M,) point of each.
    """
    hp, wp = img_prev_pad.shape
    r = (win - 1) // 2
    i32 = torch.int32
    py, px = pts[:, 1] + pad, pts[:, 0] + pad
    gy, gx = guess[:, 1], guess[:, 0]
    tpl = lk_dense.template_phase(img_prev_pad, py, px, win, min_eig,
                                  windows=patch.extract_windows_int_reference)
    ok = tpl.ok if active is None else tpl.ok & active
    run = ok.clone()
    vy, vx = torch.zeros_like(py), torch.zeros_like(px)
    n_it = torch.zeros(pts.shape[0], dtype=i32, device=pts.device)
    index = torch.arange(pts.shape[0], device=pts.device)
    corners, owners = [], []
    for _ in range(iters):
        if not bool(run.any()):
            break
        br = py + gy + vy - r
        bc = px + gx + vx - r
        iy = torch.clamp(torch.floor(br).to(i32), 0, hp - win - 1)
        ix = torch.clamp(torch.floor(bc).to(i32), 0, wp - win - 1)
        corner = torch.stack([iy, ix], dim=-1)
        sub = patch.extract_windows_int_reference(img_next_pad, corner, win + 1)
        rdiff = tpl.T - lk_dense._blend4_batch(sub, br - iy.to(torch.float32),
                                               bc - ix.to(torch.float32))
        b0 = torch.sum(rdiff * tpl.Ix, dim=(1, 2))
        b1 = torch.sum(rdiff * tpl.Iy, dim=(1, 2))
        dx = tpl.inv00 * b0 + tpl.inv01 * b1
        dy = tpl.inv01 * b0 + tpl.inv11 * b1
        vx = torch.where(run, vx + dx, vx)
        vy = torch.where(run, vy + dy, vy)
        n_it += run.to(i32)
        if stats is not None:
            corners.append(corner[run])
            owners.append(index[run])
        run = run & (dx * dx + dy * dy > eps * eps)
    if stats is not None:
        stats.update(iters=n_it, reloads=n_it.clone(), **reload_log(corners, owners, pts))
    return finish(guess, torch.stack([vx, vy], dim=-1), ok, search_radius)


def level_track_v1(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                   pts: torch.Tensor, guess: torch.Tensor, win: int = 21,
                   iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4,
                   search_radius: int = 6, pad: int = 0,
                   active: torch.Tensor | None = None, stats: dict | None = None):
    """One LK level for N points on (Hp, Wp) levels edge-padded by ``pad``.

    Args:
      pts: (N, 2) [x, y] level coordinates (unpadded frame).
      guess: (N, 2) incoming flow.
      active: optional (N,) bool; inactive points are skipped (flow = guess,
        ok False).
      stats: optional dict that receives each point's ``iters`` and
        ``reloads``.
    Returns: (flow (N, 2) = guess + found delta, ok (N,) bool).
    """
    check_inputs(img_prev_pad, img_next_pad, pts, guess, active, win)
    if img_prev_pad.device.type == "cpu":
        return level_track_v1_reference(img_prev_pad, img_next_pad, pts, guess, win,
                                        iters, eps, min_eig, search_radius, pad,
                                        active, stats)
    out = launch("svo_lk_level_v1", img_prev_pad, img_next_pad, pts, guess, win, iters,
                 eps, min_eig, pad, active, stats, search_radius)
    if len(pts):
        level_track_v1.launches += 1
    return out


level_track_v1.launches = 0
