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
launches the kernel and adds one to ``level_track_v1.launches``, anything
else raises. K3 (``lk_cell``) shares this module's checks and launcher.
"""
from __future__ import annotations

import torch

from . import lk_dense, native, patch

# Shared memory a CTA may hold on Hopper (opt-in maximum).
_SMEM_LIMIT = 227 * 1024


def _smem_bytes(win: int) -> int:
    """The kernel's shared memory: the (win+3)^2 window buffer, the
    (win+2)^2 field, T/Ix/Iy and the reduction scratch (csrc/lk_level.cu)."""
    return 4 * ((win + 3) ** 2 + (win + 2) ** 2 + 3 * win * win + 4 * 8)


def check_inputs(img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
                 pts: torch.Tensor, guess: torch.Tensor,
                 active: torch.Tensor | None, win: int) -> None:
    """What K3 and K4 take: two (Hp, Wp) float32 levels, (N, 2) float32
    points and guesses, an optional (N,) bool mask, all on one device."""
    if img_prev_pad.shape != img_next_pad.shape or img_prev_pad.dim() != 2:
        raise ValueError(f"levels must be two (Hp, Wp) images of one shape, got "
                         f"{tuple(img_prev_pad.shape)} and {tuple(img_next_pad.shape)}")
    for name, t in (("img_prev_pad", img_prev_pad), ("img_next_pad", img_next_pad),
                    ("pts", pts), ("guess", guess)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    n = pts.shape[0]
    if pts.shape != (n, 2) or guess.shape != (n, 2):
        raise ValueError(f"pts and guess must be (N, 2), got {tuple(pts.shape)} "
                         f"and {tuple(guess.shape)}")
    if active is not None and (active.shape != (n,) or active.dtype != torch.bool):
        raise ValueError(f"active must be (N,) bool, got {active.dtype} "
                         f"{tuple(active.shape)}")
    tensors = [img_prev_pad, img_next_pad, pts, guess] + ([] if active is None else [active])
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


def launch(entry: str, img_prev_pad: torch.Tensor, img_next_pad: torch.Tensor,
           pts: torch.Tensor, guess: torch.Tensor, win: int, iters: int, eps: float,
           min_eig: float, pad: int, active: torch.Tensor | None,
           stats: dict | None):
    """Launch K3 or K4 (``entry``) on CUDA tensors; returns the raw
    (delta (N, 2), gate ok (N,)) and, into ``stats``, each point's
    iterations and window reloads."""
    dev = img_prev_pad.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if _smem_bytes(win) > _SMEM_LIMIT:
        raise ValueError(f"win={win} needs {_smem_bytes(win)} B of shared memory, "
                         f"more than the {_SMEM_LIMIT} B a CTA can hold")
    n = pts.shape[0]
    hp, wp = img_prev_pad.shape
    act = (torch.ones(n, dtype=torch.float32, device=dev) if active is None
           else active.to(torch.float32))
    flow_d = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty(n, dtype=torch.float32, device=dev)
    counts = torch.empty((n, 2), dtype=torch.int32, device=dev)
    prev, nxt = img_prev_pad.contiguous(), img_next_pad.contiguous()
    pts, guess = pts.contiguous(), guess.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(native.lib(), entry)(
        prev.data_ptr(), nxt.data_ptr(), hp, wp, pts.data_ptr(), guess.data_ptr(),
        act.data_ptr(), n, win, iters, eps * eps, min_eig, pad, flow_d.data_ptr(),
        ok.data_ptr(), counts.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    if stats is not None:
        stats["iters"], stats["reloads"] = counts[:, 0], counts[:, 1]
    return flow_d, ok > 0


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
    same here) and ``corners``, the (M, 2) [row, col] corners of every
    window read from the next image.
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
    corners = []
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
        run = run & (dx * dx + dy * dy > eps * eps)
    if stats is not None:
        stats.update(iters=n_it, reloads=n_it.clone(),
                     corners=torch.cat(corners) if corners else
                     torch.zeros((0, 2), dtype=i32, device=pts.device))
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
    flow_d, ok = launch("svo_lk_level_v1", img_prev_pad, img_next_pad, pts, guess,
                        win, iters, eps, min_eig, pad, active, stats)
    level_track_v1.launches += 1
    return finish(guess, flow_d, ok, search_radius)


level_track_v1.launches = 0
