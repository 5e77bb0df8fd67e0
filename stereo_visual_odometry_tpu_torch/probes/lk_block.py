"""Probe: K5 and K6, the warp-per-point LK level kernels, against K3 and K4 —
parity and time per level call.

Port of ``scripts/probe_lk_block.py`` (K5 against K3: parity, the median
error to the true shift, the time per call over a chain of R = 20 calls on
the device) and ``scripts/probe_lk_direct.py`` (the time per call issued
one by one), with K6 against K4 beside them, as the JAX K6 was measured
against K4 (``scripts/lk_pallas_v2.py:20-25``). The inputs are the JAX
probes': seeded smoothed noise (seed 7), the next frame moved by (3, 2) px,
both edge-padded by 12 px plus the 8-row / 128-column alignment (384x1280 ->
(408, 1408)), N = 1024 points, zero guesses, win 21, 30 iterations.

    python -m stereo_visual_odometry_tpu_torch.probes.lk_block      # cuda:0
    python -m stereo_visual_odometry_tpu_torch.probes.lk_block --device cpu \\
        --height 64 --width 256 --points 16

On the card each kernel is timed back to back with CUDA events and inside
one CUDA graph of R calls (its device time per call without the wrapper's
host time; the graph takes the place of the JAX on-device ``fori_loop``).
With ``--device cpu`` the wrappers run their plain versions, timed by the
host clock.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import lk_block, lk_cell, lk_v1, lk_v2
from . import timing

H, W, N, SEED = 384, 1280, 1024, 7
PAD, WIN, ITERS, RADIUS = 12, 21, 30, 6
SHIFT = (3.0, 2.0)          # the next frame's motion, (x, y) px
R = 20                      # calls per CUDA graph
LEVEL = {"cell": lk_cell.level_track_cell, "v1": lk_v1.level_track_v1,
         "block": lk_block.level_track_block, "v2": lk_v2.level_track_v2}
PAIRS = (("block", "cell"), ("v2", "v1"))  # (new kernel, the one it is held to)


def make_inputs(device, height: int = H, width: int = W, points: int = N,
                seed: int = SEED) -> dict:
    """The JAX probes' level pair, points and zero guesses on ``device``."""
    rng = np.random.default_rng(seed)
    base = rng.random((height + 64, width + 64)).astype(np.float32) * 255
    for _ in range(3):  # separable box blur, for gradients everywhere
        base = (base + np.roll(base, 1, 0) + np.roll(base, -1, 0)) / 3
        base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)) / 3
    img0 = base[32:32 + height, 32:32 + width]
    img1 = base[30:30 + height, 29:29 + width]
    pts = np.stack([rng.uniform(30, width - 30, points),
                    rng.uniform(30, height - 30, points)], -1).astype(np.float32)
    eh, ew = (-(height + 2 * PAD)) % 8, (-(width + 2 * PAD)) % 128
    pads = ((PAD, PAD + eh), (PAD, PAD + ew))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    return {"prev": to(np.pad(img0, pads, mode="edge")),
            "next": to(np.pad(img1, pads, mode="edge")),
            "pts": to(pts), "guess": to(np.zeros_like(pts))}


def run_level(name: str, inputs: dict, stats: dict | None = None):
    """One level call of kernel ``name`` at the probe's operating point."""
    return LEVEL[name](inputs["prev"], inputs["next"], inputs["pts"], inputs["guess"],
                       win=WIN, iters=ITERS, search_radius=RADIUS, pad=PAD, stats=stats)


def parity(inputs: dict) -> dict:
    """K5 against K3 and K6 against K4: ok rates, the largest flow
    difference where both keep a point, and the median error to the true
    shift. One call of each kernel."""
    out = {}
    shift = torch.tensor(SHIFT, device=inputs["pts"].device)
    for new, old in PAIRS:
        f_new, ok_new = run_level(new, inputs)
        f_old, ok_old = run_level(old, inputs)
        both = ok_new & ok_old
        d = (f_new - f_old)[both].norm(dim=-1)
        err = (f_new[both] - shift).norm(dim=-1)
        out[new] = {"against": old, "ok": float(ok_new.float().mean()),
                    "ok_against": float(ok_old.float().mean()),
                    "ok_agree": float((ok_new == ok_old).float().mean()),
                    "n_both": int(both.sum()),
                    "max_flow_diff": float(d.max()) if len(d) else 0.0,
                    "median_err": float(err.median()) if len(err) else float("nan")}
    return out


def timing_ms(inputs: dict) -> dict:
    """Per kernel: ms per call over 200 calls back to back (CUDA events) and
    in one CUDA graph of R calls; on the CPU, the host clock over 3 calls."""
    out = {}
    for name in LEVEL:
        fn = lambda name=name: run_level(name, inputs)
        if inputs["pts"].device.type == "cuda":
            out[name] = {"events_ms": timing.events_ms(fn, iters=200),
                         "graph_ms": timing.graph_ms(fn, calls=R)}
        else:
            out[name] = {"wall_ms": timing.wall_ms(fn)}
    return out


def describe(par: dict, times: dict) -> list[str]:
    lines = [f"[parity] {new} vs {p['against']}: ok {p['ok']:.3f} / {p['ok_against']:.3f} "
             f"(agree {p['ok_agree']:.4f}), max|flow diff| {p['max_flow_diff']:.2e} px "
             f"(n={p['n_both']}); [truth] median err vs {SHIFT}: {p['median_err']:.4f} px"
             for new, p in par.items()]
    for name, t in times.items():
        lines.append(f"[{name}] " + ", ".join(
            f"{k.replace('_ms', '')} {v * 1e3:.2f} us/call" for k, v in t.items()))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain versions)")
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--points", type=int, default=N)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe runs the kernels on an NVIDIA "
                           "GPU (--device cpu runs their plain versions)")
    inputs = make_inputs(device, args.height, args.width, args.points)
    for line in describe(parity(inputs), timing_ms(inputs)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
