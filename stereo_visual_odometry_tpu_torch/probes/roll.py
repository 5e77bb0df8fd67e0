"""Probe: the dynamic-roll envelope (K7).

Port of ``scripts/probe_roll.py``, which mapped where Mosaic's dynamic
rotate of a (rows, 256) block by an amount from scalar memory is right: for
axis 0 and 1 and rows 16..128, the largest error of the roll kernel against
``np.roll`` over the amounts 0, 1, 3, 7 and 9 (axis 0) or 100 (axis 1). The
same table for the CUDA kernel; ``extended=True`` adds the amounts -1, the
axis length and the axis length + 5.

    python -m stereo_visual_odometry_tpu_torch.probes.roll            # cuda:0
    python -m stereo_visual_odometry_tpu_torch.probes.roll --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import roll as roll_op

ROWS = (16, 24, 32, 40, 48, 56, 64, 128)
COLS = 256


def amounts(axis: int, size: int, extended: bool = False) -> tuple[int, ...]:
    """The probe's amounts for an axis of length ``size``."""
    base = (0, 1, 3, 7, 9 if axis == 0 else 100)
    return base + ((-1, size, size + 5) if extended else ())


def envelope(device, extended: bool = False, seed: int = 0) -> list[tuple]:
    """(axis, rows, max abs error against np.roll) over the probe's grid,
    random (rows, 256) inputs from ``seed`` as the JAX probe draws them."""
    rng = np.random.RandomState(seed)
    rows_out = []
    for axis in (0, 1):
        for rows in ROWS:
            x = rng.rand(rows, COLS).astype(np.float32)
            xt = torch.from_numpy(x).to(device)
            worst = 0.0
            for amt in amounts(axis, x.shape[axis], extended):
                a = torch.tensor([[amt]], dtype=torch.int32, device=device)
                got = roll_op.roll(xt, a, axis).cpu().numpy()
                worst = max(worst, float(np.abs(got - np.roll(x, -amt, axis=axis)).max()))
            rows_out.append((axis, rows, worst))
    return rows_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel; the default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe runs the kernel on an NVIDIA "
                           "GPU (--device cpu runs its plain version)")
    for axis, rows, worst in envelope(device):
        print(f"axis={axis} rows={rows}: max_err={worst:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
