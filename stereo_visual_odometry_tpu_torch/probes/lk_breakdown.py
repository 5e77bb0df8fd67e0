"""Probe: where an LK level call's time goes — template, window reloads,
iterations (K8).

Port of ``scripts/probe_lk_breakdown.py``: K5 cut into ``tmpl`` (the
template phase only), ``reload`` with 1 and with 3 forced reload rounds (the
template, then each round's window and 8 dots, no iterations) and ``full``
(K5), each timed over R = 30 calls inside one CUDA graph (the JAX probe's
on-device chain of 30 calls) at its operating point: the level pair, points
and zero guesses of ``probes.lk_block`` (384x1280 padded to (408, 1408),
N = 1024, win 21, 30 iterations, eps 0.01).

    python -m stereo_visual_odometry_tpu_torch.probes.lk_breakdown    # cuda:0
    python -m stereo_visual_odometry_tpu_torch.probes.lk_breakdown --device cpu \\
        --height 64 --width 256 --points 16

It prints each variant's error against its plain version and its µs per
call, then the split: the template, one reload round ((reload3 - reload1)
/ 2), and the rest of a full call (full - tmpl). With ``--device cpu`` the
wrapper runs the plain versions, timed by the host clock.
"""
from __future__ import annotations

import argparse

import torch

from ..ops import lk_block
from . import lk_block as probe_block
from . import timing

R = 30                      # calls per CUDA graph
VARIANTS = {"full": ("full", 0), "tmpl": ("tmpl", 0), "reload1": ("reload", 1),
            "reload3": ("reload", 3)}


def run_variant(label: str, inputs: dict, plain: bool = False):
    """One call of a variant (its kernel, or with ``plain`` its plain
    version) on the probe's inputs: (flow, ok, dots)."""
    mode, rounds = VARIANTS[label]
    fn = (lk_block.level_track_block_split_reference if plain
          else lk_block.level_track_block_split)
    return fn(inputs["prev"], inputs["next"], inputs["pts"], probe_block.PAD, mode,
              rounds, win=probe_block.WIN)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: the checksums' error relative to
    their scale (acc is ~1e5-1e6 at these intensities)."""
    if want.numel() == 0:
        return 0.0
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)


def check(inputs: dict) -> dict:
    """Each variant once, against its plain version: the relative and the
    absolute error of flow, ok and dots (the largest of the three), and the
    outputs of both."""
    out = {}
    for label in VARIANTS:
        got = run_variant(label, inputs)
        want = run_variant(label, inputs, plain=True)
        out[label] = {"rel_err": max(rel_err(g, w) for g, w in zip(got, want)),
                      "abs_err": max((float((g - w).abs().max()) if w.numel() else 0.0)
                                     for g, w in zip(got, want)),
                      "outputs": got, "plain": want}
    return out


def timing_ms(inputs: dict) -> dict:
    """ms per call of each variant: in one CUDA graph of R calls on the
    card, by the host clock over 3 calls on the CPU."""
    out = {}
    for label in VARIANTS:
        fn = lambda label=label: run_variant(label, inputs)
        out[label] = (timing.graph_ms(fn, calls=R) if inputs["pts"].device.type == "cuda"
                      else timing.wall_ms(fn))
    return out


def split(times: dict) -> dict:
    """The call split: template, one reload round, and the rest of a full
    call (its reloads and iterations), in the unit of ``times``."""
    return {"template": times["tmpl"],
            "reload_round": (times["reload3"] - times["reload1"]) / 2,
            "full_minus_template": times["full"] - times["tmpl"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain versions)")
    ap.add_argument("--height", type=int, default=probe_block.H)
    ap.add_argument("--width", type=int, default=probe_block.W)
    ap.add_argument("--points", type=int, default=probe_block.N)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe runs the kernels on an NVIDIA "
                           "GPU (--device cpu runs their plain versions)")
    inputs = probe_block.make_inputs(device, args.height, args.width, args.points)
    clock = "CUDA graph" if device.type == "cuda" else "host clock"
    checks, times = check(inputs), timing_ms(inputs)
    for label, t in times.items():
        print(f"[{label:7s}] {t * 1e3:.2f} us/call ({clock}), rel err vs plain "
              f"{checks[label]['rel_err']:.2e}", flush=True)
    print("[split] " + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in split(times).items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
