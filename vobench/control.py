"""The control of ``correct``, a planted kernel fault, and the program's
readings, over many seeds in one process, at a cell's own size.

    python -m vobench.control --workload orb.offline_s1 --seconds 30 \
        --seeds 11 12 13 --control-seeds 21 22 23 --fault-seeds 31 32 33 --short 10

Each seed is one run of the cell as ``vobench.run`` runs it (untraced), on
one lap rendered for them all, and prints one JSON line with the compared
numbers (``numbers``):

* ``--seeds``: the program as it ships (the lower readings), for
  ``--seconds``; beside its numbers, ``pose_control``: the same frames
  judged with the reference's answers rounded to bfloat16
  (``reference.control_chain``);
* ``--control-seeds``: the kernels' control, K1 and K2 worked out by the
  plain reference in bfloat16 (``reference.windows`` / ``patches``) and put
  in the kernels' place, for ``--short`` seconds;
* ``--fault-seeds``: a planted kernel fault, the float32 reference in the
  kernels' place with the last row of every window and patch a copy of the
  row above it, for ``--short`` seconds.

The benchmark's own runs never run this; the limits in ``limits/`` are set
from its lines (PERF.md). Needs the cell's cards.
"""
from __future__ import annotations

import argparse
import json
import sys

from .arith import percentile
from .run import cell_spec, run_cell, set_caches


def bf16_kernels() -> dict:
    """K1 and K2 as the plain reference computes them in bfloat16."""
    import torch

    from . import reference
    return {"k1": lambda imgs, corners, sh, sw: reference.windows(
                imgs, corners, sh, sw, dtype=torch.bfloat16).to(torch.float32),
            "k2": lambda imgs, centers, P: reference.patches(
                imgs, centers, P, dtype=torch.bfloat16).to(torch.float32)}


def edge_fault_kernels() -> dict:
    """K1 and K2 in float32 with each window's and patch's last row a copy
    of the row above it: a kernel that loses one row of what it reads."""
    import torch

    from . import reference

    def last_row_lost(out):
        out = out.clone()
        out[..., -1, :] = out[..., -2, :]
        return out
    return {"k1": lambda imgs, corners, sh, sw: last_row_lost(reference.windows(
                imgs, corners, sh, sw, dtype=torch.float32)),
            "k2": lambda imgs, centers, P: last_row_lost(reference.patches(
                imgs, centers, P, dtype=torch.float32))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--short", type=float, default=None,
                    help="the window of the control and fault runs (default --seconds)")
    args = ap.parse_args(argv)
    set_caches()
    import torch

    from stereo_visual_odometry_tpu_torch.parallel import sequences

    from . import reference, render, trace
    spec = cell_spec(args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vobench.control: {args.workload} needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    traffic = spec["traffic"]
    S, n = traffic.get("sequences", 1), traffic["circuit"]["lap_frames"]
    extra = traffic["frames_per_sequence"] + n // S if S > 1 else 0
    lap = render.render_lap(traffic["circuit"], spec["config"]["sensor"], devices[0],
                            extra=extra)
    runs = ([("program", s, {}) for s in args.seeds]
            + [("bf16", s, bf16_kernels()) for s in args.control_seeds]
            + [("edge", s, edge_fault_kernels()) for s in args.fault_seeds])
    for put, seed, swap in runs:
        seconds = args.seconds if put == "program" else (args.short or args.seconds)
        sequences.clear()              # each run captures its own step graph
        run = run_cell(args.workload, seed, seconds, False, devices, lap=lap,
                       calls=trace.KernelCalls(**swap))
        line = {"workload": args.workload, "seed": seed, "put": put, "correct": run["correct"],
                "frames": run["frames"], "window_s": run["window_s"], "failed": run["failed"],
                "setup_s": run["setup_s"], "numbers": run["numbers"],
                "latency_p95_ms": (1e3 * percentile(run["latencies_s"], 95)
                                   if run.get("latencies_s") else None)}
        if put == "program":
            control = [(frames, reference.control_chain(run["lap_poses"], frames))
                       for frames, _ in run["pieces"]]
            line["pose_control"] = reference.judge(control, run["lap_poses"])
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
