"""The control of the window-solve check, a planted fault, and the program's
readings, over many seeds in one process, at the cell's own size.

    python -m vobench.control_ba --workload lk_ba.seq_s1 --seconds 30 \
        --seeds 11 12 13 --control-seeds 21 22 23 --fault-seeds 31 32 33 \
        --undecayed-seeds 41 42 43 --short 10

Each seed is one run of the cell as ``vobench.run`` runs it (untraced), on
one lap rendered for them all, and prints one JSON line with the compared
numbers (``numbers``):

* ``--seeds``: the program as it ships (the lower readings), for
  ``--seconds``;
* ``--control-seeds``: the control, the plain reference's solve
  (``reference_ba``) worked out in bfloat16, the precision below the
  program's float32, put in the timed solve's place, for ``--short``
  seconds;
* ``--fault-seeds``: a planted fault, the program's own solve with the
  marginalization prior left out of one solve in every four (so that one
  of the four solves checked lacks it), for ``--short`` seconds;
* ``--undecayed-seeds``: a planted fault in the prior's build, the
  program's backend carrying its prior undecayed (``prior_decay`` 1) while
  the check holds it to the configuration's, for ``--short`` seconds.

The benchmark's own runs never run this; the ``ba_*`` limits in
``limits/lk_ba.seq_s1.json`` are set from its lines (PERF.md). Needs the
cell's cards.
"""
from __future__ import annotations

import argparse
import json
import sys

from .run import cell_spec, run_cell, set_caches
from .trace import KernelCalls


class SolveCalls(KernelCalls):
    """``KernelCalls`` that also hands ``run_frames`` a function, ``ba(solve,
    **problem)``, to put in the timed window solve's place, and ``backend``,
    ``BackendConfig`` fields to change in the program only."""

    def __init__(self, ba=None, backend=None, **kernels):
        super().__init__(**kernels)
        self.ba = ba
        self.backend = backend or {}


def bf16_solve(solve, **problem) -> dict:
    """The reference's solve in bfloat16, its outputs as the program's
    (float32 tensors, int32 counts, on the problem's device)."""
    import torch

    from . import reference_ba
    out = reference_ba.bundle_adjust(**problem, dtype=torch.bfloat16)
    dev = problem["poses"].device
    return {k: torch.as_tensor(v, device=dev).to(
                torch.int32 if k.startswith("lm_") else torch.float32)
            for k, v in out.items()}


class DroppedPrior:
    """The program's solve with the prior left out of every fourth call."""

    def __init__(self):
        self.calls = 0

    def __call__(self, solve, **problem):
        self.calls += 1
        if self.calls % 4 == 0:
            problem = dict(problem, prior=None)
        return solve(**problem)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="lk_ba.seq_s1")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--undecayed-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--short", type=float, default=None,
                    help="the window of the control and fault runs (default --seconds)")
    args = ap.parse_args(argv)
    set_caches()
    import torch

    from . import render
    spec = cell_spec(args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vobench.control_ba: {args.workload} needs {chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    lap = render.render_lap(spec["traffic"]["circuit"], spec["config"]["sensor"], devices[0])
    runs = ([("program", s, SolveCalls()) for s in args.seeds]
            + [("bf16", s, SolveCalls(ba=bf16_solve)) for s in args.control_seeds]
            + [("no_prior", s, SolveCalls(ba=DroppedPrior())) for s in args.fault_seeds]
            + [("undecayed", s, SolveCalls(backend={"prior_decay": 1.0}))
               for s in args.undecayed_seeds])
    for put, seed, calls in runs:
        seconds = args.seconds if put == "program" else (args.short or args.seconds)
        run = run_cell(args.workload, seed, seconds, False, devices, lap=lap,
                       calls=calls)
        line = {"workload": args.workload, "seed": seed, "put": put, "correct": run["correct"],
                "frames": run["frames"], "window_s": run["window_s"], "failed": run["failed"],
                "setup_s": run["setup_s"], "solves_per_frame": run["solves_per_frame"],
                "numbers": run["numbers"]}
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
