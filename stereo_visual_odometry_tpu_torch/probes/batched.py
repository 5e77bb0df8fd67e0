"""Probe: S sequences in one batched step graph against one sequence.

For LK dense and ``lk_kernel='cell'`` at full width (the bench sequence,
384x1280, 1024 features), each S of ``--sizes`` in turns with the unbatched
``System`` graph: the same frames for every sequence, each with its own
draws (the JAX bench's ``bench_tpu_batched``, ``bench.py:358-397``, whose
numbers are TPU figures). Per run: aggregate frames/s (tracked frames of
all S sequences over the wall time), ms per batched frame, nodes per
replay, device-busy ms and idle share of one profiled replay, the
kernels' launches per replay, and the peak device memory; then the largest
S that fits, doubling S on a few frames until the card runs out of memory
or ``--max-fit``.

    python -m stereo_visual_odometry_tpu_torch.probes.batched
    python -m stereo_visual_odometry_tpu_torch.probes.batched --sizes 1 4 --frames 17

One JSON line per run, then a summary line. Runs on the card; without a GPU
it raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

H, W, FEATURES = 384, 1280, 1024


def profile_replay(launch, tries: int = 3) -> dict:
    """One profiled call of ``launch`` (a graph replay) from an idle device:
    device ops (nodes), busy ms and the host's wall ms. A profile that
    recorded no device op (CUPTI now and then records nothing) is taken
    again, up to ``tries`` times."""
    from ..utils import profiling
    act, wall = {"ops": 0, "busy_ms": 0.0, "span_ms": 0.0, "names": {}}, 0.0
    for _ in range(tries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.trace(None) as prof:
            launch()
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        act = profiling.device_activity(prof)
        if act["ops"]:
            break
    return {"nodes": act["ops"], "busy_ms": act["busy_ms"], "wall_ms": wall}


def run_batched(vo, cam, il, ir, S: int, chunk: int = 8, kernels=None) -> dict:
    """``evaluate.evaluate_batch`` of S copies of the frames ``il``, ``ir``
    (T, H, W) on cuda, the batched step from its CUDA graph, captured first
    by an evaluation of the first two frames (so the run's wall time holds
    no capture); with ``kernels`` (name -> wrapper), their launch counts set
    to 0 just before the run and read just after. Returns the run's dict
    with ``launches``, ``graph`` (the batched ``StepGraph``),
    ``ms_batched_frame`` and ``peak_gb``."""
    from ..parallel import evaluate, sequences
    from ..utils.config import rig_from_config
    rig = rig_from_config(cam, device="cuda")
    batch = lambda a: np.broadcast_to(a[None], (S,) + a.shape)
    torch.cuda.reset_peak_memory_stats()
    evaluate.evaluate_batch(batch(il[:2]), batch(ir[:2]), np.full(S, 2), vo, rig,
                            chunk=chunk, device="cuda")
    if kernels:
        for fn in kernels.values():
            fn.launches = 0
    out = evaluate.evaluate_batch(batch(il), batch(ir), np.full(S, len(il)), vo, rig,
                                  chunk=chunk, device="cuda")
    out["launches"] = {k: fn.launches for k, fn in (kernels or {}).items()}
    out["graph"] = sequences.batched_frontend(vo, rig, S)[1].graph(S)
    out["ms_batched_frame"] = 1e3 * out["wall_s"] / (len(il) - 1)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def run_single(vo, cam, il, ir, chunk: int = 8) -> dict:
    """One sequence through ``System.run_chunked`` on its (unbatched) step
    graph: frames/s and ms per frame over the frames after the first chunk
    (which holds the capture), and the ``System``."""
    from ..models.system import System
    from ..utils.config import RunConfig
    sys_ = System(RunConfig(camera=cam, vo=vo), device="cuda")
    sys_.run_chunked(list(zip(il, ir)), chunk=chunk)
    steady = [m["time_s"] for m in sys_.metrics[1 + chunk:]]
    tracked = [m for m in sys_.metrics if not m["init"]]
    return {"frames_per_s": len(steady) / sum(steady),
            "ms_batched_frame": 1e3 * sum(steady) / len(steady),
            "accept": float(np.mean([m["accept"] for m in tracked])), "system": sys_}


def describe(tag: str, r: dict, prof: dict) -> dict:
    """The JSON numbers of one run and its profiled replay."""
    ms = r["ms_batched_frame"]
    return {"run": tag, "frames_per_s": r["frames_per_s"], "ms_batched_frame": ms,
            "nodes": prof["nodes"], "busy_ms": prof["busy_ms"],
            "idle_share": 1.0 - prof["busy_ms"] / ms, "replay_wall_ms": prof["wall_ms"]}


def largest_fit(vo, cam, il, ir, start: int, limit: int) -> dict:
    """Double S from ``start`` on the first frames until a run raises
    ``torch.cuda.OutOfMemoryError`` or S passes ``limit``: the largest S
    that ran, and the peak memory of each."""
    from ..parallel import sequences
    peaks, S, fit = {}, start, None
    while S <= limit:
        try:
            r = run_batched(vo, cam, il, ir, S)
        except torch.cuda.OutOfMemoryError:
            break
        peaks[S] = r["peak_gb"]
        fit = S
        del r
        sequences.clear()
        torch.cuda.empty_cache()
        S *= 2
    return {"largest_s": fit, "out_of_memory_at": S if S <= limit else None,
            "peak_gb": peaks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--kernels", nargs="+", default=["dense", "cell"])
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--max-fit", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the batched probe needs an NVIDIA GPU; torch.cuda.is_available() "
                           "is False")
    from ..models.frontend import VOConfig
    from ..models.step_graph import KERNELS
    from ..parallel import sequences
    from .lk_timing import bench_sequence
    il, ir, _, cam = bench_sequence(args.frames)
    kernels = {fn.__name__: fn for fn in KERNELS}
    summary = {}
    for name in args.kernels:
        vo = VOConfig(height=H, width=W, max_features=FEATURES, lk_kernel=name)
        rows = []
        for S in args.sizes:
            single = run_single(vo, cam, il, ir)
            prof = profile_replay(single["system"].graph.launch)
            rows.append(dict(describe("system", single, prof), S=1,
                             launches_per_replay=single["system"].graph.per_replay))
            del single
            r = run_batched(vo, cam, il, ir, S, kernels=kernels)
            prof = profile_replay(r["graph"].launch)
            rows.append(dict(describe("batched", r, prof), S=S,
                             launches_per_replay=r["graph"].per_replay,
                             launches=r["launches"], peak_gb=r["peak_gb"],
                             accept=r["accept_rate"]))
            del r
            sequences.clear()
            torch.cuda.empty_cache()
            for row in rows[-2:]:
                print(json.dumps(dict(row, lk_kernel=name)), flush=True)
        fit = largest_fit(vo, cam, il[:4], ir[:4], max(args.sizes) * 2, args.max_fit)
        summary[name] = {"rows": [{k: row[k] for k in ("run", "S", "frames_per_s",
                                                       "ms_batched_frame", "nodes",
                                                       "idle_share")} for row in rows],
                         "fit": fit}
    print(json.dumps({"batched_summary": summary,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
