"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python -m vobench.run --workload lk_dense.offline_s11 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``configs/<name>.json``: the sensor and
the port's ``VOConfig``) and a traffic mix (``traffic/<name>.json``: the
circuit it names in ``circuits/``, the driver in ``drivers/`` and its
parameters); ``limits/<cell>.json`` holds the limits of the numbers that
decide ``correct`` (each a ceiling), and each metric is read by
``metrics/<metric>.py``. A run renders
the lap frames the cell can reach on the card, warms the cell's path up
(set-up), runs the driver's window of ``--seconds``, holds K1's and K2's
calls in the window's last replay to the plain kernels, then judges every
answer of the window against the plain reference (``reference.py``). With ``--trace 1`` it then profiles a short
stretch and a few replays and reports the per-layer metrics instead of the
end-to-end ones. The last line of standard output is one JSON object; the
numbers compared, each with its limit, are the last lines of standard error
and the result's last key.

Without a card, or with fewer cards than the cell asks for, it exits with 2
and prints no result; so it does if, once the window has closed, the process
holds JAX, Flax or the JAX package (compared by top-level module name).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock (from the kernel's
    record of the start, so the interpreter's own start-up counts)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


START = _process_start()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_visual_odometry_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


def set_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program in fixed directories of
    the checkout (``.vobench_cache/``), before torch is imported."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / ".vobench_cache" / sub)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(workload: str, overrides: dict | None = None) -> dict:
    """The cell's entries: its workload, configuration, traffic (with the
    circuit its file names) and limits (``overrides``: {"config": {...},
    "traffic": {...}} merged one level deep, for rehearsals at a small
    size)."""
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    spec = {"bench": bench, "workload": entry,
            "config": _json(ROOT / configs[entry["config"]]["file"]),
            "traffic": _json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "limits": _json(HERE / "limits" / f"{workload}.json")}
    circuit = spec["traffic"]["circuit"]
    if isinstance(circuit, str):
        spec["traffic"]["circuit"] = _json(HERE / "circuits" / f"{circuit}.json")
    for key, extra in (overrides or {}).items():
        if key == "limits":
            spec[key] = dict(extra)
            continue
        for k, v in extra.items():
            spec[key][k] = dict(spec[key][k], **v) if isinstance(v, dict) else v
    return spec


def passes(numbers: dict, limits: dict) -> bool:
    """Every number at most its limit; a number that is missing fails."""
    return all(numbers.get(name) is not None and numbers[name] <= limit
               for name, limit in limits.items())


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones: a
    metric with ``workloads`` where it lists the cell; an end-to-end metric
    without them in every cell; a per-layer one without them where the
    cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> number or None``."""
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_cell(workload: str, seed: int, seconds: float, trace: bool, devices,
             overrides: dict | None = None, lap: dict | None = None,
             calls=None) -> dict:
    """One run of ``workload`` on ``devices`` (torch devices: its cards, or
    the CPU in a rehearsal). Returns what a reader reads: the driver's
    result, the compared ``numbers`` and their ``limits``, ``setup_s`` and,
    traced on a card, the stretch, the replays and the step's nodes.
    ``lap``: a lap already rendered with every frame (``vobench.control``
    runs many seeds on one); ``calls``: a ``trace.KernelCalls`` with a
    function in a kernel's place (the control, a planted fault)."""
    import numpy as np
    import torch
    from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
    from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig

    from . import reference, render, trace as tracing
    from .session import Cell, start_frame

    spec = cell_spec(workload, overrides)
    config, traffic = spec["config"], spec["traffic"]
    sensor = config["sensor"]
    (h, w) = sensor["raw_hw"]
    cam = CameraConfig(fx=sensor["fx"], fy=sensor["fx"], cx=w / 2.0, cy=h / 2.0,
                       baseline=sensor["baseline_m"])
    driver = importlib.import_module(f"vobench.drivers.{traffic['driver']}")
    if lap is None:
        # A batch's sequences start up to a stride in and run on past the
        # lap's end; a feed reaches only the frames its schedule holds.
        S, n = traffic.get("sequences", 1), traffic["circuit"]["lap_frames"]
        extra = traffic["frames_per_sequence"] + n // S if S > 1 else 0
        count = getattr(driver, "frames_needed", lambda *a: None)(traffic, seconds, trace)
        frames = None if count is None else start_frame(seed, n) + np.arange(count)
        lap = render.render_lap(traffic["circuit"], sensor, devices[0], frames, extra)
    calls = calls if calls is not None else tracing.KernelCalls()
    cell = Cell(vo=VOConfig(**config["vo"]), cam=cam, traffic=traffic, lap=lap, seed=seed,
                seconds=seconds, trace=trace, devices=list(devices), calls=calls)
    with calls:
        res = driver.run(cell)
    kind = torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else "cpu"
    out = {"kind": kind, "setup_s": res["t_first"] - START, "limits": spec["limits"],
           **{k: v for k, v in res.items() if k not in ("graphs", "pieces", "drive")}}
    graphs = res.pop("graphs", None)
    if trace and graphs and devices[0].type == "cuda":
        out["replays"] = tracing.replays(graphs, calls, kind)
        out["nodes"] = max(g.count_nodes() for g in graphs)
    del graphs, cell, calls
    if "pieces" in res:
        pieces = res["pieces"]
    else:
        pieces = reference.segments(*res["drive"], traffic["segment_frames"])
    out["pieces"], out["lap_poses"] = pieces, lap["poses"]
    out["numbers"] = dict(reference.judge(pieces, lap["poses"]), **res["kernels"],
                          rejected_share=res["rejected"] / max(res["answered"], 1),
                          tracked_min=min(res["tracked"], default=None))
    out["correct"] = bool(out["numbers"]["segments"] > 0 and not res.get("unanswered")
                          and passes(out["numbers"], spec["limits"]))
    return out


def result(run: dict, bench: dict, workload: str, trace: bool, devices) -> dict:
    """The result line's object: correct, attempted, failed, metrics, device,
    with ``--trace 1`` breakdown, and last the numbers compared with their
    limits."""
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run["kind"], "count": len(devices),
              "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": run["correct"], "attempted": run["frames"], "failed": run["failed"],
           "metrics": metrics, "device": device}
    if trace and "stretch" in run:
        device.update(busy_s=run["stretch"]["busy_s"], window_s=run["stretch"]["window_s"])
        out["breakdown"] = {"device_ops": run["stretch"]["top_ops"],
                            "idle_gaps": run["stretch"]["idle_gaps"]}
    out["checks"] = {k: {"value": run["numbers"][k], "limit": v}
                     for k, v in run["limits"].items()}
    return out


def loaded_forbidden() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    import torch

    spec = cell_spec(args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vobench: {args.workload} needs {chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), devices)
    found = loaded_forbidden()
    if found:
        print(f"vobench: the process holds {found} after the window", file=sys.stderr)
        return 3
    out = result(run, spec["bench"], args.workload, bool(args.trace), devices)
    seen = {k: run["numbers"][k] for k in ("k1_checked", "k1_skipped", "k2_checked",
                                            "k2_skipped", "tracked_min", "segments")}
    print("read " + " ".join(f"{k} {v!r}" for k, v in seen.items()), file=sys.stderr)
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
