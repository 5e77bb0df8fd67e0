"""Driver: one drive through ``System.run`` with the BA backend, frame by frame.

The ``System`` takes the cell's ``VOConfig`` and the ``backend`` of the
configuration the traffic names under ``backend_of`` (``backend_config``;
one without a backend is refused). It is warmed, closed loop, on the drive's
first ``warm_frames`` frames from the lap frame the seed gives: the first
frame's step captures the step graph, and ``1 + window * kf_every +
kf_every`` frames take the window through its first slide and its first
marginalized solve. Then one ``System.run`` call takes a generator that
continues the circuit, lap after lap, and stops yielding once ``--seconds``
have passed since its first frame: pair k + 1 is handed over once step k
has returned. The window runs from that first frame to the call's return.

The backend logs its work (``SlidingWindowBA.log``, from the ``System``'s
start): every slide's marginalization inputs and the prior it kept, and
the last ``checked_solves`` solves' problems and outputs, by reference (no
copy, no wait). Once the window has closed the reference (``reference_ba``,
float64, on the cell's first device) holds them to account:

* ``ba_prior_err``: the reference chains its own prior from the first
  slide on (each slide's inputs, its prior from the slide before shifted
  and decayed by the configuration's ``prior_decay``, the Schur complement
  over the oldest pose and the consumed landmarks); the largest
  ``reference_ba.prior_gap`` between the program's prior and the
  reference's over every slide (``check_priors``);
* each checked solve is solved again from its inputs with the reference's
  own prior in place of the program's (``check_solves``):
  ``ba_cost_excess``, the timed solve's final cost, worked out again by the
  reference's cost in float64 (Huber over the observations the reference
  kept after its prune, plus the reference's prior), less the reference's
  own final cost, over the reference's; ``ba_pose_err_m``,
  ``ba_rot_err_rad``, the largest distance between the two solves' camera
  centres and the largest angle between their rotations (atan2 of the
  skew part's norm over the symmetric part's, as ``reference.angle`` reads
  it), over the window's pose slots.

What the slides take from the program: which keyframe slides and when,
which landmarks it consumes, their observations and positions, and the
window's poses at the slide (the backend's bookkeeping, the inputs).

A ``trace.KernelCalls`` handed in with a ``ba`` attribute (``control_ba``)
puts that function, ``ba(solve, **problem)``, in the timed solve's place
(``SlidingWindowBA.solve``) for the run, and one with a ``backend``
attribute (a dict) changes those ``BackendConfig`` fields of the program
only: the control and the planted faults. The check still holds the
program to the configuration.

With ``--trace 1`` the window's spans are recorded (``spans``; the program's
``utils/profiling`` recorder, from the window's first frame to its end),
then ``trace_frames`` more frames are profiled (``stretch``), and the last
``profiled_solves`` solves logged are each run and profiled alone again
(``solves``: device-busy and wall seconds and the count of device ops).
A program whose backend keeps no log (``SlidingWindowBA.log``) is refused.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from .. import arith, trace
from ..session import sync

ROOT = Path(__file__).resolve().parents[2]


def backend_config(name: str) -> dict:
    """The ``backend`` of the configuration ``BENCHMARK.json`` names ``name``
    (its ``BackendConfig`` fields); raises if it has none."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    if name not in files:
        raise ValueError(f"run_frames: no configuration {name!r} in BENCHMARK.json")
    config = json.loads((ROOT / files[name]).read_text())
    if not config.get("backend"):
        raise ValueError(f"run_frames needs a BA backend; configuration {name!r} has none")
    return config["backend"]


class Log:
    """What ``SlidingWindowBA.log`` receives: every slide (its inputs and
    the prior kept), and the last ``keep`` solves, each with the number of
    slides before it."""

    def __init__(self, keep: int):
        self.slides, self.solves = [], collections.deque(maxlen=keep)

    def append(self, entry) -> None:
        kind, inputs, outputs = entry
        if kind == "slide":
            self.slides.append((inputs, outputs))
        else:
            self.solves.append((len(self.slides), inputs, outputs))


def moved(tree, device):
    """A nest of dicts and dataclasses (the camera) of tensors, each tensor
    copied to ``device`` (other leaves as they are)."""
    import torch
    if isinstance(tree, dict):
        return {k: moved(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: moved(getattr(tree, f.name), device)
                             for f in dataclasses.fields(tree)})
    return tree.detach().to(device) if isinstance(tree, torch.Tensor) else tree


def check_priors(slides, decay: float, huber_px: float, device) -> tuple[list, dict]:
    """The reference's own chain of priors over the logged ``slides``, and
    the largest gap of the program's to it: ([the reference's prior after
    0, 1, ... slides], {ba_prior_err (None where no slide marginalized),
    ba_prior_checked})."""
    from .. import reference_ba

    prior, chain, gaps = None, [None], []
    for inputs, kept in slides:
        if inputs is not None:
            inputs = moved(dict(inputs, huber_px=huber_px), device)
            prior = reference_ba.build_prior(**inputs, carried=prior, decay=decay)
            gaps.append(reference_ba.prior_gap(kept, prior))
        chain.append(prior)
    return chain, {"ba_prior_err": max(gaps) if gaps else None, "ba_prior_checked": len(gaps)}


def check_solves(solves, chain, device) -> dict:
    """Each logged solve against ``reference_ba``'s solve of its inputs in
    float64 on ``device``, with the reference's prior (``chain``, indexed
    by the slides before the solve): the largest ``ba_cost_excess``,
    ``ba_pose_err_m`` and ``ba_rot_err_rad`` (None where no solve was
    logged) and ``ba_checked``."""
    from .. import reference_ba

    excess, pose, rot = [], [], []
    for n_slides, problem, out in solves:
        problem = dict(moved(problem, device), prior=chain[n_slides])
        out = moved({k: out[k] for k in ("poses", "points")}, device)
        want = reference_ba.bundle_adjust(**problem)
        common = {k: problem.get(k) for k in ("obs_kf", "obs_lm", "obs_uv", "obs_right",
                                              "T_rl", "prior")}
        common.update(obs_w=want["obs_w"], huber_px=problem["huber_px"])
        cam = problem["cam"]
        mine = reference_ba.final_cost(cam, out["poses"], out["points"], **common)
        theirs = reference_ba.final_cost(cam, want["poses"], want["points"], **common)
        excess.append(float((mine - theirs) / theirs))
        gap_m, gap_rad = reference_ba.pose_gaps(out["poses"], want["poses"])
        pose.append(gap_m)
        rot.append(gap_rad)
    worst = lambda v: max(v) if v else None
    return {"ba_cost_excess": worst(excess), "ba_pose_err_m": worst(pose),
            "ba_rot_err_rad": worst(rot), "ba_checked": len(solves)}


def _profile_solves(solve, solves, devices) -> list[dict]:
    """Each logged problem solved again by ``solve``, alone under the
    profiler (from an idle device to the end of its work): busy and wall
    seconds, device ops."""
    out = []
    for _, problem, _ in solves:
        dev, _, wall = trace._profiled(lambda: solve(**problem), devices)
        out.append({"busy_s": arith.busy([(a, b) for a, b, _, _ in dev]), "wall_s": wall,
                    "ops": len(dev)})
    return out


def run(cell) -> dict:
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    from stereo_visual_odometry_tpu_torch.models.system import System
    from stereo_visual_odometry_tpu_torch.utils import profiling
    from stereo_visual_odometry_tpu_torch.utils.config import RunConfig

    t = cell.traffic
    config = backend_config(t["backend_of"])
    bcfg = BackendConfig(**dict(config, **getattr(cell.calls, "backend", {})))
    least = 1 + bcfg.window * bcfg.kf_every + bcfg.kf_every
    if t["warm_frames"] < least:
        raise ValueError(f"run_frames: {t['warm_frames']} warm frames do not reach the first "
                         f"marginalized solve ({least} with window {bcfg.window}, kf_every "
                         f"{bcfg.kf_every})")
    system = System(RunConfig(camera=cell.cam, vo=cell.vo, seed=cell.seed),
                    device=cell.devices[0], backend_cfg=bcfg)
    backend = system.backend
    if not hasattr(backend, "log"):
        raise ValueError("run_frames: the program's backend keeps no log "
                         "(SlidingWindowBA.log); the window solve cannot be checked")
    solve, swap = backend.solve, getattr(cell.calls, "ba", None)
    if swap is not None:
        backend.solve = lambda **problem: swap(solve, **problem)
    log = backend.log = Log(max(t["checked_solves"], t["profiled_solves"] if cell.trace else 0))
    first, warm = cell.start, t["warm_frames"]
    system.run([cell.frame(first + i) for i in range(warm)])
    sync(cell.devices)

    clock = {}

    def drive():
        f = first + warm
        clock["t0"] = time.perf_counter()
        while time.perf_counter() - clock["t0"] < cell.seconds:
            yield cell.frame(f)
            f += 1

    rec = profiling.record() if cell.trace else None
    try:
        system.run(drive())
    finally:
        spans = rec.take() if rec is not None else None
        backend.log, backend.solve = None, solve
    window = time.perf_counter() - clock["t0"]
    n = len(system.poses) - warm
    answers = system.metrics[warm:]
    rejected = sum(not m["accept"] for m in answers)
    res = {"t_first": clock["t0"], "window_s": window, "frames": n, "failed": rejected,
           "rejected": rejected, "answered": n,
           "tracked": [int(m["n_tracked"]) for m in answers if "n_tracked" in m],
           "drive": (first + warm + np.arange(n), np.stack(system.poses[warm:])),
           "memory_peak_bytes": cell.memory_peak()}
    graphs = [system.graph] if system.graph is not None else []
    cell.check_kernels(graphs)
    dev = cell.devices[0]
    chain, priors = check_priors(log.slides, config["prior_decay"], config["huber_px"], dev)
    checked = list(log.solves)[-t["checked_solves"]:]
    res["kernels"] = dict(cell.kernels, **priors, **check_solves(checked, chain, dev))
    res["solves_per_frame"] = sum("ba" in m for m in answers) / max(n, 1)

    if cell.trace:
        res["spans"] = spans
        more = t["trace_frames"]
        res["stretch"] = trace.stretch(
            lambda: system.run([cell.frame(first + warm + n + i) for i in range(more)]),
            cell.devices)
        res["solves"] = _profile_solves(solve, list(log.solves)[-t["profiled_solves"]:],
                                        cell.devices)
        res["graphs"] = graphs
    return res
