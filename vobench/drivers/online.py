"""Driver: an open-loop stereo feed through ``models.online.OnlineVO``.

A producer thread pushes pair k at its due time t0 + k / rate_hz, whatever
the system is doing; the main thread polls for results. A frame's latency is
the time its result was polled less its due time, so a stall is charged to
every frame queued behind it. ``OnlineVO`` is warmed first, closed loop, on
the drive's first ``warm_frames`` pairs from the lap frame the seed gives
(its worker captures the step's graph); the schedule then continues. A pair
the feed drops (queue full) counts as failed, with the age it reached
unanswered as its latency. Only the frames the schedule reaches are
rendered (``frames_needed``).
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np

from .. import trace
from ..session import sync

LEAD_S = 0.05          # the first due time, after the schedule is built
WAIT_S = 60.0          # how long past the window a result may still come


def frames_needed(traffic: dict, seconds: float, trace: bool) -> int:
    """The drive frames a run reaches: the warm-up, the window's schedule
    and, traced, the profiled stretch."""
    return (traffic["warm_frames"] + math.ceil(seconds * traffic["rate_hz"]) + 1
            + (traffic["trace_frames"] if trace else 0))


def _feed(vo, cell, first: int, count: int, period: float) -> dict:
    """Push ``count`` pairs from drive frame ``first`` on schedule and poll
    every result: {frame: polled - due}, {frame: (accept, n_tracked)} and
    the frames dropped."""
    t0 = time.perf_counter() + LEAD_S
    dropped_before = vo.dropped
    done = threading.Event()

    def produce():
        try:
            for k in range(count):
                delay = t0 + k * period - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                vo.push_pair((first + k) * period, *cell.frame(first + k))
        finally:
            done.set()

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    latency, answers = {}, {}
    deadline = t0 + count * period + WAIT_S
    while time.perf_counter() < deadline:
        if done.is_set() and len(latency) + vo.dropped - dropped_before >= count:
            break
        m = vo.poll(timeout=0.02)
        if m is not None:
            k = int(round(m["ts"] / period)) - first
            latency[k] = time.perf_counter() - (t0 + k * period)
            answers[k] = (bool(m["accept"]), m.get("n_tracked"))
    end = time.perf_counter()
    producer.join(timeout=WAIT_S)
    unanswered = [k for k in range(count) if k not in latency]
    return {"t0": t0, "end": end, "latency": latency, "answers": answers,
            "unanswered": unanswered,
            "dropped": vo.dropped - dropped_before,
            "late": [end - (t0 + k * period) for k in unanswered]}


def run(cell) -> dict:
    from stereo_visual_odometry_tpu_torch.models.online import OnlineVO
    from stereo_visual_odometry_tpu_torch.models.system import System
    from stereo_visual_odometry_tpu_torch.utils.config import RunConfig

    t = cell.traffic
    period = 1.0 / t["rate_hz"]
    system = System(RunConfig(camera=cell.cam, vo=cell.vo, seed=cell.seed),
                    device=cell.devices[0])
    vo = OnlineVO(system, slop=t["slop_s"])
    try:
        first, warm = cell.start, t["warm_frames"]
        for i in range(warm):
            vo.push_pair((first + i) * period, *cell.frame(first + i))
            if vo.poll(timeout=WAIT_S) is None:
                raise RuntimeError(f"no result for warm-up frame {i}")
        sync(cell.devices)
        count = int(round(cell.seconds * t["rate_hz"]))
        got = _feed(vo, cell, first + warm, count, period)
        answered = sorted(got["latency"])
        rejected = sum(not got["answers"][k][0] for k in answered)
        res = {"t_first": got["t0"], "window_s": got["end"] - got["t0"], "frames": count,
               "failed": got["dropped"] + rejected, "rejected": rejected,
               "answered": len(answered), "completed": len(answered),
               "tracked": [int(got["answers"][k][1]) for k in answered
                           if got["answers"][k][1] is not None],
               "unanswered": len(got["unanswered"]) - got["dropped"],
               "latencies_s": [got["latency"][k] for k in answered] + got["late"],
               "drive": (first + warm + np.array(answered, dtype=np.int64),
                         np.stack(system.poses[warm:warm + len(answered)])),
               "memory_peak_bytes": cell.memory_peak()}
        graphs = [system.graph] if system.graph is not None else []
        cell.check_kernels(graphs)
        res["kernels"] = cell.kernels
        if cell.trace:
            more = t["trace_frames"]
            res["stretch"] = trace.stretch(
                lambda: _feed(vo, cell, first + warm + count, more, period), cell.devices)
    finally:
        vo.close()
    if cell.trace:
        res["graphs"] = graphs
    return res
