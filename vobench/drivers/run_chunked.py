"""Driver: one long drive through ``System.run_chunked``.

One ``System`` is warmed on the drive's first ``1 + chunk`` frames (which
captures its step graph), from the lap frame the seed gives; then one
``run_chunked`` call takes a generator that continues the circuit, lap after
lap, and stops yielding once ``--seconds`` have passed since its first
frame. The window runs from that
first frame to the call's return.
"""
from __future__ import annotations

import time

import numpy as np

from .. import trace
from ..session import sync


def run(cell) -> dict:
    from stereo_visual_odometry_tpu_torch.models.system import System
    from stereo_visual_odometry_tpu_torch.utils.config import RunConfig

    chunk = cell.traffic["chunk"]
    system = System(RunConfig(camera=cell.cam, vo=cell.vo, seed=cell.seed),
                    device=cell.devices[0])
    first, warm = cell.start, 1 + chunk
    system.run_chunked([cell.frame(first + i) for i in range(warm)], chunk=chunk)
    sync(cell.devices)

    clock = {}

    def drive():
        f = first + warm
        clock["t0"] = time.perf_counter()
        while time.perf_counter() - clock["t0"] < cell.seconds:
            yield cell.frame(f)
            f += 1

    system.run_chunked(drive(), chunk=chunk)
    window = time.perf_counter() - clock["t0"]
    n = len(system.poses) - warm
    frames = first + warm + np.arange(n)
    answers = system.metrics[warm:]
    rejected = sum(not m["accept"] for m in answers)
    res = {"t_first": clock["t0"], "window_s": window, "frames": n, "failed": rejected,
           "rejected": rejected, "answered": n, "tracked": [m["n_tracked"] for m in answers],
           "drive": (frames, np.stack(system.poses[warm:])),
           "memory_peak_bytes": cell.memory_peak()}
    graphs = [system.graph] if system.graph is not None else []
    cell.check_kernels(graphs)
    res["kernels"] = cell.kernels

    if cell.trace:
        more = cell.traffic["trace_frames"]
        res["stretch"] = trace.stretch(
            lambda: system.run_chunked([cell.frame(first + warm + n + i) for i in range(more)],
                                       chunk=chunk), cell.devices)
        res["graphs"] = graphs
    return res
