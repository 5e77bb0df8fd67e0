"""Profiling and timing harness.

Port of ``stereo_visual_odometry_tpu/utils/profiling.py``: per-stage timing
as a reusable context manager, ``torch.profiler`` trace capture in place of
``jax.profiler``, and a timer for a callable (an eager step, a CUDA graph's
replay). On the card the timers read CUDA events on the current stream and
wait on their own end event, not on the whole device; on the CPU they read
the wall clock. Both run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"timing on device={str(device)!r} needs an NVIDIA GPU and "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    return dev


@contextlib.contextmanager
def _clock(device: torch.device, out: list):
    """Append the seconds the block took to ``out``: CUDA events on the
    current stream of ``device`` (waiting on the end event), else the wall
    clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        yield
        out.append(time.perf_counter() - t0)
        return
    with torch.cuda.device(device):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    yield
    with torch.cuda.device(device):
        end.record()
    end.synchronize()
    out.append(start.elapsed_time(end) / 1e3)


class StageTimer:
    """Accumulates the time of each named stage, up to the end of its
    device work."""

    def __init__(self, device="cuda"):
        self.device = _device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        took = []
        with _clock(self.device, took):
            yield
        self.totals[name] += took[0]
        self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {k: {"total_s": self.totals[k], "calls": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        return "\n".join(f"{k:24s} {v['mean_ms']:8.2f} ms x{v['calls']}"
                         for k, v in rows)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the block (the host, and the
    card when there is one); written to ``log_dir/trace.json`` (Chrome trace
    format, for Perfetto) unless ``log_dir`` is None. Yields the profiler,
    whose ``events()`` and ``key_averages()`` read it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_activity(prof) -> dict:
    """The device work a ``trace`` recorded: ``ops`` (kernels, copies and
    fills), ``busy_ms`` (the union of their intervals), ``span_ms`` (first
    start to last end) and ``names`` (ops per name)."""
    evs = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA))
    busy, reach, names = 0.0, float("-inf"), defaultdict(int)
    for start, end, name in evs:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        names[name] += 1
    span = (reach - evs[0][0]) if evs else 0.0
    return {"ops": len(evs), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "names": dict(names)}


def time_jitted(fn, *args, iters: int = 10, warmup: int = 2, device="cuda") -> float:
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls: CUDA
    events around the ``iters`` calls on ``device``'s current stream (the
    larger of the host's time to issue the calls and the device's to run
    them), or the wall clock on the CPU."""
    dev = _device(device)
    for _ in range(warmup):
        fn(*args)
    took = []
    with _clock(dev, took):
        for _ in range(iters):
            fn(*args)
    return took[0] / iters
