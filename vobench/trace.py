"""Reading the device through ``torch.profiler`` in a ``--trace 1`` run.

* ``stretch``: a short stretch of the cell's own path (its driver's call),
  profiled: the device's busy time per card (the union of its intervals),
  the stretch's wall time, the device ops that took most time and the
  longest idle gaps, each named by the host op that overlaps it most.
* ``replays``: a few replays of the cell's step graphs, each profiled on its
  own: device-busy ms per replay and, for K1 and K2, their device time by
  kernel name against the least time of the calls the replays made.
* ``KernelCalls``: while the warm-up captures the step graphs, the K1 and K2
  calls captured are recorded (their inputs and outputs, whose memory every
  replay of the graph refills), so that the bytes each call needs can be
  counted from what a replay really read, and every run can hold the calls
  of its window's last replay to the plain kernels (``reference``). It adds
  no node.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

from . import arith
from .session import sync

K1_KERNEL = "extract_windows_int_kernel"
K2_KERNEL = "extract_patches_kernel"
REPLAYS = 3
TRIES = 3              # a profile that recorded no device op is taken again
TOP = 10


class KernelCalls:
    """Within ``with``: K1's and K2's calls, recorded as (images, corners or
    centres, window or patch size, output). On the card the calls a graph
    capture makes are recorded: every replay of the graph refills those
    tensors, and the references held here keep the capture from giving
    their memory to a later op, so after a replay they hold what each call
    read and wrote. Off the card (a rehearsal, eager) the last ``keep``
    calls of each kernel are kept. It adds no node.

    ``k1`` / ``k2``: a function ``(images, corners, sh, sw)`` / ``(images,
    centres, P)`` put in the kernel's place (the control, a planted fault).
    """

    def __init__(self, k1=None, k2=None, keep: int = 64):
        self.k1, self.k2 = [], []
        self._swap, self._keep = {"k1": k1, "k2": k2}, keep

    def _record(self, key: str, call: tuple) -> None:
        calls = getattr(self, key)
        calls.append(call)
        if not call[0].is_cuda and len(calls) > self._keep:
            del calls[0]

    def __enter__(self):
        from stereo_visual_odometry_tpu_torch.ops import patch
        self._patch = patch
        names = ("launch_windows", "launch_patches", "extract_windows_int_reference",
                 "extract_patches_clamped")
        self._saved = {n: getattr(patch, n) for n in names}
        k1 = self._swap["k1"] or self._saved["launch_windows"]
        k2 = self._swap["k2"] or self._saved["launch_patches"]
        plain_k1 = self._saved["extract_windows_int_reference"]
        plain_k2 = self._saved["extract_patches_clamped"]

        def capturing() -> bool:
            return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()

        def windows(imgs, corners, sh, sw):
            out = k1(imgs, corners, sh, sw)
            if capturing():
                self._record("k1", (imgs, corners, sh, sw, out))
            return out

        def patches(imgs, centers, P):
            out = k2(imgs, centers, P)
            if capturing():
                self._record("k2", (imgs, centers, P, out))
            return out

        def windows_cpu(img, corners, S):
            sh, sw = (S, S) if isinstance(S, int) else (int(S[0]), int(S[1]))
            out = (self._swap["k1"](img, corners, sh, sw) if self._swap["k1"]
                   else plain_k1(img, corners, S))
            self._record("k1", (img, corners, sh, sw, out))
            return out

        def patches_cpu(img, centers, P):
            out = (self._swap["k2"](img, centers, P) if self._swap["k2"]
                   else plain_k2(img, centers, P))
            self._record("k2", (img, centers, P, out))
            return out

        patch.launch_windows, patch.launch_patches = windows, patches
        patch.extract_windows_int_reference, patch.extract_patches_clamped = (windows_cpu,
                                                                               patches_cpu)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._patch, name, fn)
        return False


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _events(prof):
    """(device ops as (start_s, end_s, name, card), host ops as (start_s,
    end_s, name))."""
    dev, host = [], []
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((start, end, e.name, e.device_index))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((start, end, e.name))
    return dev, host


def _cards(devices) -> list[int]:
    return sorted({d.index if d.index is not None else torch.cuda.current_device()
                   for d in devices if d.type == "cuda"})


class Span:
    """A profiled span from ``start()`` to ``stop()``, each from an idle
    device; a call handed one starts and stops it where it chooses."""

    def __init__(self, devices):
        self.devices, self.prof, self.wall = devices, None, None

    def start(self) -> None:
        sync(self.devices)
        self.prof = _profiler()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.devices)
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()


def _profiled(call, devices, spans: bool = False):
    """Profile ``call`` (the whole of it, or with ``spans`` the span it
    starts and stops on the ``Span`` it is handed): (device ops, host ops,
    wall s)."""
    for _ in range(TRIES):
        span = Span(devices)
        if spans:
            call(span)
        else:
            span.start()
            call()
            span.stop()
        dev, host = _events(span.prof)
        if dev or not _cards(devices):
            break
    return dev, host, span.wall


def short(name: str) -> str:
    """A device op's name without its template and argument lists and its
    return type (``void ns::kernel<...>(...)`` -> ``ns::kernel``), at most
    120 characters."""
    kept, depth = [], 0
    for ch in name.replace("(anonymous namespace)", "anon"):
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            kept.append(ch)
    head = "".join(kept).split("(")[0].strip()
    scoped = [t for t in head.split() if "::" in t]
    return (scoped[-1] if scoped else head or name)[:120]


def _name_gap(a: float, b: float, host) -> str:
    """The host op overlapping (a, b) most (the shorter one on a tie)."""
    best, key = "host: no recorded op", (0.0, 0.0)
    for start, end, name in host:
        over = min(b, end) - max(a, start)
        if over > 0 and (over, -(end - start)) > key:
            best, key = name, (over, -(end - start))
    return best


def stretch(call, devices, spans: bool = False) -> dict:
    """The profiled stretch ``call`` of the cell's path (with ``spans``, the
    span of it that it starts and stops on the ``Span`` it is handed)."""
    dev, host, wall = _profiled(call, devices, spans)
    cards = _cards(devices)
    busy = [arith.busy([(a, b) for a, b, _, d in dev if d == c]) for c in cards]
    by_name = defaultdict(float)
    for a, b, name, _ in dev:
        by_name[short(name)] += b - a
    merged = arith.union([(a, b) for a, b, _, _ in dev])
    gaps = sorted(((n[0] - p[1], p[1], n[0]) for p, n in zip(merged, merged[1:])),
                  reverse=True)[:TOP]
    return {"busy_s": sum(busy) / len(busy) if busy else 0.0, "window_s": wall,
            "top_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": [[_name_gap(a, b, host), g] for g, a, b in gaps]}


def replays(graphs, calls: KernelCalls | None, kind: str) -> dict:
    """``REPLAYS`` replays of ``graphs`` (one step graph per shard, launched
    together), each profiled alone: busy ms per replay (mean over the
    cards) and, per kernel, the least time of its recorded calls and its
    device time, summed over the replays."""
    devices = [g.device for g in graphs]
    cards = _cards(devices)
    busy_ms, sums = [], {"k1": [0.0, 0.0], "k2": [0.0, 0.0]}
    for _ in range(REPLAYS):
        dev, _, _ = _profiled(lambda: [g.launch() for g in graphs], devices)
        busy_ms.append(1e3 * sum(arith.busy([(a, b) for a, b, _, d in dev if d == c])
                                 for c in cards) / max(len(cards), 1))
        for key, kernel in (("k1", K1_KERNEL), ("k2", K2_KERNEL)):
            sums[key][1] += sum(b - a for a, b, name, _ in dev if kernel in name)
        if calls is not None:
            for imgs, corners, sh, sw, _ in calls.k1:
                least = arith.least_seconds(*arith.k1_work(imgs.shape, corners, sh, sw), kind)
                sums["k1"][0] += least or 0.0
            for imgs, centers, P, _ in calls.k2:
                least = arith.least_seconds(*arith.k2_work(imgs.shape, centers, P), kind)
                sums["k2"][0] += least or 0.0
    return {"busy_ms": sum(busy_ms) / len(busy_ms),
            "k1_bound_s": sums["k1"][0], "k1_time_s": sums["k1"][1],
            "k2_bound_s": sums["k2"][0], "k2_time_s": sums["k2"][1]}
