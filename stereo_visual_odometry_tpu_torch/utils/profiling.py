"""Profiling and timing harness.

Port of ``stereo_visual_odometry_tpu/utils/profiling.py``: per-stage timing
as a reusable context manager, ``torch.profiler`` trace capture in place of
``jax.profiler``, and a timer for a callable (an eager step, a CUDA graph's
replay). On the card the timers read CUDA events on the current stream and
wait on their own end event, not on the whole device; on the CPU they read
the wall clock. Both run on the card unless the caller asks for the CPU.

Spans: the program marks its stages with ``span(name)``. The module's one
timing record is ``Span`` (name, start and end on ``time.perf_counter_ns``,
its own id, its parent's, a request id shared by every span under one root,
and the thread it ran on); ``StageTimer`` keeps its stages as ``Span`` too.
Spans are recorded only between ``record()`` and the recorder's ``take()``:
otherwise ``span`` returns one shared no-op context and allocates nothing.
While recording, a span also opens a host range of its name whenever a
``torch.profiler`` records on its thread, so it sits in the profiler's
trace beside the device ops, on the profiler's clock. The range is the
profiler's plain host-op kind (``_RecordFunctionFast``), not a
``record_function`` user annotation: the profiler mirrors each annotation
onto the device as an event spanning every kernel launched inside it,
which a reading of device busy time would count as device work. A span
opened with ``timed=True`` records a CUDA event pair on the current
stream around its block, read into ``device_ms`` only at ``take()``.

The spans the port records: ``evaluate.{pass,init,chunk,load_wait,draws,
upload,replays,prefetch,fetch,compose}`` (``parallel/evaluate.py``;
``evaluate.upload`` a pass's first chunk, uploaded before its replays,
``evaluate.prefetch`` each later chunk's, made while the replays before it
run, timed on the copy stream),
``run_chunked.{chunk,upload,sync,replays,fetch,unpack}`` and
``system.{step,fetch}`` (``models/system.py``), ``online.queue``
(``models/online.py``: from a pair's put to the worker's get, across
threads, ``begin``/``end``), ``graph.{replay,launch,capture}``
(``models/step_graph.py``; ``graph.launch`` timed) and the BA backend's
(``models/backend.py``): ``backend.keyframe`` (``add_keyframe``'s
bookkeeping) with ``backend.marginalize`` inside it where a slide
marginalizes (the prior build), and ``backend.solve`` (all of
``optimize``; timed on the card) with ``backend.{problem,lm,fetch}``
(the window's table put on the device, the solve's call, the copy back);
on the card ``backend.lm`` holds ``backend.capture`` (the graphed solve's
warm-up and capture, a key's first solve; ``models/ba_graph.py``) and
``backend.replay`` (timed: the copies in, the launch, the clones out). A
solve's LM steps run and accepted are counters in its
result (``lm_iters``, known on the host, and ``lm_accepted``, fetched with
the rest), and whether it replayed from the graph (``graphed``); the
graphed solve counts its ``captures`` and ``replays``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import defaultdict

import torch

MAX_SPANS = 200_000    # a recorder keeps at most this many; it counts the rest


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    """One timed interval of the program: ``start_ns``/``end_ns`` on
    ``time.perf_counter_ns``; ``id``, ``parent`` (None at a root) and
    ``request`` (the root's id, or the one ``within`` hands on) as a
    recorder numbers them; ``thread`` (``threading.get_ident``); and
    ``device_ms``, the device time between a CUDA event pair around it
    where it has one (``events``, read at ``take()``)."""

    name: str
    start_ns: int
    end_ns: int | None = None
    id: int = 0
    parent: int | None = None
    request: int | None = None
    thread: int = 0
    device_ms: float | None = None
    events: tuple | None = None

    @property
    def seconds(self) -> float:
        """The span's time: its device time where it has one, else host."""
        if self.device_ms is not None:
            return self.device_ms / 1e3
        return (self.end_ns - self.start_ns) / 1e9

    def as_dict(self) -> dict:
        return {"name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "id": self.id, "parent": self.parent, "request": self.request,
                "thread": self.thread, "device_ms": self.device_ms}


def summary(spans) -> dict[str, dict]:
    """Per span name: ``total_s`` (the sum of ``Span.seconds``), ``calls``
    and ``mean_ms``."""
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    for sp in spans:
        totals[sp.name] = totals.get(sp.name, 0.0) + sp.seconds
        counts[sp.name] = counts.get(sp.name, 0) + 1
    return {k: {"total_s": totals[k], "calls": counts[k],
                "mean_ms": 1e3 * totals[k] / counts[k]} for k in totals}


class Recorder:
    """The spans recorded from ``record()`` to ``take()``, in memory, at
    most ``MAX_SPANS`` of them (``dropped`` counts the rest). Spans may
    close on any thread."""

    def __init__(self):
        self.dropped = 0
        self._spans: list[Span] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def _open(self, name: str) -> Span:
        """A span starting now, a child of the innermost span open on this
        thread (else a root, of the request ``within`` set, or its own)."""
        stack = _stack()
        sid = next(self._ids)
        if stack:
            parent, request = stack[-1].id, stack[-1].request
        else:
            parent, request = None, getattr(_local, "request", None) or sid
        return Span(name, time.perf_counter_ns(), id=sid, parent=parent, request=request,
                    thread=threading.get_ident())

    def _keep(self, sp: Span) -> None:
        with self._lock:
            if len(self._spans) < MAX_SPANS:
                self._spans.append(sp)
            else:
                self.dropped += 1

    def take(self) -> list[dict]:
        """Stop recording (if this is the recorder on) and return every
        span kept, as dicts (``Span.as_dict``), each event pair read into
        ``device_ms`` (waiting for its end event)."""
        global _recorder
        if _recorder is self:
            _recorder = None
        with self._lock:
            spans, self._spans = self._spans, []
        for sp in spans:
            if sp.events is not None:
                start, end = sp.events
                end.synchronize()
                sp.device_ms, sp.events = start.elapsed_time(end), None
        return [sp.as_dict() for sp in spans]


_recorder: Recorder | None = None      # the recorder on, if any
_local = threading.local()             # per thread: the open spans, a request id
_NULL = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def record() -> Recorder:
    """Start a fresh recorder (replacing any recorder on); its ``take()``
    stops it and returns its spans."""
    global _recorder
    _recorder = Recorder()
    return _recorder


@contextlib.contextmanager
def _recorded(rec: Recorder, name: str, timed: bool):
    sp = rec._open(name)
    stack = _stack()
    stack.append(sp)
    ranged = None
    if torch._C._autograd._profiler_enabled():
        ranged = torch._C._profiler._RecordFunctionFast(name)
        ranged.__enter__()
    if timed:
        sp.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        sp.events[0].record()
    sp.start_ns = time.perf_counter_ns()
    try:
        yield sp
    finally:
        if timed:
            sp.events[1].record()
        sp.end_ns = time.perf_counter_ns()
        if ranged is not None:
            ranged.__exit__(None, None, None)
        stack.pop()
        rec._keep(sp)


def span(name: str, timed: bool = False):
    """Context manager: the block as a span named ``name`` while a recorder
    is on, else a shared no-op. ``timed``: also a CUDA event pair on the
    current stream around the block (its ``device_ms``; a card must be
    there)."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _recorded(rec, name, timed)


@contextlib.contextmanager
def measure(name: str):
    """The block as a span named ``name``, recorded or not: yields the
    ``Span``, whose ``end_ns`` is set when the block ends (a stage whose
    time the program keeps whether a recorder is on or not)."""
    rec = _recorder
    if rec is not None:
        with _recorded(rec, name, False) as sp:
            yield sp
        return
    sp = Span(name, time.perf_counter_ns())
    try:
        yield sp
    finally:
        sp.end_ns = time.perf_counter_ns()


def begin(name: str) -> Span | None:
    """Open a span that ``end`` closes, on any thread (a wait from one
    thread to another); None while no recorder is on. No profiler range."""
    rec = _recorder
    return None if rec is None else rec._open(name)


def end(sp: Span | None) -> None:
    """Close ``begin``'s span and keep it, if a recorder is still on."""
    rec = _recorder
    if sp is None or rec is None:
        return
    sp.end_ns = time.perf_counter_ns()
    rec._keep(sp)


@contextlib.contextmanager
def _adopted(request: int):
    before = getattr(_local, "request", None)
    _local.request = request
    try:
        yield
    finally:
        _local.request = before


def within(sp: Span | None):
    """Context manager: the root spans this thread opens inside it take
    ``sp``'s request id (a no-op for None)."""
    return _NULL if sp is None else _adopted(sp.request)


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
    device work: each stage a ``Span`` (in ``spans``) whose ``device_ms``
    is the CUDA events' reading on the card."""

    def __init__(self, device="cuda"):
        self.device = _device(device)
        self.spans: list[Span] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        took = []
        sp = Span(name, time.perf_counter_ns())
        with _clock(self.device, took):
            yield
        sp.end_ns = time.perf_counter_ns()
        if self.device.type == "cuda":
            sp.device_ms = 1e3 * took[0]
        self.spans.append(sp)

    def summary(self) -> dict[str, dict]:
        return summary(self.spans)

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
