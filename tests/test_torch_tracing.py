"""The port's span recorder (``utils/profiling.py``) and the spans of the
evaluator, ``run_chunked``, the online feed and ``System.step``, on the CPU
at a tiny size (96x160, S = 2, 5 frames, chunk 2).

* Off (no ``record()``): ``span`` hands back one shared no-op and allocates
  nothing, and the three entry points make no ``Span``, no CUDA event and
  no profiler range.
* On: each entry point's span tree (names, parents, request ids, every
  child inside its parent; each ``online.queue`` before its
  ``system.step``); the evaluator's one serial ``evaluate.upload`` and a
  ``evaluate.prefetch`` between each earlier chunk's replays and fetch,
  over ragged lengths, its results bit for bit one chunk's.
* Under ``profiling.trace(None)``: each span of the main thread is a range
  among ``prof.events()`` that encloses the aten ops issued inside it.
* The recorder itself: its cap, ``measure``, many threads at once, a span
  closed by an exception, a recorder replaced, a wait handed across
  threads, ``summary`` and ``StageTimer``'s records.
* On the card (skipped here): each ``graph.launch`` of a short
  ``run_chunked`` carries a device time, positive and within the run's.
"""
import sys
import threading
import time
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.online import OnlineVO
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.parallel import evaluate
from stereo_visual_odometry_tpu_torch.utils import profiling, synthetic
from stereo_visual_odometry_tpu_torch.utils.config import (CameraConfig, RunConfig,
                                                           rig_from_config)

H, W, FX, FRAMES, CHUNK = 96, 160, 150.0, 5, 2
VO = VOConfig(height=H, width=W, max_features=128, num_hypotheses=64, min_features_track=8,
              min_inlier_rate=0.3)
EVALUATE = {"evaluate.pass", "evaluate.init", "evaluate.chunk", "evaluate.load_wait",
            "evaluate.draws", "evaluate.upload", "evaluate.replays", "evaluate.prefetch",
            "evaluate.fetch", "evaluate.compose"}
CHUNKED = {"run_chunked.chunk", "run_chunked.upload", "run_chunked.sync",
           "run_chunked.replays", "run_chunked.fetch", "run_chunked.unpack"}


@pytest.fixture(scope="module")
def scene():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the suite runs several workers at once
    seqs = [synthetic.render_sequence(n_frames=FRAMES, h=H, w=W, fx=FX, speed=1.0, seed=s)
            for s in range(2)]
    rp = seqs[0]["rig"]
    cam = CameraConfig(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    yield seqs, cam
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_recorder_left():
    yield
    if profiling._recorder is not None:
        profiling._recorder.take()


def run_evaluate(scene, lengths=(FRAMES, FRAMES), chunk=CHUNK):
    seqs, cam = scene
    il = np.stack([s["images_l"] for s in seqs])
    ir = np.stack([s["images_r"] for s in seqs])
    return evaluate.evaluate_batch(il, ir, np.array(lengths), VO,
                                   rig_from_config(cam, device="cpu"), chunk=chunk,
                                   device="cpu")


def run_chunked(scene):
    seqs, cam = scene
    system = System(RunConfig(camera=cam, vo=VO), device="cpu")
    system.run_chunked(list(zip(seqs[0]["images_l"], seqs[0]["images_r"])), chunk=CHUNK)
    return system


def run_online(scene, n=3):
    seqs, cam = scene
    feed = OnlineVO(System(RunConfig(camera=cam, vo=VO), device="cpu"))
    got, deadline = [], time.time() + 120
    try:
        for i in range(n):
            feed.push_pair(0.1 * i, seqs[0]["images_l"][i], seqs[0]["images_r"][i])
        while len(got) < n and time.time() < deadline:
            m = feed.poll(timeout=0.5)
            if m is not None:
                got.append(m)
    finally:
        feed.close()
    assert len(got) == n and not feed._worker.is_alive()
    return got


def by_id(spans):
    return {s["id"]: s for s in spans}


def assert_nested(spans):
    """Every span closed, every child inside its parent, on its thread."""
    ids = by_id(spans)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"], s
        if s["parent"] is not None:
            p = ids[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"], (s, p)
            assert p["thread"] == s["thread"] and p["request"] == s["request"]


# ---- off ------------------------------------------------------------------ #

def test_span_off_is_one_shared_no_op_and_allocates_nothing():
    assert profiling._recorder is None
    assert profiling.span("graph.launch", timed=True) is profiling.span("evaluate.pass")
    assert profiling.begin("online.queue") is None
    assert profiling.within(None) is profiling.span("system.step")
    for _ in range(100):            # warm whatever the interpreter caches
        with profiling.span("graph.replay"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(20_000):
            with profiling.span("graph.replay"):
                pass
            with profiling.span("graph.launch", timed=True):
                pass
            profiling.end(profiling.begin("online.queue"))
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024, grown      # 60,000 spans: nothing kept per span


def test_entry_points_record_nothing_when_off(scene, monkeypatch):
    def refused(*a, **k):
        raise AssertionError("a span was made with the recorder off")
    monkeypatch.setattr(profiling, "Span", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    out = run_evaluate(scene)
    assert len(out["trajectories"]) == 2
    system = run_chunked(scene)
    assert len(system.poses) == FRAMES and system.fps > 0
    run_online(scene)
    assert profiling._recorder is None


# ---- on ------------------------------------------------------------------- #

def test_evaluate_span_tree(scene):
    rec = profiling.record()
    run_evaluate(scene)
    spans = rec.take()
    assert profiling._recorder is None and rec.dropped == 0
    names = Counter(s["name"] for s in spans)
    chunks = -(-(FRAMES - 1) // CHUNK)
    assert set(names) == EVALUATE
    assert names["evaluate.pass"] == names["evaluate.init"] == names["evaluate.upload"] == 1
    assert names["evaluate.prefetch"] == chunks - 1
    assert all(names[n] == chunks for n in EVALUATE - {"evaluate.pass", "evaluate.init",
                                                       "evaluate.upload", "evaluate.prefetch"})
    assert_nested(spans)
    root = next(s for s in spans if s["name"] == "evaluate.pass")
    assert root["parent"] is None and {s["request"] for s in spans} == {root["id"]}
    ids = by_id(spans)
    for s in spans:
        if s["name"] in ("evaluate.init", "evaluate.chunk"):
            assert s["parent"] == root["id"]
        elif s["name"] == "evaluate.load_wait":  # a chunk's load, waited for by its upload
            assert ids[s["parent"]]["name"] in ("evaluate.upload", "evaluate.prefetch")
        elif s is not root:
            assert ids[s["parent"]]["name"] == "evaluate.chunk"
    # the chunks' stages in the loop's order: the first uploads its own frames,
    # every chunk but the last the next one's, between its replays and fetch
    order = sorted((s for s in spans if s["name"] == "evaluate.chunk"), key=lambda s: s["start_ns"])
    kids = [[s["name"] for s in sorted((s for s in spans if s["parent"] == c["id"]),
                                       key=lambda s: s["start_ns"])] for c in order]
    assert kids[0] == ["evaluate.upload", "evaluate.draws", "evaluate.replays",
                       "evaluate.prefetch", "evaluate.fetch", "evaluate.compose"]
    assert kids[-1] == ["evaluate.draws", "evaluate.replays", "evaluate.fetch",
                        "evaluate.compose"]


@pytest.mark.parametrize("chunk", [1, 3])
def test_evaluate_prefetch_order_and_results(scene, chunk):
    """Ragged lengths over several chunks (a short last one with ``chunk``
    3): each of two passes uploads its first chunk alone and every later
    one between the previous chunk's replays and fetch, and the results
    are bit for bit those of one chunk (``chunk = T - 1``: nothing
    prefetched)."""
    lengths = (FRAMES, FRAMES - 1)
    rec = profiling.record()
    whole = run_evaluate(scene, lengths, chunk=FRAMES - 1)
    assert Counter(s["name"] for s in rec.take())["evaluate.prefetch"] == 0
    n_chunks = -(-(FRAMES - 1) // chunk)
    rec = profiling.record()
    got = [run_evaluate(scene, lengths, chunk=chunk) for _ in range(2)]
    spans = rec.take()
    ids = by_id(spans)
    for root in (s for s in spans if s["name"] == "evaluate.pass"):
        mine = [s for s in spans if s["request"] == root["id"]]
        names = Counter(s["name"] for s in mine)
        assert names["evaluate.upload"] == 1 and names["evaluate.prefetch"] == n_chunks - 1
        assert names["evaluate.chunk"] == names["evaluate.replays"] == n_chunks
        for pre in (s for s in mine if s["name"] == "evaluate.prefetch"):
            sib = {s["name"]: s for s in mine if s["parent"] == pre["parent"]}
            assert ids[pre["parent"]]["name"] == "evaluate.chunk"
            assert sib["evaluate.replays"]["end_ns"] <= pre["start_ns"]
            assert pre["end_ns"] <= sib["evaluate.fetch"]["start_ns"]
    assert sum(s["name"] == "evaluate.pass" for s in spans) == 2
    for out in got:
        for a, b, n in zip(out["trajectories"], whole["trajectories"], lengths, strict=True):
            assert a.shape == (n, 4, 4)
            np.testing.assert_array_equal(a, b)
        assert out["accept_rate"] == whole["accept_rate"]


def test_run_chunked_span_tree(scene):
    rec = profiling.record()
    system = run_chunked(scene)
    spans = rec.take()
    assert set(s["name"] for s in spans) == CHUNKED
    assert_nested(spans)
    chunks = [s for s in spans if s["name"] == "run_chunked.chunk"]
    assert len(chunks) == -(-(FRAMES - 1) // CHUNK)
    for c in chunks:
        assert c["parent"] is None and c["request"] == c["id"]
        kids = sorted((s for s in spans if s["parent"] == c["id"]), key=lambda s: s["start_ns"])
        assert [s["name"] for s in kids] == ["run_chunked.upload", "run_chunked.sync",
                                             "run_chunked.replays", "run_chunked.fetch",
                                             "run_chunked.unpack"]
    # the per-frame time is the metric dicts' own (System.fps reads it)
    ts = [m["time_s"] for m in system.metrics[1:]]
    assert system.fps == pytest.approx(len(ts) / sum(ts))


def test_online_span_tree(scene):
    n = 3
    rec = profiling.record()
    run_online(scene, n)
    spans = rec.take()
    names = Counter(s["name"] for s in spans)
    assert names == {"online.queue": n, "system.step": n, "system.fetch": n - 1}
    assert_nested(spans)
    queued = [s for s in spans if s["name"] == "online.queue"]
    steps = {s["request"]: s for s in spans if s["name"] == "system.step"}
    assert len(steps) == n
    for q in queued:
        step = steps[q["request"]]            # the pair's step shares its request id
        assert q["parent"] is None and step["parent"] is None
        assert q["end_ns"] <= step["start_ns"]
        assert q["thread"] != step["thread"]  # put by the producer, got by the worker
    for f in (s for s in spans if s["name"] == "system.fetch"):
        assert by_id(spans)[f["parent"]]["name"] == "system.step"


def test_spans_are_ranges_in_the_profilers_trace(scene):
    """One chunk of one tracked frame profiled (the step alone is ~47k host
    ops): its six spans are ranges, and every aten op that starts in a
    range ends in it."""
    seqs, cam = scene
    system = System(RunConfig(camera=cam, vo=VO), device="cpu")
    system.run_chunked(list(zip(seqs[0]["images_l"][:2], seqs[0]["images_r"][:2])), chunk=1)
    rec = profiling.record()
    with profiling.trace(None) as prof:
        system.run_chunked([(seqs[0]["images_l"][2], seqs[0]["images_r"][2])], chunk=1)
    spans = rec.take()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [e for e in events if e.name in CHUNKED]
    assert Counter(e.name for e in ranges) == Counter(s["name"] for s in spans)
    assert len(ranges) == len(CHUNKED)
    aten = [e for e in events if e.name.startswith("aten::")]
    for r in ranges:
        a, b = r.time_range.start, r.time_range.end
        inside = [e for e in aten if e.thread == r.thread and a <= e.time_range.start <= b]
        assert all(e.time_range.end <= b for e in inside), r.name
        if r.name in ("run_chunked.chunk", "run_chunked.replays"):
            assert inside, r.name     # the step's ops lie in its range


def test_span_ranges_are_host_ops_not_annotations(tmp_path):
    """A span's range is the profiler's host-op kind, not a user annotation,
    which the profiler mirrors onto the card as an event spanning the
    kernels launched inside it (counted as device work by a busy-time
    reading)."""
    import json
    x = torch.rand(32, 32)
    rec = profiling.record()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("graph.replay"):
            x @ x
    rec.take()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    kinds = {e.get("cat") for e in events if e.get("name") == "graph.replay"}
    assert kinds == {"cpu_op"}
    assert [e.name for e in prof.events() if e.name == "graph.replay"] == ["graph.replay"]


# ---- the recorder --------------------------------------------------------- #

def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    rec = profiling.record()
    for _ in range(8):
        with profiling.span("graph.replay"):
            pass
    spans = rec.take()
    assert len(spans) == 5 and rec.dropped == 3
    with profiling.span("graph.replay"):       # off again after take()
        pass
    assert rec.take() == []


def test_measure_times_with_the_recorder_on_or_off():
    with profiling.measure("graph.capture") as sp:
        time.sleep(0.01)
    assert sp.seconds >= 0.01 and sp.parent is None
    rec = profiling.record()
    with profiling.span("graph.replay"):
        with profiling.measure("graph.capture") as sp:
            time.sleep(0.01)
    spans = rec.take()
    assert [s["name"] for s in spans] == ["graph.capture", "graph.replay"]
    assert spans[0]["parent"] == spans[1]["id"]
    assert spans[0]["end_ns"] - spans[0]["start_ns"] == pytest.approx(1e9 * sp.seconds)


def test_many_threads_record_their_own_trees():
    """16 threads, each 200 roots of two children, with a short switch
    interval: every span kept once, with its own thread's parent."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    rec = profiling.record()
    try:
        def work():
            for _ in range(200):
                with profiling.span("run_chunked.chunk"):
                    with profiling.span("run_chunked.upload"):
                        pass
                    with profiling.span("run_chunked.replays"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = rec.take()
    assert len(spans) == 16 * 200 * 3 and len(by_id(spans)) == len(spans)
    assert_nested(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert len(roots) == 16 * 200 and all(s["request"] == s["id"] for s in roots)


def test_an_exception_closes_the_span_and_unwinds_the_stack():
    rec = profiling.record()
    with pytest.raises(ValueError):
        with profiling.span("run_chunked.chunk"):
            with profiling.span("run_chunked.upload"):
                raise ValueError("bad pair")
    with profiling.span("run_chunked.chunk"):
        pass
    spans = rec.take()
    assert [s["name"] for s in spans] == ["run_chunked.upload", "run_chunked.chunk",
                                          "run_chunked.chunk"]
    assert_nested(spans)
    assert spans[0]["parent"] == spans[1]["id"]
    assert spans[2]["parent"] is None and spans[2]["request"] == spans[2]["id"]
    assert profiling._stack() == []


def test_record_replaces_the_recorder_on():
    first = profiling.record()
    with profiling.span("graph.replay"):
        pass
    second = profiling.record()
    with profiling.span("graph.launch"):
        pass
    assert [s["name"] for s in first.take()] == ["graph.replay"]
    assert profiling._recorder is second      # the old one's take() leaves it on
    spans = second.take()
    assert [s["name"] for s in spans] == ["graph.launch"] and spans[0]["id"] == 1
    assert profiling._recorder is None


def test_begin_and_end_across_threads_hand_on_the_request():
    """A wait opened on one thread and closed on another (``online.queue``):
    the roots the other thread opens ``within`` it take its request id, and
    only inside."""
    rec = profiling.record()
    queued = profiling.begin("online.queue")
    assert queued.parent is None and queued.request == queued.id

    def worker():
        profiling.end(queued)
        with profiling.within(queued):
            with profiling.span("system.step"):
                with profiling.span("system.fetch"):
                    pass
        with profiling.span("system.step"):
            pass
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    spans = rec.take()
    assert [s["name"] for s in spans] == ["online.queue", "system.fetch", "system.step",
                                          "system.step"]
    assert_nested(spans)
    q, fetch, step, later = spans
    assert fetch["request"] == step["request"] == q["request"]
    assert later["request"] == later["id"] != q["request"]
    assert q["end_ns"] <= step["start_ns"] and q["thread"] == threading.get_ident() != step["thread"]


def test_a_span_closed_after_take_is_not_kept():
    rec = profiling.record()
    queued = profiling.begin("online.queue")
    assert rec.take() == []
    profiling.end(queued)                     # the recorder is off: nothing kept
    assert rec.take() == [] and queued.end_ns is None


def test_each_thread_nests_only_in_its_own_spans():
    """A span another thread opens while this thread's span is open is a
    root of its own, not its child."""
    rec = profiling.record()
    opened, closed = threading.Event(), threading.Event()

    def worker():
        opened.wait(timeout=30)
        with profiling.span("system.step"):
            pass
        closed.set()
    t = threading.Thread(target=worker)
    t.start()
    with profiling.span("evaluate.pass"):
        opened.set()
        assert closed.wait(timeout=30)
    t.join(timeout=30)
    step, root = rec.take()
    assert step["name"] == "system.step" and root["name"] == "evaluate.pass"
    assert step["parent"] is None and step["request"] == step["id"] != root["request"]


def test_summary_reads_device_time_where_a_span_has_it():
    spans = [profiling.Span("graph.launch", 0, 2_000_000, device_ms=30.0),
             profiling.Span("graph.launch", 0, 4_000_000, device_ms=10.0),
             profiling.Span("graph.replay", 0, 5_000_000)]
    got = profiling.summary(spans)
    assert got["graph.launch"] == {"total_s": pytest.approx(0.04), "calls": 2,
                                   "mean_ms": pytest.approx(20.0)}
    assert got["graph.replay"] == {"total_s": pytest.approx(0.005), "calls": 1,
                                   "mean_ms": pytest.approx(5.0)}


def test_stage_timer_keeps_its_stages_as_spans():
    """``StageTimer`` times every stage whether a recorder is on or not, as
    the module's ``Span``, and leaves the recorder's records alone."""
    timer = profiling.StageTimer(device="cpu")
    rec = profiling.record()
    for pause in (0.002, 0.002):
        with timer.stage("track"):
            time.sleep(pause)
    with timer.stage("detect"):
        time.sleep(0.03)
    assert rec.take() == []
    assert [type(sp) for sp in timer.spans] == [profiling.Span] * 3
    assert [sp.name for sp in timer.spans] == ["track", "track", "detect"]
    assert all(sp.device_ms is None and sp.seconds >= 0.002 for sp in timer.spans)
    assert timer.summary()["track"]["calls"] == 2
    assert [line.split()[0] for line in timer.report().splitlines()] == ["detect", "track"]


# ---- on the card ---------------------------------------------------------- #

@pytest.mark.cuda
def test_graph_launch_carries_device_time(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    seqs, cam = scene
    system = System(RunConfig(camera=cam, vo=VO), device="cuda")
    rec = profiling.record()
    t0 = time.perf_counter_ns()
    system.run_chunked(list(zip(seqs[0]["images_l"], seqs[0]["images_r"])), chunk=CHUNK)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter_ns() - t0) / 1e6
    spans = rec.take()
    launches = [s for s in spans if s["name"] == "graph.launch"]
    assert len(launches) == FRAMES - 1
    assert all(0 < s["device_ms"] <= wall_ms for s in launches)
    ids = by_id(spans)
    assert all(ids[s["parent"]]["name"] == "graph.replay" for s in launches)
    captures = [s for s in spans if s["name"] == "graph.capture"]
    assert len(captures) == 1
    assert (captures[0]["end_ns"] - captures[0]["start_ns"]) / 1e9 == \
        pytest.approx(system.graph.capture_s)
