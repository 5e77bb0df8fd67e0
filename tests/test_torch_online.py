"""The online feed (``models/online.py``) against the JAX package's
``OnlineVO``: the same pushes give the same pairs, in the same order, with
the same drops.

Both feeds drive a stand-in ``System`` that records which frames each step
got (frames are tiny arrays carrying their id), so the comparison is of the
policy alone: ApproximateTime pairing within ``slop`` with jitter and
either side first, unpaired frames, the per-side buffer's eviction past
``maxlen``, a burst into a full queue (``maxlen=2``) while the worker is
held in a step. Then one real port ``System`` on the CPU (192x256, 6
frames) behind the feed: its trajectory equals ``System.run`` on the same
frames bit for bit (the same steps in the same order, the same generator).
"""
import threading
import time

import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models.online import OnlineVO as JOnlineVO
from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.online import OnlineVO
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.utils import synthetic
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig


class Recorder:
    """A stand-in ``System``: each step records the ids of its pair; while
    ``gate`` is clear a step waits in it."""

    device = torch.device("cpu")

    def __init__(self, fail=False):
        self.seen = []
        self.entered = threading.Event()
        self.gate = threading.Event()
        self.gate.set()
        self.fail = fail

    def step_online(self, il, ir):
        self.entered.set()
        self.gate.wait(60)
        if self.fail:
            raise ValueError("a step that fails")
        self.seen.append((int(il[0, 0]), int(ir[0, 0])))
        return {"pair": self.seen[-1]}


def frame(i):
    return np.full((2, 2), i, np.int32)


def drain(vo, n=None, timeout=60.0):
    """Poll results until ``n`` have come (or, without ``n``, until none
    comes for half a second)."""
    out, deadline = [], time.time() + timeout
    while (n is None or len(out) < n) and time.time() < deadline:
        r = vo.poll(timeout=0.5)
        if r is None and n is None:
            break
        if r is not None:
            out.append(r)
    return out


def jittered_pushes(seed=0):
    """(side, ts, id) pushes: ten pairs with jitter inside slop 0.02, either
    side first; an unpaired left; 20 lefts with no right (the buffer keeps
    the newest 16), then rights for evicted and kept lefts; two lefts within
    slop of one right (the closer one pairs)."""
    rng = np.random.default_rng(seed)
    pushes = []
    for i in range(10):
        t = round(0.1 * i, 6)
        left, right = ("L", t, i), ("R", t + float(rng.uniform(-0.015, 0.015)), 100 + i)
        pushes += [left, right] if rng.random() < 0.5 else [right, left]
    pushes.append(("L", 10.0, 50))
    pushes += [("L", 20.0 + 0.1 * k, 60 + k) for k in range(20)]
    pushes += [("R", 20.0, 160), ("R", 20.1, 161), ("R", 21.9, 179), ("R", 21.5, 175)]
    pushes += [("L", 30.0, 80), ("L", 30.015, 81), ("R", 30.01, 180), ("R", 30.02, 181)]
    return pushes


def feed(make, pushes, **kw):
    rec = Recorder()
    vo = make(rec, **kw)
    try:
        for side, ts, i in pushes:
            (vo.push_left if side == "L" else vo.push_right)(ts, frame(i))
        results = drain(vo)
    finally:
        vo.close()
    return [(r["ts"], r["pair"]) for r in results], vo.dropped, vo


@pytest.mark.parametrize("seed", [0, 1])
def test_pairing_matches_jax(seed):
    pushes = jittered_pushes(seed)
    ours, dropped, vo = feed(OnlineVO, pushes, slop=0.02)
    theirs, jdropped, _ = feed(JOnlineVO, pushes, slop=0.02)
    assert ours == theirs and dropped == jdropped == 0
    pairs = [p for _, p in ours]
    assert pairs[:10] == [(i, 100 + i) for i in range(10)]  # one per frame, in order
    assert (50, 150) not in pairs and (60, 160) not in pairs and (61, 161) not in pairs
    assert (79, 179) in pairs and (75, 175) in pairs and pairs[-2:] == [(81, 180), (80, 181)]
    assert not vo._worker.is_alive()


def burst(make):
    """Hold the worker in its first step, then push six more pairs into a
    queue of two: returns (results, dropped, the longest push in s)."""
    rec = Recorder()
    rec.gate.clear()
    vo = make(rec, slop=0.02, maxlen=2)
    longest = 0.0
    try:
        vo.push_pair(0.0, frame(0), frame(100))
        assert rec.entered.wait(30)
        for i in range(1, 7):
            t0 = time.perf_counter()
            vo.push_right(0.1 * i + 0.005, frame(100 + i))
            vo.push_left(0.1 * i, frame(i))
            longest = max(longest, time.perf_counter() - t0)
        rec.gate.set()
        results = drain(vo, n=3)
        assert drain(vo) == []
    finally:
        rec.gate.set()
        vo.close()
    return [(r["ts"], r["pair"]) for r in results], vo.dropped, longest, vo


def test_burst_drops_and_never_blocks_like_jax():
    ours, dropped, longest, vo = burst(OnlineVO)
    theirs, jdropped, _, _ = burst(JOnlineVO)
    assert ours == theirs == [(0.0, (0, 100)), (0.1, (1, 101)), (0.2, (2, 102))]
    assert dropped == jdropped == 4
    assert longest < 0.5, longest  # a full queue drops, it does not wait
    assert not vo._worker.is_alive()


def test_worker_error_reaches_the_caller():
    rec = Recorder(fail=True)
    vo = OnlineVO(rec)
    vo.push_pair(0.0, frame(0), frame(1))
    deadline = time.time() + 30
    while vo._worker.is_alive() and time.time() < deadline:
        time.sleep(0.05)
    with pytest.raises(RuntimeError, match="online worker") as info:
        vo.poll()
    assert isinstance(info.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="online worker"):
        vo.close()
    assert not vo._worker.is_alive()


def test_online_system_equals_run():
    """A real port ``System`` behind the feed: 6 frames pushed left and
    right with jitter inside slop, either side first; 6 results with ts in
    order, none dropped, and the trajectory of ``System.run`` bit for bit."""
    n = 6
    seq = synthetic.render_sequence(n_frames=n, h=192, w=256, fx=300.0, speed=1.0)
    rp = seq["rig"]
    cfg = RunConfig(camera=CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"],
                                        baseline=rp["baseline"]),
                    vo=VOConfig(height=192, width=256, max_features=256, num_hypotheses=128,
                                min_features_track=8, min_inlier_rate=0.3))
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the suite runs several workers at once
    try:
        sys_ = System(cfg, device="cpu")
        vo = OnlineVO(sys_, slop=0.02)
        try:
            for i in range(n):
                t = 0.1 * i
                pair = [(vo.push_left, t, seq["images_l"][i]),
                        (vo.push_right, t + 0.004 * (-1) ** i, seq["images_r"][i])]
                for push, ts, img in (pair if i % 2 else pair[::-1]):
                    push(ts, img)
            results = drain(vo, n=n, timeout=300)
        finally:
            vo.close()
        assert not vo._worker.is_alive()
        ts = [r["ts"] for r in results]  # the later push's stamp of each pair
        assert ts == sorted(ts) and np.allclose(ts, 0.1 * np.arange(n), atol=0.005)
        assert vo.dropped == 0 and [r["init"] for r in results] == [True] + [False] * (n - 1)
        want = System(cfg, device="cpu").run(list(zip(seq["images_l"], seq["images_r"])))
        np.testing.assert_array_equal(np.stack(sys_.poses), want)
    finally:
        torch.set_num_threads(threads)
