"""The metric arithmetic, the reference's comparison, the control, and
BENCHMARK.json against the files the harness finds by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vobench import arith, reference, render, run
from vobench.drivers.evaluate_batch import batch_view

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
H100 = "NVIDIA H100 80GB HBM3"


def test_percentile_is_nearest_rank():
    values = list(range(1, 21))
    assert arith.percentile(values, 95) == 19
    assert arith.percentile(values, 50) == 10
    assert arith.percentile([7.5], 95) == 7.5
    assert arith.percentile(list(range(300)), 95) == 284   # 15 values above it


def test_union_busy_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert arith.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert arith.busy(iv) == 3.0
    assert arith.idle_share(3.0, 4.0) == pytest.approx(25.0)


def test_readers_window_accounting():
    """frames/s is every frame completed over the window; the latency percentiles take
    every frame, a dropped one with the age it reached."""
    read = {name: run.reader(name) for name in ("frames_per_s", "frame_ms_p95.latency",
                                                "frame_ms_p50.latency", "device_idle.frames")}
    assert read["frames_per_s"]({"frames": 715 * 6, "window_s": 33.0}) == pytest.approx(130.0)
    # An online feed's window: the pairs it dropped are not completed.
    assert read["frames_per_s"]({"frames": 300, "completed": 297, "window_s": 30.0}) == \
        pytest.approx(9.9)
    lat = [0.04] * 280 + [0.5] * 20
    assert read["frame_ms_p95.latency"]({"latencies_s": lat}) == pytest.approx(500.0)
    assert read["frame_ms_p50.latency"]({"latencies_s": lat}) == pytest.approx(40.0)
    assert read["device_idle.frames"]({"stretch": {"busy_s": 0.3, "window_s": 0.4}}) == \
        pytest.approx(25.0)
    assert read["device_idle.frames"]({"stretch": {"busy_s": 0.0, "window_s": 0.4}}) is None
    assert read["device_idle.frames"]({}) is None


def test_k1_k2_bounds_at_the_kernel_tables_shapes():
    """K1 at S = 24, N = 1024 on (408, 1408) and K2 at P = 39, N = 445 on
    (384, 1280), corners uniform as the patch probe draws them: the table's
    1.142 and 1.242 us (bytes-bound), to the spread of random corners."""
    g = torch.Generator().manual_seed(24)
    hp, wp, s, n = 408, 1408, 24, 1024
    corners = torch.stack([torch.randint(0, hp - s + 1, (n,), generator=g),
                           torch.randint(0, wp - s + 1, (n,), generator=g)], -1).int()
    k1 = arith.least_seconds(*arith.k1_work((hp, wp), corners, s, s), H100)
    assert k1 == pytest.approx(1.142e-6, rel=0.01)
    h, w, p, n = 384, 1280, 39, 445
    xy = torch.tensor([19.0, 19.0]) + torch.rand((n, 2), generator=g) * torch.tensor(
        [w - 39.0, h - 39.0])
    n_bytes, flops = arith.k2_work((h, w), xy, p)
    assert flops / 67e12 < n_bytes / 3.35e12
    assert arith.least_seconds(n_bytes, flops, H100) == pytest.approx(1.242e-6, rel=0.01)
    assert arith.least_seconds(n_bytes, flops, "another card") is None


def test_k1_work_batched_is_the_sum_of_its_images():
    g = torch.Generator().manual_seed(1)
    corners = torch.randint(-3, 90, (3, 50, 2), generator=g).int()
    whole = arith.k1_work((3, 96, 128), corners, 7, 9)
    parts = [arith.k1_work((96, 128), c, 7, 9) for c in corners]
    assert whole == (sum(p[0] for p in parts), 0)


def test_judge_and_control():
    """The truth judges to nothing. The pose numbers' control (the true
    answers rounded to bfloat16) reads under every cell's limits: the VO's
    own error per frame is larger, so the kernels' control is the precision
    check (test_reference_kernels). A step that leaves its state unchanged
    (every answer no motion) fails every cell's pose limits."""
    for name in CELLS:
        spec = run.cell_spec(name)
        traffic = spec["traffic"]
        lap = render.circuit_poses(traffic["circuit"])
        if "frames_per_sequence" in traffic:
            L, S = traffic["frames_per_sequence"], traffic["sequences"]
            stride = len(lap) // S
            frames = [s * stride + np.arange(L) for s in range(S)]
        else:
            seg = traffic["segment_frames"]
            frames = [17 + np.arange(i, i + seg) for i in range(0, 4 * seg, seg)]
        truth = reference.judge([(f, reference.truth(lap, f)) for f in frames], lap)
        assert truth["ate_max_m"] < 1e-9 and truth["step_trans_max_m"] < 1e-9
        assert truth["step_rot_max_rad"] < 1e-12
        control = reference.judge([(f, reference.control_chain(lap, f)) for f in frames], lap)
        assert control["step_trans_max_m"] < 0.01 and control["step_rot_max_rad"] < 1e-3
        assert control["ate_max_m"] < 0.05
        pose_limits = {k: v for k, v in spec["limits"].items() if k in truth}
        assert len(pose_limits) == 3
        still = reference.judge([(f, np.tile(np.eye(4), (len(f), 1, 1))) for f in frames], lap)
        assert all(still[k] > v for k, v in pose_limits.items()), (name, still)


def test_angle_reads_the_turn_not_the_rounding():
    """A rotation's angle from its skew part: exact for a rotation, and a
    matrix rounded to bfloat16 reads about its own angle (arccos of the
    trace would read ~0.09 rad for the rounding of 1.0 alone)."""
    for a in (0.0, 1e-4, 0.0098, 0.5, 3.0):
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        assert reference.angle(R) == pytest.approx(a, abs=1e-12)
        rounded = torch.as_tensor(R).to(torch.bfloat16).double().numpy()
        assert abs(reference.angle(rounded) - a) < 0.005 * max(a, 0.01)


def test_reference_kernels():
    """``windows`` and ``patches`` against the program's plain versions on
    random calls (batched and not, corners and centres past the edges):
    K1 bit for bit, K2 to float32 rounding; in bfloat16 both differ by
    about a grey level."""
    from stereo_visual_odometry_tpu_torch.ops import patch
    g = torch.Generator().manual_seed(16)
    imgs = torch.rand((3, 40, 56), generator=g) * 255
    rc = torch.stack([torch.randint(-4, 40, (3, 50), generator=g),
                      torch.randint(-4, 56, (3, 50), generator=g)], -1).int()
    xy = torch.stack([torch.rand((3, 50), generator=g) * 64 - 4,
                      torch.rand((3, 50), generator=g) * 48 - 4], -1)
    for b in range(3):
        want = patch.extract_windows_int_reference(imgs[b], rc[b], (9, 7))
        assert torch.equal(reference.windows(imgs[b], rc[b], 9, 7).float(), want)
        assert torch.equal(reference.windows(imgs, rc, 9, 7)[b].float(), want)
        want = patch.extract_patches_clamped(imgs[b], xy[b], 11).double()
        assert (reference.patches(imgs[b], xy[b], 11) - want).abs().max() < 1e-4
        assert (reference.patches(imgs, xy, 11)[b] - want).abs().max() < 1e-4
    assert (reference.windows(imgs, rc, 9, 7, torch.bfloat16).double()
            - reference.windows(imgs, rc, 9, 7)).abs().max() > 0.1
    assert (reference.patches(imgs, xy, 11, torch.bfloat16).double()
            - reference.patches(imgs, xy, 11)).abs().max() > 0.1


def test_kernel_errors_skip_carried_state():
    """A recorded call whose input is a buffer of the carried state is not
    checked (the step overwrites it after the kernel read it); the others
    are, and a wrong output shows."""
    img, other = torch.rand((20, 30)) * 255, torch.rand((20, 30)) * 255
    rc = torch.tensor([[0, 0], [5, 9], [19, 29]], dtype=torch.int32)
    good = reference.windows(img, rc, 4, 4).float()
    calls = type("Calls", (), {})()
    wrong = reference.windows(other, rc, 4, 4).float() + 1
    calls.k1 = [(img, rc, 4, 4, good), (other, rc, 4, 4, wrong)]
    got = reference.kernel_errors(calls, [{"pyr": [other]}])
    assert got["k1_err"] == 0.0 and got["k1_checked"] == 1 and got["k1_skipped"] == 1
    got = reference.kernel_errors(calls)
    assert got["k1_err"] == pytest.approx(1.0, abs=1e-4) and got["k1_checked"] == 2
    assert got["k2_err"] is None and got["k2_checked"] == 0


def test_passes_holds_every_limit():
    assert run.passes({"a": 1.0, "b": 0.0, "c": 9.0}, {"a": 1.0, "b": 0.0})
    assert not run.passes({"a": 1.1, "b": 0.0}, {"a": 1.0, "b": 0.0})
    assert not run.passes({"a": 1.0, "b": 1e-9}, {"a": 1.0, "b": 0.0})
    assert not run.passes({"a": None}, {"a": 1.0}) and not run.passes({}, {"a": 1.0})


def test_segments_drop_the_partial_one():
    frames, poses = np.arange(10, 150), np.tile(np.eye(4), (140, 1, 1))
    segs = reference.segments(frames, poses, 65)
    assert [len(f) for f, _ in segs] == [65, 65] and segs[1][0][0] == 75


def test_batch_view_is_a_view():
    frames = np.arange(20 * 2 * 3, dtype=np.float32).reshape(20, 2, 3)
    v = batch_view(frames, 4, 3, 6)
    assert v.shape == (3, 6, 2, 3) and np.shares_memory(v, frames)
    assert np.array_equal(v[2, 1], frames[9])
    with pytest.raises(ValueError):
        batch_view(frames, 8, 3, 6)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_and_its_files():
    """The contract's keys and names, and every file the harness finds by
    name: configurations, traffic (with its driver), limits, readers."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "vobench" / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        traffic = json.loads((ROOT / "vobench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "vobench" / "drivers" / f"{traffic['driver']}.py").exists()
        assert (ROOT / "vobench" / "circuits" / f"{traffic['circuit']}.json").exists()
        assert json.loads((ROOT / "vobench" / "limits" / f"{w['name']}.json").read_text())
        e2e = {m["name"] for m in run.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = run.metrics_for(BENCH, w["name"], True)
        assert per_layer and all(p["moves"] in e2e for p in per_layer)
