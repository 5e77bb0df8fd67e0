"""The BA cell's driver (``drivers/run_frames.py``) at a tiny size on the
CPU: a sound run is correct, traced too; the control (the reference's solve
in bfloat16 in the timed solve's place) and two planted faults (the prior
left out of one solve in every four; the prior carried undecayed) are not,
by the window-solve and prior numbers; a program whose backend keeps no log
and a configuration without a backend are refused; each new metric reader
returns None when it has nothing to read. On the card: a short run of the
cell."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vobench import control_ba, run
from vobench.drivers import run_frames
from vobench.tests.tiny import CIRCUIT, LIMITS, SEED, SENSOR

WORKLOAD = "lk_ba.seq_s1"
# A 3-keyframe window every 2 frames reaches its first marginalized solve
# after 1 + 3 * 2 + 2 = 9 frames.
BACKEND = {"window": 3, "kf_every": 2, "max_landmarks": 256, "max_obs": 2048}
BA_LIMITS = {"ba_cost_excess": 1e-3, "ba_pose_err_m": 5e-3, "ba_rot_err_rad": 1e-3,
             "ba_prior_err": 5e-3}


@pytest.fixture(autouse=True)
def tiny_backend(monkeypatch):
    real = run_frames.backend_config
    monkeypatch.setattr(run_frames, "backend_config", lambda name: dict(real(name), **BACKEND))


def run_tiny(seconds=3.0, trace=False, calls=None, traffic=None):
    torch.set_num_threads(2)
    overrides = {"config": {"sensor": SENSOR,
                            "vo": {"height": 128, "width": 416, "max_features": 256}},
                 "traffic": dict({"circuit": CIRCUIT, "warm_frames": 9, "segment_frames": 4,
                                  "trace_frames": 4}, **(traffic or {})),
                 "limits": dict(LIMITS, **BA_LIMITS)}
    return run.run_cell(WORKLOAD, SEED, seconds, trace, [torch.device("cpu")], overrides,
                        calls=calls)


def test_sound_run_is_correct():
    out = run_tiny()
    assert out["correct"], out["numbers"]
    n = out["numbers"]
    assert n["segments"] >= 2 and n["k1_checked"] > 0 and n["k1_err"] == 0.0
    assert n["ba_checked"] == 4 and n["ba_pose_err_m"] < 1e-3
    # float32 against float64 through a chain of slides: 9e-4 here, the
    # prior carried undecayed 3e-2.
    assert n["ba_prior_checked"] >= 2 and n["ba_prior_err"] < 2e-3
    assert out["solves_per_frame"] > 0.3          # a solve every kf_every frames
    assert out["window_s"] >= 3.0 and out["setup_s"] > 0


def test_traced_run_reads_the_backend_spans():
    out = run_tiny(seconds=2.0, trace=True)
    assert out["correct"], out["numbers"]
    names = {s["name"] for s in out["spans"]}
    assert {"backend.solve", "backend.lm", "backend.keyframe"} <= names
    metrics = run.result(out, run.cell_spec(WORKLOAD)["bench"], WORKLOAD, True,
                         [torch.device("cpu")])["metrics"]
    # No card: the solves profiled alone record no device op.
    assert set(metrics) == {"ba_share.ba", "ba_solve_ms_p50.ba"}
    assert 0 < metrics["ba_share.ba"]["value"] < 100
    assert len(out["solves"]) == 3 and out["stretch"]["window_s"] > 0


FAULTS = {"bf16": lambda: control_ba.SolveCalls(ba=control_ba.bf16_solve),
          "no_prior": lambda: control_ba.SolveCalls(ba=control_ba.DroppedPrior()),
          "undecayed": lambda: control_ba.SolveCalls(backend={"prior_decay": 1.0})}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_control_and_fault_are_not_correct(fault):
    out = run_tiny(calls=FAULTS[fault]())
    assert not out["correct"]
    failed = {k for k, v in BA_LIMITS.items() if not out["numbers"][k] <= v}
    assert failed, out["numbers"]


def test_a_backend_without_log_is_refused(monkeypatch):
    from stereo_visual_odometry_tpu_torch.models import backend
    monkeypatch.setattr(backend.SlidingWindowBA, "__init__", lambda self, *a, **k: None)
    with pytest.raises(ValueError, match="keeps no log"):
        run_tiny()


def test_a_configuration_without_backend_is_refused():
    with pytest.raises(ValueError, match="no.*backend|has none"):
        run_tiny(traffic={"backend_of": "lk_dense"})


@pytest.mark.parametrize("name", ["ba_share.ba", "ba_solve_ms_p50.ba", "ba_solve_idle.ba",
                                  "ba_solve_ops.ba"])
def test_readers_return_none_with_nothing_to_read(name):
    read = run.reader(name)
    assert read({}) is None
    assert read({"spans": [], "solves": [], "window_s": 1.0}) is None
    # The parent program records no backend span; a CPU run no device op.
    other = [{"name": "system.step", "id": 1, "parent": None, "start_ns": 0, "end_ns": 10}]
    assert read({"spans": other, "solves": [{"busy_s": 0.0, "wall_s": 0.1, "ops": 0}],
                 "window_s": 1.0}) is None


def test_readers_arithmetic():
    spans = [{"name": "backend.solve", "id": 1, "parent": None, "start_ns": 0,
              "end_ns": 200_000_000, "device_ms": 200.0},
             {"name": "backend.lm", "id": 2, "parent": 1, "start_ns": 1, "end_ns": 2},
             {"name": "backend.solve", "id": 3, "parent": None, "start_ns": 0,
              "end_ns": 1_000_000},                  # a window too small: no solve
             {"name": "backend.marginalize", "id": 4, "parent": None, "start_ns": 0,
              "end_ns": 99_000_000}]
    solves = [{"busy_s": 0.01, "wall_s": 0.2, "ops": 100}, {"busy_s": 0.03, "wall_s": 0.2,
                                                            "ops": 200}]
    got = {n: run.reader(n)({"spans": spans, "solves": solves, "window_s": 3.0})
           for n in ("ba_share.ba", "ba_solve_ms_p50.ba", "ba_solve_idle.ba", "ba_solve_ops.ba")}
    assert got == pytest.approx({"ba_share.ba": 10.0, "ba_solve_ms_p50.ba": 200.0,
                                 "ba_solve_idle.ba": 90.0, "ba_solve_ops.ba": 150.0})


@pytest.mark.cuda
def test_card_run():
    """A short run of the cell on the card: correct, with its end-to-end
    metrics and the window-solve numbers checked."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", WORKLOAD,
                           "--seed", "3000000001", "--seconds", "8", "--trace", "0"],
                          cwd=Path(__file__).resolve().parents[2], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert {"ba_cost_excess", "ba_pose_err_m", "ba_rot_err_rad"} <= set(out["checks"])
