"""The window solve (``models/ba.py``'s ``bundle_adjust``) and the prior a
slide builds (``models/marg.py``) against their plain float64 reference
(``vobench/reference_ba.py``, the benchmark's), and the BA backend's spans
and counters, on the CPU; no JAX.

* The solve against the reference on seeded random windows
  (``torch_ba_windows``): Huber only; graduated non-convexity with prune and
  re-polish; the same with a carried prior; each with the right camera's
  observations and without. Tolerances are the spread measured between the
  port's solve and the JAX solve on the card (poses 5e-3 absolute, landmarks
  3e-3 relative, costs 1e-4 relative; the distributed solve's card test
  holds the same): float32 against float64 reads 2e-5, 2e-4 and 5e-6 here,
  and the reference in bfloat16, the control, misses every one (0.03-0.4
  on the poses). The pruned observations are the same ones.
* The reference itself: the fixed pose does not move; a phase's cost never
  rises as it runs more steps (a step is kept only if it lowers the cost).
* The prior a slide leaves, as the backend builds it (the carried prior
  shifted to the window's poses and decayed by half, then ``build_prior``)
  against the reference's, within 1e-4 (``reference_ba.prior_gap``;
  float32 reads 1e-6 to 2e-5 here); the same build carrying its prior
  undecayed misses it more than tenfold (6e-3 to 2e-2).
* A ``System`` with a backend at a small size: each ``backend.solve`` span
  holds ``backend.problem``, ``backend.lm`` and ``backend.fetch``; a slide's
  ``backend.marginalize`` sits in ``backend.keyframe``; each solve's
  ``m["ba"]`` counts its LM steps (``lm_iters`` >= ``lm_accepted``); with
  the recorder off the poses and ``m["ba"]`` are those of a recorded run.
"""
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.models import ba, marg
from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.utils import profiling, synthetic
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig
from torch_ba_windows import on, window
from vobench import reference_ba as plain

POSE_ATOL, POINT_RTOL, COST_RTOL = 5e-3, 3e-3, 1e-4
SOLVES = {"huber": dict(gm_polish=False, prune_px=None),
          "gnc": dict(gm_polish=True, prune_px=8.0),
          "prior": dict(gm_polish=True, prune_px=8.0)}
CASES = [(s, st) for s in SOLVES for st in (True, False)]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


def _problem(solve, stereo, seed=7):
    w = window(seed, stereo=stereo, outliers=0 if solve == "huber" else 10,
               prior=solve == "prior")
    return dict(on(w["kw"]), n_iters=8, n_fixed=1, huber_px=2.0, **SOLVES[solve])


def _misses(got: dict, want: dict) -> list[str]:
    """The tolerances ``got`` misses against the float64 ``want``."""
    out = []
    if not (got["poses"].double() - want["poses"]).abs().max() <= POSE_ATOL:
        out.append("poses")
    gap = (got["points"].double() - want["points"]).abs()
    if not (gap <= POINT_RTOL * (1.0 + want["points"].abs())).all():
        out.append("points")
    for k in ("cost_initial", "cost_final"):
        if not abs(float(got[k]) - float(want[k])) <= COST_RTOL * abs(float(want[k])):
            out.append(k)
    return out


@pytest.mark.parametrize("solve,stereo", CASES,
                         ids=[f"{s}-{'stereo' if st else 'mono'}" for s, st in CASES])
def test_bundle_adjust_matches_the_plain_reference(solve, stereo):
    kw = _problem(solve, stereo)
    got = ba.bundle_adjust(**kw)
    want = plain.bundle_adjust(**kw)
    assert _misses(got, want) == []
    assert torch.equal(got["obs_w"] > 0, want["obs_w"] > 0)
    assert int(got["lm_iters"]) == want["lm_iters"] == (8 if solve == "huber" else 20)
    assert 0 < int(got["lm_accepted"]) <= int(got["lm_iters"])
    # The control: the same reference in bfloat16 misses the tolerances.
    assert _misses(plain.bundle_adjust(**kw, dtype=torch.bfloat16), want)


def test_reference_holds_the_fixed_pose_and_never_raises_the_cost():
    kw = _problem("prior", True)
    out = plain.bundle_adjust(**kw)
    assert torch.equal(out["poses"][0], kw["poses"][0].double())
    assert float(out["cost_final"]) < float(out["cost_initial"])
    pb = plain.Problem(kw["cam"], kw["poses"], kw["points"], kw["obs_kf"], kw["obs_lm"],
                       kw["obs_uv"], kw["obs_w"], kw["obs_right"], kw["T_rl"], kw["prior"])
    costs = [float(plain._phase(pb, pb.poses0, pb.points0, pb.w, "huber", 2.0, n, 1, 1e-3)[3])
             for n in range(7)]
    assert all(np.isfinite(costs)) and costs == sorted(costs, reverse=True)
    assert costs[-1] < costs[0]


PRIOR_GAP = 1e-4


def _program_prior(kw: dict, decay: float) -> dict:
    """The prior the backend builds at a slide of the window ``kw`` (its K
    poses the window before the slide, every landmark consumed), carrying
    ``kw``'s prior over the first K - 1 slots."""
    K = kw["poses"].shape[0]
    W = K - 1
    carried = {k: v[:W, :W] if k == "H" else v[:W] for k, v in kw["prior"].items()}
    H_s, b_s = marg.shift_prior(carried, kw["poses"][:W])
    carry_H = H_s.new_zeros((K, K, 6, 6))
    carry_H[:W, :W] = decay * H_s
    carry_b = b_s.new_zeros((K, 6))
    carry_b[:W] = decay * b_s
    out = marg.build_prior(kw["cam"], kw["poses"], kw["points"], kw["obs_kf"], kw["obs_lm"],
                           kw["obs_uv"], kw["obs_w"], 2.0, kw["obs_right"], kw["T_rl"],
                           carry_H, carry_b)
    return {k: v[:W, :W] if k == "H" else v[:W] for k, v in out.items()}, carried


@pytest.mark.parametrize("stereo", [True, False], ids=["stereo", "mono"])
def test_prior_build_matches_the_plain_reference(stereo):
    kw = _problem("prior", stereo, seed=11)
    got, carried = _program_prior(kw, 0.5)
    want = plain.build_prior(kw["cam"], kw["poses"], kw["points"], kw["obs_kf"], kw["obs_lm"],
                             kw["obs_uv"], kw["obs_w"], 2.0, kw["obs_right"], kw["T_rl"],
                             carried=carried, decay=0.5)
    assert want["H"].dtype == torch.float64 and want["H"].shape == got["H"].shape
    assert torch.equal(want["T_lin"], kw["poses"][1:].double())
    assert bool(want["mask"].all()) and bool(got["mask"].all())
    assert plain.prior_gap(got, want) <= PRIOR_GAP
    # The planted fault: the same build carrying its prior undecayed.
    assert plain.prior_gap(_program_prior(kw, 1.0)[0], want) > 10 * PRIOR_GAP


# ---------------------------------------------------------------------- #
# A System with a backend: its spans and counters.

H, W, FX = 192, 256, 300.0
VO = VOConfig(height=H, width=W, max_features=256, num_hypotheses=128, min_features_track=8,
              min_inlier_rate=0.3, persistent_tracks=True)
BCFG = BackendConfig(window=3, kf_every=1, max_landmarks=256, max_obs=2048, ba_iters=6)


@pytest.fixture(scope="module")
def runs():
    """The same 8 frames through a System with a backend, recorded and not."""
    seq = synthetic.render_sequence(n_frames=8, h=H, w=W, fx=FX, speed=1.0)
    rp = seq["rig"]
    cam = CameraConfig(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    frames = list(zip(seq["images_l"], seq["images_r"]))
    out = {}
    for recorded in (True, False):
        system = System(RunConfig(camera=cam, vo=VO), device="cpu", backend_cfg=BCFG)
        rec = profiling.record() if recorded else None
        try:
            traj = system.run(frames)
        finally:
            spans = rec.take() if rec else None
        out[recorded] = (system, traj, spans)
    return out


def test_backend_spans_and_counters(runs):
    system, _, spans = runs[True]
    by_id = {s["id"]: s for s in spans}
    parent = lambda s: by_id[s["parent"]]["name"] if s["parent"] else None
    solves = [s for s in spans if s["name"] == "backend.solve"]
    results = [m["ba"] for m in system.metrics if "ba" in m]
    # A window too small to solve (the first keyframe's) opens no backend.lm.
    assert len(solves) >= len(results) >= 4
    assert all(parent(s) == "system.step" for s in solves)
    for name, count in (("backend.problem", len(solves)), ("backend.lm", len(results)),
                        ("backend.fetch", len(results))):
        mine = [s for s in spans if s["name"] == name]
        assert len(mine) == count and {parent(s) for s in mine} == {"backend.solve"}
        for s in mine:
            up = by_id[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= up["end_ns"]
    marg = [s for s in spans if s["name"] == "backend.marginalize"]
    assert marg and {parent(s) for s in marg} == {"backend.keyframe"}
    assert all(s["device_ms"] is None for s in solves)           # no card: no event pair
    for r in results:
        assert r["lm_iters"] == 6 + 3 + 3 + 3 and 0 < r["lm_accepted"] <= r["lm_iters"]


def test_recorder_off_changes_nothing(runs):
    (sys_on, traj_on, _), (sys_off, traj_off, spans) = runs[True], runs[False]
    assert spans is None and np.array_equal(traj_on, traj_off)
    ba_on = [m["ba"] for m in sys_on.metrics if "ba" in m]
    ba_off = [m["ba"] for m in sys_off.metrics if "ba" in m]
    assert len(ba_on) == len(ba_off)
    for a, b in zip(ba_on, ba_off):
        assert a.keys() == b.keys()
        for k in a.keys() - {"wall_s"}:
            assert np.array_equal(a[k], b[k]), k
