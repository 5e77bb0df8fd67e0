"""The port's bench (``stereo_visual_odometry_tpu_torch.probes.bench``)
against the JAX package's ``bench.py``, on the CPU at a small size.

``bench.py`` is imported as it is; its module constants (and the port's,
and the BA leg's in ``probes/ba_leg.py``) are set by monkeypatch to the
small size: 376x1241 -> 120x300 edge-padded to 128x320, 256 features.

Tolerances:
  * frames: equal bit for bit (the port's ``utils/synthetic.py`` is a numpy
    copy of the JAX package's);
  * the LK slice as a whole, ``run_gpu`` against ``run_tpu`` on 33 frames
    (chunks of 16: chunk 0 absorbs the warm-up, chunks 1.. are timed), with
    the JAX RANSAC draws injected into the port. ``run_tpu`` on the CPU
    takes JAX's ``lk_backend='auto'`` -> ``lk._level_track``, so the port's
    leg is pinned to ``lk_backend='xla'``, the same tracker. Accept flags
    equal on every frame. Until the two chains first part, poses within
    1e-3 m and 1e-4 in rotation and n_tracked equal: float32 sums in
    another order. The carried state (the motion prior, the sweep's map)
    holds those ~1e-6 differences and feeds them into the next frame's LK
    guesses, so a point can cross a gate one frame in one package and not
    in the other, and RANSAC then picks another consensus (cm at this
    size). Fed the same state, every step agrees. So the chains may part,
    but not within the first 8 frames (``tests/test_torch_system.py``'s
    depth), and after it the two ATEs stay within 0.01 m and the mean
    n_tracked within 0.5%;
  * the rows' numbers: equal to ``bench.main``'s own ``metrics`` (its
    nested function, taken from ``bench.py``'s source) on the same poses;
  * the BA block: equal to ``run_tpu_ba``'s on the same passes (both
    ``System`` classes replaced by one stand-in that returns the same
    trajectories and solve walls);
  * ``main``: one JSON line with ``bench.py``'s keys (``tpu_*`` named
    ``gpu_*``), run in a subprocess that never imports JAX.
"""
import ast
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import system as jsystem
from stereo_visual_odometry_tpu.models.frontend import VOConfig as JVOConfig
from stereo_visual_odometry_tpu.utils import synthetic as jsynthetic
from stereo_visual_odometry_tpu.utils import trajectory as jtrajectory
from stereo_visual_odometry_tpu_torch.models import system as tsystem
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.probes import bench as pbench
from stereo_visual_odometry_tpu_torch.utils import synthetic as tsynthetic
from torch_jax_kernels import jax_key_draws

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(H_RAW=120, W_RAW=300, H=128, W=320, FEATURES=256)
N_FRAMES = 33  # 2 chunks of 16 after the init frame: chunk 1 is timed


def load_bench():
    """``bench.py`` as a module, with the environment as it was (its import
    sets JAX cache variables)."""
    import importlib.util

    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    return load_bench()


@pytest.fixture
def small(bench, monkeypatch):
    for mod in (bench, pbench):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(pbench, "ORB_FEATURES", SMALL["FEATURES"])
    return bench


@pytest.mark.parametrize("variant", [None, "flicker", "yaw"])
def test_make_frames_equal_bench(small, monkeypatch, variant):
    bench = small
    kw = bench.STRESS_VARIANTS[variant] if variant else {}
    assert pbench.STRESS_VARIANTS == bench.STRESS_VARIANTS
    for mod in (bench, pbench):
        monkeypatch.setattr(mod, "N_FRAMES", 3)
    lj, rj, gj = bench.make_frames(**kw)
    lt, rt, gt = pbench.make_frames(**kw)
    assert lt.shape == (3, SMALL["H"], SMALL["W"])
    for a, b in ((lt, lj), (rt, rj), (gt, gj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def lk_runs(bench):
    """``run_tpu`` and ``run_gpu`` (pinned to JAX's CPU tracker, JAX's draws
    injected) on the same 33 frames, each with its per-frame accept flags
    and n_tracked."""
    from stereo_visual_odometry_tpu.utils import hostcopy

    with pytest.MonkeyPatch.context() as mp:
        for mod in (bench, pbench):
            for k, v in SMALL.items():
                mp.setattr(mod, k, v)
            mp.setattr(mod, "N_FRAMES", N_FRAMES)
        il, ir, gt = bench.make_frames()
        chunks = []
        get = hostcopy.device_get_tree
        mp.setattr(hostcopy, "device_get_tree", lambda tree: chunks.append(get(tree)) or
                   chunks[-1])
        j = bench.run_tpu(il, ir, "lk")
        j_frames = {k: np.concatenate([m[k] for c in chunks for m in c]).tolist()
                    for k in ("accept", "n_tracked")}
        draws = jax_key_draws(jax.random.PRNGKey(0), N_FRAMES - 1, JVOConfig().num_hypotheses)
        queue = [torch.from_numpy(u) for u in draws]
        orig = tpnp.ransac_pnp
        mp.setattr(tpnp, "ransac_pnp", lambda *a, u=None, **kw: orig(*a, u=queue.pop(0), **kw))
        # JAX's 'auto' on the CPU runs lk._level_track: the port's 'xla'.
        mp.setattr(pbench, "VOConfig", functools.partial(pbench.VOConfig, lk_backend="xla"))
        systems = []
        mp.setattr(pbench, "System", lambda *a, **kw: systems.append(
            tsystem.System(*a, **kw)) or systems[-1])
        t = pbench.run_gpu(il, ir, "lk", device="cpu")
        assert not queue
    tracked = [m for m in systems[0].metrics if not m["init"]]
    t_frames = {k: [cast(m[k]) for m in tracked]
                for k, cast in (("accept", bool), ("n_tracked", int))}
    return j, j_frames, t, t_frames, gt


def test_run_gpu_matches_run_tpu(lk_runs):
    j, j_frames, t, t_frames, gt = lk_runs
    assert set(t) == set(j) == {"fps", "poses", "accept", "n_tracked"}
    assert t["poses"].shape == j["poses"].shape == (N_FRAMES, 4, 4)
    assert t["fps"] > 0 and j["fps"] > 0
    assert t_frames["accept"] == j_frames["accept"] and t["accept"] == j["accept"]
    assert len(t_frames["n_tracked"]) == N_FRAMES - 1
    assert t["n_tracked"] == pytest.approx(np.mean(t_frames["n_tracked"]))
    assert abs(t["n_tracked"] - j["n_tracked"]) <= 0.005 * j["n_tracked"]
    ate_t, ate_j = (jtrajectory.ate_rmse(r["poses"], gt) for r in (t, j))
    assert abs(ate_t - ate_j) < 0.01, (ate_t, ate_j)


def test_run_gpu_matches_run_tpu_until_the_chains_part(lk_runs):
    j, j_frames, t, t_frames, _ = lk_runs
    dt = np.abs(t["poses"][:, :3, 3] - j["poses"][:, :3, 3]).max(-1)
    dr = np.abs(t["poses"][:, :3, :3] - j["poses"][:, :3, :3]).max((-1, -2))
    # Frame i (1..) is tracked frame i - 1 in the per-frame lists.
    same = [True] + [a == b for a, b in zip(t_frames["n_tracked"], j_frames["n_tracked"])]
    part = next((i for i, ok in enumerate(same) if not ok), len(same))
    assert part >= 8, (part, t_frames["n_tracked"], j_frames["n_tracked"])
    assert (dt[:part] <= 1e-3).all() and (dr[:part] <= 1e-4).all(), (part, dt, dr)


def bench_metrics(bench, poses_gt):
    """``bench.main``'s nested ``metrics`` (bench.py:482-488), compiled from
    its source with the JAX package's ``trajectory`` and ``poses_gt``."""
    tree = ast.parse(Path(bench.__file__).read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in main.body if isinstance(n, ast.FunctionDef) and n.name == "metrics")
    ns = {"trajectory": jtrajectory, "poses_gt": poses_gt}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), bench.__file__, "exec"), ns)
    return ns["metrics"]


def chain(n, rng=None):
    """(n, 4, 4) poses 1.1 m apart along z, with a random walk if ``rng``."""
    traj = np.tile(np.eye(4), (n, 1, 1))
    traj[:, 2, 3] = 1.1 * np.arange(n)
    if rng is not None:
        traj[:, :3, 3] += np.cumsum(rng.normal(size=(n, 3)), axis=0) * 0.05
    return traj


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_metrics_equal_bench_main(bench, seed):
    rng = np.random.default_rng(seed)
    gt = chain(12)
    poses = gt.copy()
    poses[:, :3, 3] += np.cumsum(rng.normal(size=(12, 3)) * 0.01 * (seed + 1), axis=0)
    res = {"fps": float(rng.uniform(1, 300)), "poses": poses,
           "accept": float(rng.uniform(0.5, 1)), "n_tracked": float(rng.uniform(10, 1000))}
    assert pbench.row_metrics(res, gt) == bench_metrics(bench, gt)(res)


class StandInSystem:
    """One ``System`` for both packages' BA legs: a trajectory and solve
    walls that depend only on the frame count and the backend config."""

    def __init__(self, cfg, device=None, backend_cfg=None):
        self.kind = 0 if backend_cfg is None else (1 if backend_cfg.marginalize else 2)

    def run(self, frames):
        n = len(frames)
        rng = np.random.default_rng(self.kind)
        traj = chain(n, rng)
        self.metrics = [{"init": True, "accept": False, "time_s": 0.0}]
        for i in range(1, n):
            m = {"init": False, "accept": True, "time_s": 0.02, "n_tracked": 100}
            if self.kind and i % 4 == 3:
                m["ba"] = {"wall_s": float(rng.uniform(0.05, 0.4))}
            self.metrics.append(m)
        return traj


def test_run_gpu_ba_equals_run_tpu_ba(small, monkeypatch):
    bench = small
    n = 9
    # The leg's frames (held equal by test_make_frames_equal_bench's
    # generator) stand in as blank images: the stand-in System ignores them.
    blank = lambda **kw: {"images_l": np.zeros((n, kw["h"], kw["w"]), np.float32),
                          "images_r": np.zeros((n, kw["h"], kw["w"]), np.float32),
                          "poses_gt": chain(n)}
    monkeypatch.setattr(jsynthetic, "render_sequence", blank)
    monkeypatch.setattr(tsynthetic, "render_sequence", blank)
    monkeypatch.setattr(jsystem, "System", StandInSystem)
    monkeypatch.setattr(tsystem, "System", StandInSystem)
    want = bench.run_tpu_ba()
    got = pbench.run_gpu_ba(device="cpu", n_frames=n)
    assert list(got) == list(want) == ["ate_frontend_only_m", "ate_ba_marg_m",
                                       "ate_ba_drop_oldest_m", "n_frames", "n_solves",
                                       "ms_per_solve", "improved"]
    assert got == want and got["n_frames"] == n and got["n_solves"] == 2


def test_bench_imports_no_jax():
    """The module, as written: no import of ``jax`` or of the JAX package,
    at its top or inside a function."""
    tree = ast.parse(Path(pbench.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert names and not [m for m in names if m.split(".")[0] in
                          ("jax", "jaxlib", "stereo_visual_odometry_tpu", "bench")]


MAIN_SMALL = """
import json, sys, torch
torch.set_num_threads(2)
from stereo_visual_odometry_tpu_torch.probes import ba_leg, bench
for mod in (bench, ba_leg):
    for k, v in {small}.items():
        setattr(mod, k, v)
bench.ORB_FEATURES, bench.N_FRAMES, bench.CHUNK, ba_leg.N_FRAMES = 256, 5, 2, 5
bench.main(["--device", "cpu"])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "stereo_visual_odometry_tpu"))))
"""


def test_main_prints_bench_line_without_jax(bench):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", MAIN_SMALL.format(small=SMALL)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[1]) == [], lines
    line = json.loads(lines[0])
    # bench.py's keys (:562-570), its tpu_* rows named gpu_*, with the card.
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "parity", "gpu_parity",
                          "ba", "device", "opencv_source"]
    rows = [f"{s}_{m}" for s in ("opencv", "gpu") for m in ("lk", "orb")]
    rows += [f"{s}_{m}_{v}" for v in ("flicker", "yaw") for m in ("lk", "orb")
             for s in ("opencv", "gpu")]
    assert list(line["parity"]) == rows
    cached = json.loads((ROOT / "BASELINE_MEASURED.json").read_text())
    for name, row in line["parity"].items():
        assert list(row) == ["fps", "ate_m", "rpe_t_m", "rpe_r_rad", "accept_rate",
                             "n_tracked"]
        if name.startswith("opencv_"):
            assert row == cached[name.replace("opencv_", "reference_")]
    gpu = line["parity"]
    best = max(("lk", "orb"), key=lambda m: (gpu[f"gpu_{m}"]["fps"] / gpu[f"opencv_{m}"]["fps"],
                                             m == "orb"))
    assert line["value"] == pytest.approx(gpu[f"gpu_{best}"]["fps"], abs=0.01)
    assert line["metric"] == "vo_frames_per_s" and line["unit"] == "frames/s"
    assert line["gpu_parity"]["ok"] is False and "skipped" in line["gpu_parity"]
    assert line["ba"]["n_frames"] == 5 and set(line["ba"]) == {
        "ate_frontend_only_m", "ate_ba_marg_m", "ate_ba_drop_oldest_m", "n_frames",
        "n_solves", "ms_per_solve", "improved"}
    assert line["device"] == "cpu" and "BASELINE_MEASURED.json" in line["opencv_source"]


def test_main_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.main([])


def test_opencv_rows_name_a_missing_key(tmp_path, monkeypatch):
    cached = json.loads((ROOT / "BASELINE_MEASURED.json").read_text())
    del cached["reference_orb_yaw"]
    path = tmp_path / "BASELINE_MEASURED.json"
    path.write_text(json.dumps(cached))
    monkeypatch.setattr(pbench, "OPENCV_CACHE", path)
    with pytest.raises(KeyError, match="reference_orb_yaw"):
        pbench.opencv_rows()
