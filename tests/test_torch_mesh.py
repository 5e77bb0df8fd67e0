"""The port's ``seq`` mesh over several devices (``parallel/mesh.py``,
``parallel/sequences.py``, ``parallel/evaluate.py``): an S-leading batch
split over n shards in one process, the counterpart of JAX's
``NamedSharding(mesh, P('seq'))``, against the unsplit port and against the
JAX package's 4-device run, on the CPU. A CPU mesh of n is n shards of the
CPU, as JAX's tests use virtual host devices.

Tolerances, per case:

* a shard against a single-device run of its own sequences at the shard's
  batch size, with the same draws: bit for bit (the same computation);
* the split run against the unsplit one: accept rates equal, poses within
  1e-5 m. The vmapped step at S/n sequences and at S rounds a few float32
  ops differently (~1e-6 after five frames), as ``test_torch_parallel.py``
  allows between the batched and unbatched steps;
* against JAX's ``evaluate_batch(mesh=make_mesh(4))`` with JAX's draws fed
  in: accept rates equal, positions within 1e-3 m (``test_torch_parallel.py``'s
  unsplit case);
* sequence 0 of the batched frontend against the unbatched one: 1e-3 (JAX's
  ``test_batched_vo_matches_single_sequence``).
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from stereo_visual_odometry_tpu.models import frontend as jfront
from stereo_visual_odometry_tpu.parallel import evaluate as jevaluate
from stereo_visual_odometry_tpu.parallel.mesh import make_mesh as jmake_mesh
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.parallel import evaluate, mesh, sequences
from stereo_visual_odometry_tpu_torch.utils import kitti, synthetic, trajectory
from test_torch_parallel import FX, H, SMALL, W, jax_rig, make_batch, port_rig
from torch_jax_kernels import jax_batch_draws

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


def feed_draws(monkeypatch, draws: np.ndarray):
    """Feed ``draws`` (S, T, num_hypotheses, 6) to the port's evaluator in
    place of its generator's, frame by frame."""
    frames = iter(torch.from_numpy(np.ascontiguousarray(d)) for d in draws.swapaxes(0, 1))
    monkeypatch.setattr(evaluate, "pnp", types.SimpleNamespace(
        draw_uniforms=lambda *a, **k: next(frames)))


def test_meshes_of_cpu_shards():
    """n CPU shards; a device named twice is two shards; a batch that does
    not split raises ``ValueError`` in the port, as in JAX's ``device_put``."""
    four = mesh.make_mesh(4, platform="cpu")
    assert four.devices == (torch.device("cpu"),) * 4 and four.size == 4
    assert mesh.shard_devices(four, "cuda") == four.devices
    assert mesh.shard_devices(None, "cpu") == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices on platform=cuda, have 0"):
            mesh.make_mesh(2, platform="cuda")
    x = np.arange(12.0).reshape(6, 2)
    parts = sequences.split(x, 3)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:4].tolist(), x[4:].tolist()]
    shards = sequences.Shards(parts)
    assert sequences.split(shards, 3) is shards  # already split: passed through
    with pytest.raises(ValueError, match="3 shards for a mesh of 2"):
        sequences.split(shards, 2)

    il, ir, _, rp = make_batch(3, 2)
    two = mesh.make_mesh(2, platform="cpu")
    cfg, rig = tfront.VOConfig(**SMALL), port_rig(rp)
    _, _, place = sequences.make_batched_frontend(cfg, rig, two)
    for call in (lambda: place(il[:, 0]),
                 lambda: sequences.batched_frontend(cfg, rig, 3, mesh=two),
                 lambda: evaluate.evaluate_batch(il, ir, np.array([2, 2, 2]), cfg, rig,
                                                 mesh=two)):
        with pytest.raises(ValueError, match="divisible by 2"):
            call()
    jmesh = jmake_mesh(2, axis="seq", platform="cpu")
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(il[:, 0], NamedSharding(jmesh, PartitionSpec("seq")))


def test_shards_equal_single_device_runs(monkeypatch):
    """S = 4 over a 2-shard mesh (two shards on the CPU, each with its own
    frontend): each shard's trajectories and accept rates are a
    single-device S = 2 run's on its sequences and draws, bit for bit."""
    n_seq, n_frames = 4, 5
    il, ir, _, rp = make_batch(n_seq, n_frames)
    lengths = np.array([5, 4, 5, 3])
    cfg, rig = tfront.VOConfig(**SMALL), port_rig(rp)
    draws = np.random.default_rng(11).random((n_seq, n_frames - 1, cfg.num_hypotheses, 6),
                                             dtype=np.float32)
    sequences.clear()
    two = mesh.make_mesh(2, platform="cpu")
    feed_draws(monkeypatch, draws)
    got = evaluate.evaluate_batch(il, ir, lengths, cfg, rig, mesh=two, chunk=2)
    _, step, _ = sequences.batched_frontend(cfg, rig, n_seq, mesh=two)
    assert isinstance(step, sequences.ShardedStep) and len(step.shards) == 2
    assert step.shards[0] is not step.shards[1]  # two shards on one device: two frontends
    for i, half in enumerate((slice(0, 2), slice(2, 4))):
        feed_draws(monkeypatch, draws[half])
        want = evaluate.evaluate_batch(il[half], ir[half], lengths[half], cfg, rig, chunk=2,
                                       device="cpu")
        for a, b in zip(got["trajectories"][half], want["trajectories"], strict=True):
            np.testing.assert_array_equal(a, b)
        assert got["accept_rate"][half] == want["accept_rate"]
    sequences.clear()


def test_evaluate_batch_mesh_matches_unsharded():
    """A 4-shard CPU mesh against the unsplit run, the same seed (so the same
    draws: one generator for all S, sliced per shard)."""
    n_seq = 4
    il, ir, gt, rp = make_batch(n_seq, n_frames=6)
    lengths = np.array([6, 6, 5, 4])
    cfg, rig = tfront.VOConfig(**SMALL), port_rig(rp)
    split = evaluate.evaluate_batch(il, ir, lengths, cfg, rig, chunk=3,
                                    mesh=mesh.make_mesh(4, platform="cpu"))
    whole = evaluate.evaluate_batch(il, ir, lengths, cfg, rig, chunk=3, device="cpu")
    assert split["accept_rate"] == whole["accept_rate"]
    for s, (a, b) in enumerate(zip(split["trajectories"], whole["trajectories"], strict=True)):
        assert a.shape == (lengths[s], 4, 4)
        np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=1e-5, rtol=0)
        assert np.linalg.norm(a[-1][:3, 3] - gt[s][lengths[s] - 1][:3, 3]) < 0.4
    assert split["frames_per_s"] > 0
    sequences.clear()


def test_evaluate_batch_mesh_matches_jax(monkeypatch):
    """JAX's ``evaluate_batch`` on its 4-device mesh against the port's on 4
    CPU shards, JAX's per-sequence draws fed in, ragged lengths; both run
    the XLA formulation of LK (JAX's CPU default)."""
    n_seq = 4
    il, ir, gt, rp = make_batch(n_seq, n_frames=6)
    lengths = np.array([6, 6, 5, 4])
    jout = jevaluate.evaluate_batch(il, ir, lengths, jfront.VOConfig(**SMALL), jax_rig(rp),
                                    mesh=jmake_mesh(4, axis="seq"), chunk=3)
    feed_draws(monkeypatch, jax_batch_draws(5, SMALL["num_hypotheses"], n_seq))
    cfg = tfront.VOConfig(lk_backend="xla", **SMALL)
    out = evaluate.evaluate_batch(il, ir, lengths, cfg, port_rig(rp), chunk=3,
                                  mesh=mesh.make_mesh(4, platform="cpu"))
    for s, traj in enumerate(out["trajectories"]):
        assert traj.shape == (lengths[s], 4, 4)
        np.testing.assert_allclose(traj[:, :3, 3], jout["trajectories"][s][:, :3, 3],
                                   atol=1e-3, rtol=0)
    assert out["accept_rate"] == jout["accept_rate"]
    sequences.clear()


def test_batched_frontend_on_mesh_matches_single_sequence():
    """JAX's ``test_batched_vo_matches_single_sequence`` on a 2-shard mesh,
    stepped frame by frame: every sequence near its ground truth (0.4 m),
    sequence 0 with the unbatched frontend's pose (1e-3) on the same draws;
    ``gather`` reads T_wc as (S, 4, 4)."""
    n_seq = 4
    il, ir, gt, rp = make_batch(n_seq, n_frames=5)
    cfg, rig = tfront.VOConfig(**SMALL), port_rig(rp)
    binit, bstep, place = sequences.make_batched_frontend(
        cfg, rig, mesh.make_mesh(2, platform="cpu"), generator=torch.Generator().manual_seed(0))
    state = binit(place(il[:, 0]), place(ir[:, 0]))
    assert isinstance(state, sequences.Shards) and len(state) == 2
    assert state[0]["T_wc"].shape == (2, 4, 4)
    for t in range(1, il.shape[1]):
        state, m = bstep(state, place(il[:, t]), place(ir[:, t]))  # draws (S, 128, 6)
    T_wc = sequences.gather(state, ("T_wc",))["T_wc"].astype(np.float64)
    assert T_wc.shape == (n_seq, 4, 4)
    for s in range(n_seq):
        err = np.linalg.norm(T_wc[s][:3, 3] - gt[s][-1][:3, 3])
        assert err < 0.4, (s, err)
    same = torch.Generator().manual_seed(0)
    u = [torch.rand(n_seq, cfg.num_hypotheses, 6, generator=same) for _ in il[0, 1:]]
    init1, step1 = tfront.make_frontend(cfg, rig, device="cpu")
    st = init1(il[0, 0], ir[0, 0])
    for t in range(1, il.shape[1]):
        st, _ = step1(st, il[0, t], ir[0, t], u=u[t - 1][0])
    np.testing.assert_allclose(st["T_wc"].numpy(), T_wc[0], atol=1e-3)


def test_evaluate_kitti_dirs_on_mesh(tmp_path):
    """Two KITTI directories streamed over a 2-shard mesh: bit for bit
    ``evaluate_batch`` on the same mesh and frames; against the unsplit
    streaming run, accept rates equal and poses within 1e-5 m."""
    from PIL import Image

    n_seq, n_frames = 2, 5
    dirs, frames_l, frames_r = [], [], []
    for s in range(n_seq):
        seq = synthetic.render_sequence(n_frames=n_frames - s, h=H, w=W, fx=FX, speed=1.0,
                                        seed=s)
        root = tmp_path / f"seq{s:02d}"
        for side, key in (("image_0", "images_l"), ("image_1", "images_r")):
            (root / side).mkdir(parents=True)
            for i, img in enumerate(seq[key]):
                Image.fromarray(img.astype(np.uint8)).save(root / side / f"{i:06d}.png")
        dirs.append(str(root))
        ds = kitti.KittiStereoDataset(str(root), static_hw=(H, W))
        pairs = [ds[min(i, len(ds) - 1)] for i in range(n_frames)]
        frames_l.append(np.stack([p[0] for p in pairs]).astype(np.float32))
        frames_r.append(np.stack([p[1] for p in pairs]).astype(np.float32))
        trajectory.save_kitti(str(tmp_path / f"gt{s:02d}.txt"), seq["poses_gt"])
    gt_files = [str(tmp_path / f"gt{s:02d}.txt") for s in range(n_seq)]
    cfg, rig = tfront.VOConfig(**SMALL), port_rig(seq["rig"])
    two = mesh.make_mesh(2, platform="cpu")
    out = evaluate.evaluate_kitti_dirs(dirs, cfg, rig, mesh=two, chunk=2, gt_files=gt_files)
    same = evaluate.evaluate_batch(np.stack(frames_l), np.stack(frames_r),
                                   np.array([n_frames, n_frames - 1]), cfg, rig, mesh=two,
                                   chunk=2)
    whole = evaluate.evaluate_kitti_dirs(dirs, cfg, rig, chunk=2, gt_files=gt_files,
                                         device="cpu")
    assert out["accept_rate"] == same["accept_rate"] == whole["accept_rate"]
    for s in range(n_seq):
        assert out["trajectories"][s].shape == (n_frames - s, 4, 4)
        np.testing.assert_array_equal(out["trajectories"][s], same["trajectories"][s])
        np.testing.assert_allclose(out["trajectories"][s][:, :3, 3],
                                   whole["trajectories"][s][:, :3, 3], atol=1e-5, rtol=0)
        assert out["ate"][s] < 0.5, (s, out["ate"][s])
    sequences.clear()


def test_mesh_modules_import_no_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from stereo_visual_odometry_tpu_torch.parallel import evaluate, mesh, sequences\n"
        "from stereo_visual_odometry_tpu_torch.models import step_graph\n"
        "from stereo_visual_odometry_tpu_torch.probes import scaling\n"
        "assert not any(m == 'stereo_visual_odometry_tpu' or\n"
        "               m.startswith('stereo_visual_odometry_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_scaling_probe_on_cpu():
    """``probes/scaling.py`` on CPU shards and gloo: one JSON line with
    SCALING.json's keys, top level and per row, a row per device count on
    each axis, the BA over gloo solving (cost down), and no file written."""
    before = (REPO / "SCALING.json").read_bytes()
    out = subprocess.run(
        [sys.executable, "-m", "stereo_visual_odometry_tpu_torch.probes.scaling", "--platform",
         "cpu", "--devices", "1", "2", "--frames", "3", "--reps", "1", "--obs-per-device",
         "256"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = json.loads(before)
    assert set(want) <= set(got) and got["platform"] == "cpu" and got["device"] == ["cpu"]
    for axis in ("seq_sharding", "dist_ba"):
        assert [r["devices"] for r in got[axis]] == [1, 2]
        for row in got[axis]:
            assert set(want[axis][0]) <= set(row) and row["wall_s"] > 0
    assert [r["mesh"] for r in got["seq_sharding"]] == [["cpu"], ["cpu", "cpu"]]
    assert all(r["accept_rate"] > 0.5 for r in got["seq_sharding"])
    for row in got["dist_ba"]:
        assert row["backend"] == "gloo" and row["cost_final"] < row["cost_initial"]
    assert (REPO / "SCALING.json").read_bytes() == before
