"""The port's slice 4 (``stereo_visual_odometry_tpu_torch/parallel``, the
kernels' custom ops) against the JAX package on the CPU (the batched frontend against JAX's
is ``test_torch_batched_frontend.py``).

* K1-K4's custom ops (``ops/library.py``): under ``torch.func.vmap`` each
  batch rule equals the per-sequence calls bit for bit (the plain versions
  once per sequence), whatever axis vmap batches (RANSAC-PnP's op:
  ``test_torch_pnp.py``); the ops' schemas and fake implementations, PnP's
  too, pass ``torch.library.opcheck``.
* The batched port against the unbatched port, sequence by sequence, with
  the same draws: accept and n_tracked equal, poses within 1e-5 m (batched
  reductions sum in another order), and no op of the step falls back to
  vmap's per-sequence loop.
* ``run_chunk_scan``, ``evaluate_batch`` (ragged lengths) and
  ``evaluate_kitti_dirs`` as JAX's ``tests/test_parallel.py`` tests them;
  ``evaluate_batch`` also against JAX's with JAX's draws injected: accept
  rates equal, each pose within 1e-3 m. Both run the XLA formulation of
  LK here (JAX's CPU default), the port's through K1.
* ``utils/kitti.py`` against JAX's; the meshes; no JAX in the new modules;
  a batched step's graph holding not its owner (no reference cycle).
"""
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import frontend as jfront
from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.parallel import evaluate as jevaluate
from stereo_visual_odometry_tpu.parallel.mesh import make_mesh as jmake_mesh
from stereo_visual_odometry_tpu.utils import kitti as jkitti
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.ops import lk_cell, lk_v1, patch
from stereo_visual_odometry_tpu_torch.parallel import evaluate, mesh, sequences
from stereo_visual_odometry_tpu_torch.probes import pnp_timing
from stereo_visual_odometry_tpu_torch.utils import kitti, synthetic, trajectory
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, rig_from_config
from torch_jax_kernels import jax_batch_draws

REPO = Path(__file__).resolve().parent.parent
H, W, FX = 192, 256, 300.0
SMALL = dict(height=H, width=W, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


def make_batch(n_seq, n_frames, h=H, w=W):
    seqs = [synthetic.render_sequence(n_frames=n_frames, h=h, w=w, fx=FX, speed=1.0, seed=s)
            for s in range(n_seq)]
    il = np.stack([s["images_l"] for s in seqs])  # (S, T, H, W)
    ir = np.stack([s["images_r"] for s in seqs])
    gt = np.stack([s["poses_gt"] for s in seqs])
    return il, ir, gt, seqs[0]["rig"]


def port_rig(rp):
    return rig_from_config(CameraConfig(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"],
                                        baseline=rp["baseline"]), device="cpu")


def jax_rig(rp):
    return jcam.StereoRig.kitti(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])


# ---- the custom ops ------------------------------------------------------- #

def _k_inputs(S=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    imgs = torch.rand(S, 50, 60, generator=g) * 255
    nxt = torch.roll(imgs, (1, 2), (1, 2))
    corners = torch.randint(-2, 40, (S, 9, 2), generator=g).to(torch.int32)
    centers = torch.rand(S, 9, 2, generator=g) * 64 - 3
    pts = torch.rand(S, 9, 2, generator=g) * 30 + 10
    guess = (torch.rand(S, 9, 2, generator=g) - 0.5) * 2
    active = torch.rand(S, 9, generator=g) > 0.3
    return imgs, nxt, corners, centers, pts, guess, active


OPS = {
    "K1": lambda i, n, c, x, p, q, a: patch.extract_windows_int(i, c, (5, 7)),
    "K2": lambda i, n, c, x, p, q, a: patch.extract_patches(i, x, 9),
    "K3": lambda i, n, c, x, p, q, a: lk_cell.level_track_cell(i, n, p, q, win=7, pad=2,
                                                               active=a),
    "K4": lambda i, n, c, x, p, q, a: lk_v1.level_track_v1(i, n, p, q, win=7, pad=2, active=a),
}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(OPS))
def test_custom_op_vmap_rule_equals_per_sequence_calls(name):
    """The batch rule (the plain version once per sequence on the CPU) gives
    the per-sequence calls' outputs bit for bit: with every input batched on
    axis 0, with the sequence axis at axis 1, and with an image vmap did not
    batch (the rule broadcasts it)."""
    fn, args = OPS[name], _k_inputs()
    shared = args[0][0]  # one image for every sequence, unbatched

    def per_sequence(first):
        outs = [_as_tuple(fn(first(s), *(a[s] for a in args[1:]))) for s in range(3)]
        return tuple(torch.stack(o) for o in zip(*outs))

    want = per_sequence(lambda s: args[0][s])
    runs = [(torch.func.vmap(fn)(*args), want),
            (torch.func.vmap(fn, in_dims=1)(*(a.movedim(0, 1) for a in args)), want),
            (torch.func.vmap(fn, in_dims=(None,) + (0,) * 6)(shared, *args[1:]),
             per_sequence(lambda s: shared))]
    for got, ref in runs:
        for a, b in zip(_as_tuple(got), ref, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("op", ["extract_windows_int", "extract_patches", "lk_level_cell",
                                "lk_level_v1", "ransac_pnp"])
def test_custom_op_schema_and_fake(op):
    imgs, nxt, corners, centers, pts, guess, active = _k_inputs()
    x = {k: v[0] for k, v in pnp_timing.problem(1, 40, 16, device="cpu").items()}
    cam = pnp_timing.camera("cpu")
    args = {"ransac_pnp": (x["pts"], x["px"], x["valid"], x["u"], x["T_init"], x["weights"],
                           cam.fx, cam.fy, cam.cx, cam.cy, 2.0, 3),
            "extract_windows_int": (imgs[0], corners[0].clamp(0, 40), 5, 7),
            "extract_patches": (imgs[0], centers[0], 9),
            "lk_level_cell": (imgs[0], nxt[0], pts[0], guess[0], 7, 30, 0.01, 1e-4, 6.0, 2,
                              active[0]),
            "lk_level_v1": (imgs[0], nxt[0], pts[0], guess[0], 7, 30, 0.01, 1e-4, 6.0, 2,
                            None)}[op]
    torch.library.opcheck(getattr(torch.ops.svo, op).default, args,
                          test_utils=("test_schema", "test_faketensor"))


# ---- the batched port against the unbatched port ------------------------- #

PATHS = {"dense": dict(), "cell": dict(lk_kernel="cell"), "v1": dict(lk_kernel="v1"),
         "orb": dict(mode="orb", height=128, width=320, orb_levels=4)}
BATCHED = dict(PATHS, persistent=dict(persistent_tracks=True),
               orb_persistent=dict(PATHS["orb"], persistent_tracks=True),
               no_sweep=dict(lk_sweep=False))


@pytest.mark.parametrize("path", list(BATCHED))
def test_batched_port_matches_unbatched_port(path):
    """S = 3 sequences through the vmapped step against each sequence through
    the step alone, three frames, the same draws; no vmap fallback (a
    per-sequence loop would multiply the step's ops by S)."""
    S, kw = 3, dict(SMALL, **BATCHED[path])
    il, ir, _, rp = make_batch(S, 3, kw["height"], kw["width"])
    cfg, rig = tfront.VOConfig(**kw), port_rig(rp)
    u = torch.rand(S, 2, cfg.num_hypotheses, 6, generator=torch.Generator().manual_seed(3))
    init, step, _ = sequences.make_batched_frontend(cfg, rig, device="cpu")
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state = init(il[:, 0], ir[:, 0])
            outs = []
            for t in (1, 2):
                state, m = step(state, il[:, t], ir[:, t], u=u[:, t - 1])
                outs.append(m)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallback = [str(w.message) for w in caught if "batching rule" in str(w.message)]
    assert not fallback, fallback
    init1, step1 = tfront.make_frontend(cfg, rig, device="cpu")
    for s in range(S):
        st = init1(il[s, 0], ir[s, 0])
        for t in (1, 2):
            st, m1 = step1(st, il[s, t], ir[s, t], u=u[s, t - 1])
            assert bool(m1["accept"]) == bool(outs[t - 1]["accept"][s])
            assert int(m1["n_tracked"]) == int(outs[t - 1]["n_tracked"][s])
        np.testing.assert_allclose(state["T_wc"][s].numpy(), st["T_wc"].numpy(), atol=1e-5,
                                   rtol=0)
        if "track_id" in st:
            assert torch.equal(state["track_id"][s], st["track_id"])


# ---- the four tests of tests/test_parallel.py ----------------------------- #

def test_batched_vo_matches_single_sequence():
    n_seq = 4
    il, ir, gt, rp = make_batch(n_seq, n_frames=6)
    cfg, rig = tfront.VOConfig(**SMALL), port_rig(rp)
    binit, bstep, place = sequences.make_batched_frontend(cfg, rig, mesh.make_mesh(
        platform="cpu"), generator=torch.Generator().manual_seed(0))
    state = binit(place(il[:, 0]), place(ir[:, 0]))
    for t in range(1, il.shape[1]):
        state, m = bstep(state, place(il[:, t]), place(ir[:, t]))  # draws (S, 128, 6)
    same = torch.Generator().manual_seed(0)
    u = [torch.rand(n_seq, cfg.num_hypotheses, 6, generator=same) for _ in il[0, 1:]]
    T_wc = state["T_wc"].double().numpy()
    for s in range(n_seq):
        err = np.linalg.norm(T_wc[s][:3, 3] - gt[s][-1][:3, 3])
        assert err < 0.4, (s, err, T_wc[s][:3, 3], gt[s][-1][:3, 3])
    init1, step1 = tfront.make_frontend(cfg, rig, device="cpu")
    st = init1(il[0, 0], ir[0, 0])
    for t in range(1, il.shape[1]):
        st, _ = step1(st, il[0, t], ir[0, t], u=u[t - 1][0])
    np.testing.assert_allclose(st["T_wc"].numpy(), T_wc[0], atol=1e-3)


def test_chunk_scan_on_device():
    n_seq = 4
    il, ir, gt, rp = make_batch(n_seq, n_frames=5)
    cfg = tfront.VOConfig(**SMALL)
    binit, bstep, place = sequences.make_batched_frontend(cfg, port_rig(rp), device="cpu")
    state = binit(il[:, 0], ir[:, 0])
    u = torch.rand(n_seq, 4, cfg.num_hypotheses, 6, generator=torch.Generator().manual_seed(1))
    state, metrics = sequences.run_chunk_scan(bstep, state, place(il[:, 1:]), place(ir[:, 1:]),
                                              u)
    assert metrics["accept"].shape == (4, n_seq)  # (T, S)
    assert float(metrics["accept"].float().mean()) > 0.7
    T_wc = state["T_wc"].double().numpy()
    np.testing.assert_array_equal(metrics["T_wc"][-1].numpy(), state["T_wc"].numpy())
    for s in range(n_seq):
        err = np.linalg.norm(T_wc[s][:3, 3] - gt[s][-1][:3, 3])
        assert err < 0.4, (s, err)


def _jax_draws_fed(monkeypatch, n_steps, H_, S):
    """Feed JAX's per-sequence draws (``split(PRNGKey(0), S)``) to the port's
    evaluator in place of its generator's, frame by frame."""
    draws = iter(torch.from_numpy(d) for d in jax_batch_draws(n_steps, H_, S).swapaxes(0, 1))
    monkeypatch.setattr(evaluate, "pnp", types.SimpleNamespace(
        draw_uniforms=lambda *a, **k: next(draws)))


def test_evaluate_batch_ragged_lengths(monkeypatch):
    n_seq = 4
    il, ir, gt, rp = make_batch(n_seq, n_frames=6)
    lengths = np.array([6, 6, 5, 4])  # ragged lengths exercise masking
    jout = jevaluate.evaluate_batch(il, ir, lengths, jfront.VOConfig(**SMALL), jax_rig(rp),
                                    mesh=jmake_mesh(4, axis="seq"), chunk=3)
    _jax_draws_fed(monkeypatch, 5, SMALL["num_hypotheses"], n_seq)
    cfg = tfront.VOConfig(lk_backend="xla", **SMALL)
    out = evaluate.evaluate_batch(il, ir, lengths, cfg, port_rig(rp), chunk=3, device="cpu")
    assert len(out["trajectories"]) == n_seq
    for s, traj in enumerate(out["trajectories"]):
        assert traj.shape == (lengths[s], 4, 4)
        err = np.linalg.norm(traj[-1][:3, 3] - gt[s][lengths[s] - 1][:3, 3])
        assert err < 0.4, (s, err)
        np.testing.assert_allclose(traj[:, :3, 3], jout["trajectories"][s][:, :3, 3],
                                   atol=1e-3, rtol=0)
    assert out["accept_rate"] == jout["accept_rate"]
    assert out["frames_per_s"] > 0


def test_evaluate_kitti_dirs_streaming(tmp_path):
    """Disk-backed streaming: chunk-at-a-time loads from PNGs this test
    writes, the same trajectories as ``evaluate_batch`` on the same frames
    (bit for bit: the same computation and draws), ATE from the --gt files."""
    from PIL import Image

    n_seq, n_frames = 2, 6
    dirs, gt_files = [], []
    frames_l, frames_r = [], []
    for s in range(n_seq):
        seq = synthetic.render_sequence(n_frames=n_frames - s, h=H, w=W, fx=FX, speed=1.0,
                                        seed=s)
        root = tmp_path / f"seq{s:02d}"
        (root / "image_0").mkdir(parents=True)
        (root / "image_1").mkdir()
        for i in range(n_frames - s):
            for side, key in (("image_0", "images_l"), ("image_1", "images_r")):
                Image.fromarray(seq[key][i].astype(np.uint8)).save(root / side / f"{i:06d}.png")
        gt_file = tmp_path / f"gt{s:02d}.txt"
        trajectory.save_kitti(str(gt_file), seq["poses_gt"])
        dirs.append(str(root))
        gt_files.append(str(gt_file))
        ds = kitti.KittiStereoDataset(str(root), static_hw=(H, W))
        pairs = [ds[min(i, len(ds) - 1)] for i in range(n_frames)]
        frames_l.append(np.stack([p[0] for p in pairs]).astype(np.float32))
        frames_r.append(np.stack([p[1] for p in pairs]).astype(np.float32))
        rp = seq["rig"]
    cfg, rig = tfront.VOConfig(**SMALL), port_rig(rp)
    out = evaluate.evaluate_kitti_dirs(dirs, cfg, rig, mesh=mesh.make_mesh(1, platform="cpu"),
                                       chunk=2, gt_files=gt_files)
    want = evaluate.evaluate_batch(np.stack(frames_l), np.stack(frames_r),
                                   np.array([n_frames, n_frames - 1]), cfg, rig, chunk=2,
                                   device="cpu")
    assert len(out["trajectories"]) == len(out["accept_rate"]) == n_seq
    for s in range(n_seq):
        assert out["trajectories"][s].shape == (n_frames - s, 4, 4)
        np.testing.assert_array_equal(out["trajectories"][s], want["trajectories"][s])
        assert out["ate"][s] < 0.5, (s, out["ate"][s])
    assert out["accept_rate"] == want["accept_rate"]
    assert out["frames_per_s"] > 0


# ---- kitti, meshes, imports ------------------------------------------------ #

def test_kitti_module_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for side in ("image_0", "image_1"):
        (tmp_path / side).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (37, 61), dtype=np.uint8)).save(
                tmp_path / side / f"{i:06d}.png")
    calib = tmp_path / "calib.txt"
    calib.write_text("P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
                     "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
    assert kitti.load_calib(str(calib)) == jkitti.load_calib(str(calib))
    assert kitti.static_shape_for(37, 61) == jkitti.static_shape_for(37, 61)
    ours = kitti.KittiStereoDataset(str(tmp_path))
    theirs = jkitti.KittiStereoDataset(str(tmp_path), use_native=False)
    assert len(ours) == len(theirs) == 3 and ours.static_hw == theirs.static_hw
    for i in range(3):
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)
    for (a, b), (c, d) in zip(ours.iter_prefetch(2), theirs.iter_prefetch(2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_meshes():
    m = mesh.make_mesh(platform="cpu", axis="ba")
    assert m.devices == (torch.device("cpu"),) and m.axis == "ba" and m.size == 1
    two = mesh.make_mesh(2, platform="cpu")  # n CPU shards, as JAX's virtual host devices
    assert two.devices == (torch.device("cpu"),) * 2 and two.axis == "seq" and two.size == 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="platform=default, have 0"):
            mesh.make_mesh()
    assert mesh.shard_leading(m, "seq") == mesh.Sharding(m, "seq")
    assert mesh.replicated(m).axis is None
    assert mesh.single_device(m, "cuda") == torch.device("cpu")
    with pytest.raises(ValueError, match="takes one device"):
        mesh.single_device(two, "cuda")
    # A 2-device mesh splits the batch: one frontend per shard, S/2 sequences each.
    il, ir, _, rp = make_batch(2, 1)
    init, step, place = sequences.make_batched_frontend(tfront.VOConfig(**SMALL), port_rig(rp),
                                                        two)
    parts = place(il[:, 0])
    assert isinstance(parts, sequences.Shards) and [p.shape[0] for p in parts] == [1, 1]
    torch.testing.assert_close(parts[1], torch.from_numpy(il[1:, 0]), rtol=0, atol=0)
    state = init(parts, place(ir[:, 0]))
    assert isinstance(step, sequences.ShardedStep) and len(state) == len(step.shards) == 2


def test_batched_frontend_cache():
    """One batched frontend per (config, rig bytes, device, S), the one that
    ``evaluate_batch`` runs, until ``sequences.clear()``."""
    sequences.clear()
    cfg, rp = tfront.VOConfig(**SMALL), make_batch(1, 1)[3]
    first = sequences.batched_frontend(cfg, port_rig(rp), 2, device="cpu")
    assert sequences.batched_frontend(cfg, port_rig(rp), 2, device="cpu") is first
    assert sequences.batched_frontend(cfg, port_rig(rp), 3, device="cpu") is not first
    other = dict(rp, baseline=rp["baseline"] * 2)
    assert sequences.batched_frontend(cfg, port_rig(other), 2, device="cpu") is not first
    assert isinstance(first[1], sequences.BatchedStep)
    sequences.clear()
    assert sequences.batched_frontend(cfg, port_rig(rp), 2, device="cpu") is not first
    sequences.clear()



def test_batched_step_graph_holds_not_its_owner(monkeypatch):
    """A ``BatchedStep``'s graph runs the vmapped step, not the step object:
    dropped (``sequences.clear()``), the step and its graph go at once, with
    no reference cycle left for the collector to free later, perhaps while
    another graph captures (a graph stands in here: a real one needs a card)."""
    import gc
    import weakref

    made = []

    class Graph:
        def __init__(self, step_fn, cfg, device, batch=None):
            self.step_fn = step_fn
            made.append(self)

    monkeypatch.setattr(sequences, "StepGraph", Graph)
    sequences.clear()
    cfg, rp = tfront.VOConfig(**SMALL), dict(cx=W / 2, cy=H / 2, baseline=0.5)
    step = sequences.batched_frontend(cfg, port_rig(rp), 2, device="cpu")[1]
    assert step.graph(2) is step.graph(2) is made[0] and made[0].step_fn is not step
    refs = [weakref.ref(step), weakref.ref(made.pop())]
    del step
    gc.disable()
    try:
        sequences.clear()
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()

def test_evaluate_defaults_to_cuda():
    il = np.zeros((1, 2, H, W), np.float32)
    rig = rig_from_config(CameraConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate.evaluate_batch(il, il, np.array([2]), tfront.VOConfig(**SMALL), rig)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from stereo_visual_odometry_tpu_torch.parallel import (dist_ba, evaluate, mesh,\n"
        "                                                       multihost, sequences)\n"
        "from stereo_visual_odometry_tpu_torch.ops import library\n"
        "from stereo_visual_odometry_tpu_torch.utils import kitti\n"
        "from stereo_visual_odometry_tpu_torch.probes import batched, multihost_demo\n"
        "from stereo_visual_odometry_tpu_torch import cli\n"
        "from stereo_visual_odometry_tpu_torch.models import online\n"
        "from stereo_visual_odometry_tpu_torch.native import loader\n"
        "from stereo_visual_odometry_tpu_torch.utils import checkpoint, logging, viz\n"
        "assert not any(m == 'stereo_visual_odometry_tpu' or\n"
        "               m.startswith('stereo_visual_odometry_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
