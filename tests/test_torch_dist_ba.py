"""The port's distributed bundle adjustment (``parallel/dist_ba.py``,
``parallel/multihost.py``, ``models/ba.py``'s reduction hooks) on the CPU.

* ``partition_obs_by_landmark`` equals JAX's exactly (numpy both).
* The reduction hooks: with an all-reduce that sums one rank,
  ``schur_reduce`` routes the step through the reduced camera system and
  gives the single-device solve bit for bit (the same float ops in the
  same order), with and without a marginalization prior.
* The distributed solve on gloo at world size 2 (two worker processes
  joined through a ``FileStore``) against the single-device solve, mirroring
  JAX's ``tests/test_ba.py:160-211``: poses within 1e-3, costs within 1e-3
  relative, the same observations pruned, pose error < 0.02.
* The all-reduce payload per LM iteration at the production window
  (K = 16, L = 2048), counted from the tensors handed to ``all_reduce``:
  S_part 36,864 B + b_part 384 + Hpp 2,304 + bp 384 + the (L, 3) update
  24,576 + the cost 4 = 64,516 B, and no (K, L, 6, 3) coupling (2.36 MB)
  ever reduced.
* ``probes/multihost_demo.py`` with two processes, as JAX's
  ``tests/test_multihost.py``; ``multihost``'s helpers at world size 1.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stereo_visual_odometry_tpu.parallel import dist_ba as jdist_ba
from stereo_visual_odometry_tpu_torch.models import ba, marg
from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole
from stereo_visual_odometry_tpu_torch.parallel import dist_ba, mesh, multihost
from test_ba import make_ba_problem, pose_errors

REPO = Path(__file__).resolve().parent.parent
T_RL = np.eye(4, dtype=np.float32)
T_RL[0, 3] = -0.12


def _cam(jcam):
    return Pinhole.create(*(float(getattr(jcam, k)) for k in ("fx", "fy", "cx", "cy")))


def _stereo_problem():
    """``tests/test_ba.py``'s stereo + outliers problem (its
    ``test_distributed_ba_stereo_gnc_prune_matches_single_chip``), numpy."""
    jcam, poses_gt, pts_gt, p0, x0, obs = make_ba_problem(noise_px=0.2)
    obs_kf, obs_lm, obs_uv, obs_w = (np.array(o) for o in obs)
    sel = np.arange(0, obs_kf.shape[0], 2)
    pc = np.einsum("mij,mj->mi", poses_gt[obs_kf[sel], :3, :3],
                   pts_gt[obs_lm[sel]]) + poses_gt[obs_kf[sel], :3, 3]
    pr = pc + T_RL[:3, 3]
    uv_r = np.stack([500 * pr[:, 0] / pr[:, 2] + 320,
                     500 * pr[:, 1] / pr[:, 2] + 240], -1).astype(np.float32)
    n = len(obs_kf)
    obs_kf, obs_lm = np.r_[obs_kf, obs_kf[sel]], np.r_[obs_lm, obs_lm[sel]]
    obs_uv, obs_w = np.r_[obs_uv, uv_r], np.r_[obs_w, np.ones(len(sel), np.float32)]
    obs_right = np.r_[np.zeros(n, bool), np.ones(len(sel), bool)]
    rng = np.random.default_rng(5)
    idx = rng.choice(len(obs_uv), len(obs_uv) // 12, replace=False)
    obs_uv[idx] += rng.uniform(20, 60, size=(len(idx), 2)).astype(np.float32)
    return jcam, poses_gt, np.array(p0), np.array(x0), (obs_kf, obs_lm, obs_uv, obs_w), obs_right


@pytest.mark.parametrize("n_shards,stereo,cap,index", [
    (1, False, None, False), (2, False, None, True), (3, True, None, True),
    (8, True, None, False), (4, False, 40, True)])
def test_partition_obs_by_landmark_equals_jax(n_shards, stereo, cap, index):
    _, _, p0, x0, obs, obs_right = _stereo_problem()
    obs = list(obs)
    obs[3] = obs[3] * (np.arange(len(obs[3])) % 7 != 0)  # some dead rows
    kw = dict(obs_right=obs_right if stereo else None, cap=cap, return_index=index)
    got = dist_ba.partition_obs_by_landmark(*obs, n_shards, **kw)
    want = jdist_ba.partition_obs_by_landmark(*obs, n_shards, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("prior", [False, True], ids=["plain", "prior"])
def test_schur_reduce_identity_equals_single_device(prior):
    """One rank's all-reduce is the identity: the distributed routing
    (cost scalars reduced, the reduced camera system reduced, the prior's
    gradient and cross blocks after it, the landmark update reduced) then
    computes what ``bundle_adjust`` computes, bit for bit."""
    jcam, _, p0, x0, obs, obs_right = _stereo_problem()
    cam, kw = _cam(jcam), {}
    table = dict(zip(("obs_kf", "obs_lm", "obs_uv", "obs_w", "obs_right"), (*obs, obs_right)))
    if prior:  # as a window slide makes it (test_torch_cuda.py's recipe)
        dead = table["obs_lm"] < len(x0) // 2
        built = marg.build_prior(cam, _t(p0), _t(x0), huber_px=2.0, T_rl=_t(T_RL),
                                 **{k: _t(v[dead]) for k, v in table.items()})
        kw["prior"] = {k: v[:-1, :-1] if k == "H" else v[:-1] for k, v in built.items()}
        live = ~dead & (table["obs_kf"] >= 1)
        table = {k: v[live] for k, v in table.items()}
        table["obs_kf"] = table["obs_kf"] - 1
        p0 = p0[1:]
    args = [_t(a) for a in (p0, x0, *(table[k] for k in ("obs_kf", "obs_lm", "obs_uv",
                                                         "obs_w")))]
    obs_right = table["obs_right"]
    calls = []

    def identity(tree):
        calls.append(tree)
        return tree

    common = (cam, *args, 6, 1, 2.0, 1e-3, True, 10.0)
    want = ba._solve_phases(*common, obs_right=_t(obs_right), T_rl=_t(T_RL), **kw)
    got = ba._solve_phases(*common, obs_right=_t(obs_right), T_rl=_t(T_RL),
                           reduce_tree=identity, schur_reduce=True, **kw)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert calls and not any(isinstance(c, dict) and "Hpl" in c for c in calls)


def _run_world(tmp_path, world: int, problem: dict) -> dict:
    np.savez(tmp_path / "problem.npz", **problem)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_worker.py"),
                               str(tmp_path / "problem.npz"), str(tmp_path), str(r),
                               str(world)], cwd=REPO, env=env, stderr=subprocess.PIPE)
             for r in range(world)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), [e.decode()[-2000:] for e in errs]
    return dict(np.load(tmp_path / "out.npz"))


@pytest.mark.parametrize("case", ["plain", "stereo_gnc_prune"])
def test_distributed_solve_on_gloo_matches_single_device(case, tmp_path):
    world = 2
    if case == "plain":
        jcam, poses_gt, _, p0, x0, obs = make_ba_problem()
        obs, obs_right, opts = tuple(np.array(o) for o in obs), None, dict(n_iters=15)
    else:
        jcam, poses_gt, p0, x0, obs, obs_right = _stereo_problem()
        opts = dict(n_iters=10, prune_px=10.0)
    parts = dist_ba.partition_obs_by_landmark(*obs, world, obs_right=obs_right,
                                              return_index=True)
    problem = dict(cam=np.array([float(getattr(jcam, k)) for k in ("fx", "fy", "cx", "cy")]),
                   poses=np.array(p0), points=np.array(x0), obs_kf=parts[0], obs_lm=parts[1],
                   obs_uv=parts[2], obs_w=parts[3], n_iters=opts["n_iters"], gm_polish=True,
                   prune_px=opts.get("prune_px", -1.0))
    if obs_right is not None:
        problem.update(obs_right=parts[4], T_rl=T_RL)
    got = _run_world(tmp_path, world, problem)
    want = ba.bundle_adjust(_cam(jcam), _t(p0), _t(x0), *(_t(o) for o in obs), n_fixed=1,
                            obs_right=None if obs_right is None else _t(obs_right),
                            T_rl=None if obs_right is None else _t(T_RL), **opts)
    np.testing.assert_allclose(got["poses"], want["poses"].numpy(), atol=1e-3)
    np.testing.assert_allclose(float(got["cost_final"]), float(want["cost_final"]), rtol=1e-3)
    assert float(got["cost_final"]) < 0.2 * float(got["cost_initial"])
    src = parts[-1]
    keep = src >= 0
    w_orig = np.zeros(len(obs[0]), np.float32)
    w_orig[src[keep]] = got["obs_w"][keep]
    np.testing.assert_array_equal(w_orig > 0, want["obs_w"].numpy() > 0)
    assert pose_errors(got["poses"], poses_gt).mean() < 0.02


def _window_problem(K=16, L=2048, per_lm=3, seed=0):
    """A synthetic window at the production size: K keyframes along z, L
    landmarks each seen by ``per_lm`` consecutive keyframes."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 2, 3] = -0.5 * np.arange(K)
    pts = np.stack([rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
                    rng.uniform(10, 40, L)], -1).astype(np.float32)
    kf = (np.arange(L)[:, None] % (K - per_lm + 1) + np.arange(per_lm)).reshape(-1)
    lm = np.repeat(np.arange(L), per_lm)
    pc = pts[lm] + poses[kf, :3, 3]
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv = (uv + rng.normal(size=uv.shape) * 0.3).astype(np.float32)
    return poses, pts + 0.05, (kf.astype(np.int32), lm.astype(np.int32), uv,
                               np.ones(len(kf), np.float32))


def test_all_reduce_payload_per_iteration(monkeypatch):
    """Per LM iteration at K = 16, L = 2048 the all-reduces carry 64,516 B:
    the reduced camera system, the landmark update and the cost, counted
    from the tensors handed to ``all_reduce``; never the dense coupling."""
    K, L = 16, 2048
    poses, points, obs = _window_problem(K, L)
    sent = []
    real = dist.all_reduce

    def counting(tensor, *args, **kw):
        sent.append(tensor.numel() * tensor.element_size())
        return real(tensor, *args, **kw)

    multihost.initialize(world_size=1, rank=0, backend="gloo")
    try:
        monkeypatch.setattr(dist, "all_reduce", counting)
        solve = dist_ba.make_distributed_ba(Pinhole.create(500.0, 500.0, 320.0, 240.0),
                                            None, n_kf=K, n_lm=L, n_iters=2, gm_polish=False,
                                            device="cpu")
        out = solve(_t(poses), _t(points), *(_t(o) for o in obs))
    finally:
        dist.destroy_process_group()
    assert float(out["cost_final"]) < float(out["cost_initial"])
    per_iter = (K * K * 36 + K * 6 + K * 36 + K * 6 + L * 3 + 1) * 4
    assert per_iter == 64516
    assert sent[0] == 4  # the initial cost probe
    iters = sent[1:]
    assert len(iters) == 2 * 3 and sum(iters) == 2 * per_iter, sent
    assert max(sent) < K * L * 18 * 4 // 50  # no (K, L, 6, 3) coupling


def test_multihost_helpers_at_world_size_one():
    multihost.initialize(world_size=1, rank=0, backend="gloo")
    try:
        multihost.initialize(world_size=1, rank=0)  # idempotent
        with pytest.raises(RuntimeError, match="already in a group"):
            multihost.initialize(world_size=2, rank=1)
        m = multihost.global_mesh(axis="ba")
        assert m == mesh.Mesh((torch.device("cpu"),), "ba")
        local = np.arange(12, dtype=np.float32).reshape(4, 3)
        assert torch.equal(multihost.host_local_array(m, "ba", local), torch.from_numpy(local))
        assert torch.equal(multihost.replicated_array(m, local), torch.from_numpy(local))
        with pytest.raises(ValueError, match="axis"):
            multihost.host_local_array(m, "seq", local)
    finally:
        dist.destroy_process_group()


def test_distributed_ba_defaults_to_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist_ba.make_distributed_ba(Pinhole.create(500.0, 500.0, 320.0, 240.0), None,
                                        n_kf=2, n_lm=2)


def test_initialize_defaults_to_nccl():
    """No backend given: NCCL on the card, so without a GPU it raises and
    joins no group (gloo only when the caller asks for it)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            multihost.initialize(world_size=1, rank=0)
        assert not dist.is_initialized()


def test_two_process_distributed_ba():
    """``probes/multihost_demo.py``: two processes on gloo, the JAX demo's
    problem split by landmark, one solve across them."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m",
                          "stereo_visual_odometry_tpu_torch.probes.multihost_demo",
                          "--nprocs", "2", "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    res = json.loads(out.stdout.decode().strip().splitlines()[-1])
    assert res["processes"] == 2 and res["devices"] == 2 and res["device"] == "cpu"
    assert res["ok"], res
    assert res["cost_final"] < res["cost_initial"]
    assert res["max_pose_err"] < 0.02
