"""The slices as a whole: the port's ``System.run`` / ``run_chunked`` against
the JAX ``System`` over one synthetic sequence (8 frames), in LK mode
(192x256) and in ORB mode (128x320, 4 levels, 256 features).

ORB: the JAX ``System`` runs K1 and K2 in Pallas interpret mode
(``torch_jax_kernels.jax_pallas_kernels``) on the synthetic frames plus
seeded sensor noise (``torch_jax_kernels.with_sensor_noise``); with the JAX
RANSAC draws injected, accept flags are equal and poses within 1e-3 m and
1e-4 in rotation.

LK:
The JAX ``System`` runs its dense LK path (``lk_backend='pallas'``) with the
window kernel patched to Pallas interpret mode (its CPU default would run
another tracker). Tolerances:
  * with the JAX RANSAC draws injected into the port (the same uniforms the
    JAX key stream gives each step): accept flags equal, n_tracked within
    2%, poses within 1e-3 m and 1e-4 in rotation, ATEs within 1e-3 m —
    float32 sums in another order, nothing else;
  * with the port's own ``torch.Generator`` draws: accept flags equal, both
    ATEs under 0.3 m (the JAX package's own bound on this sequence) and
    within 0.05 m of each other. Different draws pick different minimal
    samples; over the 7 steps that moves the trajectory by a few cm.
"""
import os

import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models.frontend import VOConfig as JVOConfig
from stereo_visual_odometry_tpu.models.system import System as JSystem
from stereo_visual_odometry_tpu.ops import patch_pallas
from stereo_visual_odometry_tpu.utils.config import CameraConfig as JCamera
from stereo_visual_odometry_tpu.utils.config import RunConfig as JRunConfig
from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.utils import synthetic, trajectory
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig
from torch_jax_kernels import jax_draws, jax_pallas_kernels, with_sensor_noise

SMALL = dict(height=192, width=256, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return synthetic.render_sequence(n_frames=8, h=192, w=256, fx=300.0)


def _cam(seq):
    rp = seq["rig"]
    return dict(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"],
                baseline=rp["baseline"])


@pytest.fixture(scope="module")
def jax_run(seq):
    orig = patch_pallas.extract_windows_int
    patch_pallas.extract_windows_int = (
        lambda img, c, S, interpret=False: orig(img, c, S, interpret=True))
    try:
        sys_ = JSystem(JRunConfig(camera=JCamera(**_cam(seq)),
                                  vo=JVOConfig(lk_backend="pallas", **SMALL)))
        traj = sys_.run(list(zip(seq["images_l"], seq["images_r"])))
    finally:
        patch_pallas.extract_windows_int = orig
    return sys_, traj, _jax_draws(len(traj) - 1)


def _jax_draws(n_steps):
    return jax_draws(n_steps, SMALL["num_hypotheses"])


def _port(seq, method, vo=None, frames=None):
    sys_ = System(RunConfig(camera=CameraConfig(**_cam(seq)), vo=vo or VOConfig(**SMALL)),
                  device="cpu")
    frames = frames or list(zip(seq["images_l"], seq["images_r"]))
    traj = sys_.run(frames) if method == "run" else sys_.run_chunked(frames, chunk=3)
    return sys_, traj


def _tracked(sys_):
    return [int(m["n_tracked"]) for m in sys_.metrics if not m["init"]]


@pytest.mark.parametrize("method", ["run", "run_chunked"])
def test_system_matches_jax_with_same_draws(seq, jax_run, method, monkeypatch):
    j_sys, j_traj, draws = jax_run
    queue = [torch.from_numpy(u) for u in draws]
    orig = tpnp.ransac_pnp
    monkeypatch.setattr(tpnp, "ransac_pnp",
                        lambda *a, u=None, **kw: orig(*a, u=queue.pop(0), **kw))
    t_sys, t_traj = _port(seq, method)
    assert not queue
    assert t_traj.shape == j_traj.shape == (8, 4, 4)
    assert [m["accept"] for m in t_sys.metrics] == [m["accept"] for m in j_sys.metrics]
    for a, b in zip(_tracked(t_sys), _tracked(j_sys)):
        assert abs(a - b) <= 0.02 * b, (a, b)
    np.testing.assert_allclose(t_traj[:, :3, 3], j_traj[:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_traj[:, :3, :3], j_traj[:, :3, :3], atol=1e-4, rtol=0)
    gt = seq["poses_gt"]
    ate_t = trajectory.ate_rmse(t_traj, gt, align=False)
    ate_j = trajectory.ate_rmse(j_traj, gt, align=False)
    assert abs(ate_t - ate_j) < 1e-3, (ate_t, ate_j)


def test_system_own_draws_close_to_jax(seq, jax_run):
    j_sys, j_traj, _ = jax_run
    t_sys, t_traj = _port(seq, "run_chunked")
    assert [m["accept"] for m in t_sys.metrics] == [m["accept"] for m in j_sys.metrics]
    gt = seq["poses_gt"]
    ate_t = trajectory.ate_rmse(t_traj, gt, align=False)
    ate_j = trajectory.ate_rmse(j_traj, gt, align=False)
    assert ate_t < 0.3 and ate_j < 0.3, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < 0.05, (ate_t, ate_j)
    assert t_sys.summary()["accept_rate"] > 0.7 and t_sys.fps > 0


def test_system_reinit_after_lost(seq, tmp_path):
    cfg = RunConfig(camera=CameraConfig(**_cam(seq)), vo=VOConfig(**SMALL),
                    trajectory_out=str(tmp_path / "traj.txt"))
    sys_ = System(cfg, device="cpu")
    sys_.max_lost_before_reinit = 2
    blank = np.zeros_like(seq["images_l"][0])
    sys_.step(seq["images_l"][0], seq["images_r"][0])
    sys_.step(seq["images_l"][1], seq["images_r"][1])
    pose_before = sys_.poses[-1]
    for _ in range(3):
        sys_.step(blank, blank)
    np.testing.assert_allclose(sys_.poses[-1], pose_before, atol=1e-5)
    sys_.step(seq["images_l"][2], seq["images_r"][2])
    assert sys_.status == 1  # TRACKING_GOOD after the reinit
    traj = sys_.run([])  # writes the trajectory so far
    np.testing.assert_allclose(trajectory.load_kitti(cfg.trajectory_out), traj, atol=1e-6)
    ovl = tmp_path / "overlays"
    System(RunConfig(camera=CameraConfig(**_cam(seq)), vo=VOConfig(**SMALL), overlay_dir=str(ovl),
                     overlay_every=2), device="cpu").run(
        list(zip(seq["images_l"][:3], seq["images_r"][:3])))
    assert sorted(os.listdir(ovl)) == ["tracks_000002.png"]  # every 2nd frame, not the init


def test_run_chunked_reinit_after_lost(seq):
    sys_ = System(RunConfig(camera=CameraConfig(**_cam(seq)), vo=VOConfig(**SMALL)),
                  device="cpu")
    blank = np.zeros_like(seq["images_l"][0])
    il, ir = seq["images_l"], seq["images_r"]
    frames = [(il[0], ir[0]), (il[1], ir[1])] + [(blank, blank)] * 3 + \
        [(il[2], ir[2]), (il[3], ir[3])]
    traj = sys_.run_chunked(frames, chunk=2)
    assert traj.shape == (7, 4, 4)
    # Frames 2-4 are feature-starved: the pose holds, and the reinit after
    # the chunk that ends on the third of them brings tracking back.
    np.testing.assert_allclose(traj[2:5], np.broadcast_to(traj[1], (3, 4, 4)), atol=1e-5)
    assert [m["accept"] for m in sys_.metrics][-1]
    assert sys_.status == 1


ORB_SMALL = dict(SMALL, mode="orb", height=128, width=320, orb_levels=4)


@pytest.fixture(scope="module")
def orb_seq():
    seq = synthetic.render_sequence(n_frames=8, h=128, w=320, fx=300.0)
    seq["images_l"] = with_sensor_noise(seq["images_l"], seed=1)
    seq["images_r"] = with_sensor_noise(seq["images_r"], seed=2)
    return seq


@pytest.fixture(scope="module")
def jax_orb_run(orb_seq):
    with jax_pallas_kernels():
        sys_ = JSystem(JRunConfig(camera=JCamera(**_cam(orb_seq)),
                                  vo=JVOConfig(**ORB_SMALL)))
        traj = sys_.run(list(zip(orb_seq["images_l"], orb_seq["images_r"])))
    return sys_, traj, _jax_draws(len(traj) - 1)


@pytest.mark.parametrize("method", ["run", "run_chunked"])
def test_orb_system_matches_jax_with_same_draws(orb_seq, jax_orb_run, method,
                                                monkeypatch):
    j_sys, j_traj, draws = jax_orb_run
    queue = [torch.from_numpy(u) for u in draws]
    orig = tpnp.ransac_pnp
    monkeypatch.setattr(tpnp, "ransac_pnp",
                        lambda *a, u=None, **kw: orig(*a, u=queue.pop(0), **kw))
    t_sys, t_traj = _port(orb_seq, method, vo=VOConfig(**ORB_SMALL))
    assert not queue
    assert t_traj.shape == j_traj.shape == (8, 4, 4)
    acc = [m["accept"] for m in t_sys.metrics]
    assert acc == [m["accept"] for m in j_sys.metrics] and sum(acc) >= 5, acc
    assert _tracked(t_sys) == _tracked(j_sys)
    np.testing.assert_allclose(t_traj[:, :3, 3], j_traj[:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_traj[:, :3, :3], j_traj[:, :3, :3], atol=1e-4, rtol=0)
