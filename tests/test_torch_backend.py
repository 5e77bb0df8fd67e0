"""Slice 3 as a whole: persistent tracks (LK and ORB), the sliding-window BA
backend (``models/backend.py``) and its wiring into ``System``, against the
JAX package.

* One persistent step of each frontend from a JAX state carried across by
  ``bridge.state_from_jax``, with the JAX step's RANSAC draws: the track
  slots' ``track_id``, ``track_age``, ``kp_valid`` / ``track_valid`` and
  ``next_id`` equal exactly (integer bookkeeping on the same detections and
  the same surviving tracks), positions within 1e-3 px, the current pair's
  depths within 1e-3 m where both are valid.
* ``SlidingWindowBA`` in both packages fed the same recorded frames (the
  JAX ``System``'s track arrays and poses), with marginalization on and off
  and both ``marg_policy`` branches: keyframes equal, poses within 1e-4 m
  and 1e-5 in rotation, landmarks within 1e-3 relative, costs within 1e-3
  relative, the prior within 1e-3 of its largest entry. Under
  ``marg_policy='underconstrained'`` a slide consumes only 19-33 landmarks
  seen 2-4 times; its float32 prior is rounding: both packages sit 1e2-1e3
  off a float64 rebuild of the same inputs, on entries up to ~440. There
  the prior's slots and linearization points are held equal, and its
  values through the solves it feeds (poses, costs).
* ``System`` with a backend (10 frames, 192x256, window 3, a keyframe
  every frame) against the JAX ``System`` with its draws injected: the same
  solves at the same frames, poses within 1e-3 m.

The JAX LK side runs ``lk_backend='pallas'`` with its kernels in Pallas
interpret mode (``torch_jax_kernels.jax_pallas_kernels``), the ORB side K1
and K2 in interpret mode on frames with seeded sensor noise.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import backend as jbackend
from stereo_visual_odometry_tpu.models import frontend as jfront
from stereo_visual_odometry_tpu.models.system import System as JSystem
from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.utils.config import CameraConfig as JCamera
from stereo_visual_odometry_tpu.utils.config import RunConfig as JRunConfig
from stereo_visual_odometry_tpu_torch.models import backend as tbackend
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.utils import bridge, synthetic, trajectory
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig
from torch_jax_kernels import jax_draws, jax_pallas_kernels, with_sensor_noise

H, W, FX = 192, 256, 300.0
SMALL = dict(height=H, width=W, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3, persistent_tracks=True)
ORB_SMALL = dict(SMALL, mode="orb", height=128, width=320, orb_levels=4)
BCFG = dict(window=3, kf_every=1, max_landmarks=256, max_obs=2048, ba_iters=6)
N_FRAMES = 10


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


def _cam(seq):
    rp = seq["rig"]
    return dict(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])


def _rigs(seq):
    rp = seq["rig"]
    jrig = jcam.StereoRig.kitti(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"],
                                baseline=rp["baseline"])
    intr = [FX, FX, rp["cx"], rp["cy"]]
    return jrig, bridge.rig_from_numpy(intr, intr, np.asarray(jrig.T_rl))


def test_backendconfig_fields_and_defaults_match_jax():
    spec = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(tbackend.BackendConfig) == spec(jbackend.BackendConfig)


# ---------------------------------------------------------------------- #
# One persistent step from a JAX state.

def _persistent_step(mode):
    """JAX init and two steps (ages up to 2), then one step in each package
    from the JAX state with the same draws -> (JAX state, metrics; port
    state, metrics)."""
    if mode == "lk":
        vo = SMALL
        seq = synthetic.render_sequence(n_frames=4, h=H, w=W, fx=FX, speed=1.0)
        il, ir = seq["images_l"], seq["images_r"]
    else:
        vo = ORB_SMALL
        seq = synthetic.render_sequence(n_frames=4, h=128, w=320, fx=FX, speed=1.0)
        il, ir = (with_sensor_noise(seq[k], seed=s) for k, s in
                  (("images_l", 1), ("images_r", 2)))
    jrig, trig = _rigs(seq)
    jcfg = jfront.VOConfig(**dict(vo, lk_backend="pallas"))
    _, t_step = tfront.make_frontend(tfront.VOConfig(**vo), trig, device="cpu")
    with jax_pallas_kernels():
        j_init, j_step = jfront.make_frontend(jcfg, jrig)
        state = j_init(jnp.asarray(il[0]), jnp.asarray(ir[0]), jax.random.PRNGKey(0))
        for f in (1, 2):
            state, _ = j_step(state, jnp.asarray(il[f]), jnp.asarray(ir[f]))
        state_np = jax.tree_util.tree_map(np.asarray, state)
        _, sub = jax.random.split(state["key"])
        u = np.array(jax.random.uniform(sub, (jcfg.num_hypotheses, 6)))
        s_j, m_j = j_step(state, jnp.asarray(il[3]), jnp.asarray(ir[3]))
    t_state = bridge.state_from_jax(state_np)
    for k in ("track_id", "track_age", "next_id"):
        assert t_state[k].dtype == torch.int32
        np.testing.assert_array_equal(t_state[k].numpy(), state_np[k])
    s_t, m_t = t_step(t_state, il[3], ir[3], u=torch.from_numpy(u))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return to_np(s_j), to_np(m_j), s_t, m_t


@pytest.mark.parametrize("mode", ["lk", "orb"])
def test_persistent_step_from_jax_state(mode):
    s_j, m_j, s_t, m_t = _persistent_step(mode)
    assert bool(m_t["accept"]) and bool(m_j["accept"])
    for k in ("track_id", "track_age", "next_id"):
        assert s_t[k].dtype == torch.int32, k
        np.testing.assert_array_equal(s_t[k].numpy(), s_j[k], err_msg=k)
    for k in ("track_id", "track_valid", "track_age", "track_id_prev_slots"):
        np.testing.assert_array_equal(m_t[k].numpy(), m_j[k], err_msg=k)
    valid = m_j["track_valid"]
    assert valid.sum() > 50 and (m_j["track_age"] >= 2).sum() > 20  # tracks live on
    np.testing.assert_allclose(m_t["track_xy"].numpy(), m_j["track_xy"], atol=1e-3)
    if mode == "lk":
        np.testing.assert_array_equal(s_t["kp_valid"].numpy(), s_j["kp_valid"])
        np.testing.assert_allclose(s_t["kp"].numpy(), s_j["kp"], atol=1e-3)
    stereo = m_j["track_stereo_valid"]
    assert (m_t["track_stereo_valid"].numpy() == stereo).mean() >= 0.99
    both = stereo & m_t["track_stereo_valid"].numpy()
    assert both.sum() > 20
    np.testing.assert_allclose(m_t["pts3d_cur"].numpy()[both], m_j["pts3d_cur"][both],
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(m_t["track_xy_r"].numpy()[both], m_j["track_xy_r"][both],
                               atol=1e-3)
    # The frame's outputs carry the track slots (what the backend reads).
    out = tfront.frame_outputs(s_t, m_t)
    assert set(tfront.TRACK_KEEP) <= out.keys()


# ---------------------------------------------------------------------- #
# The JAX System with a backend, recorded once.

@pytest.fixture(scope="module")
def seq():
    return synthetic.render_sequence(n_frames=N_FRAMES, h=H, w=W, fx=FX, speed=1.0)


@pytest.fixture(scope="module")
def jax_run(seq):
    with jax_pallas_kernels():
        sys_ = JSystem(JRunConfig(camera=JCamera(**_cam(seq)),
                                  vo=jfront.VOConfig(lk_backend="pallas", **SMALL)),
                       backend_cfg=jbackend.BackendConfig(**BCFG))
        traj = sys_.run(list(zip(seq["images_l"], seq["images_r"])))
    return sys_, traj, jax_draws(len(traj) - 1, SMALL["num_hypotheses"])


# ---------------------------------------------------------------------- #
# SlidingWindowBA fed the same recorded frames.

def _frames(j_sys):
    """Each tracked frame's (index, T_wc, track arrays) from the JAX run."""
    return [(i, j_sys.poses[i], m) for i, m in enumerate(j_sys.metrics) if not m["init"]]


def _feed(be, frames):
    """Drive a backend the way ``System.step`` does; returns each solve's
    (frame, cost_initial, cost_final)."""
    solves = []
    for i, T_wc, m in frames:
        be.tick()
        if be.should_add_keyframe(i, int(m["n_tracked"])):
            be.add_keyframe(i, T_wc, m["track_id"], m["track_xy"], m["track_valid"],
                            m["pts3d_cur"], m["pts3d_cur_valid"], track_xy_r=m["track_xy_r"],
                            track_stereo_valid=m["track_stereo_valid"],
                            n_tracked=int(m["n_tracked"]))
            res = be.optimize()
            if res is not None:
                solves.append((i, res["cost_initial"], res["cost_final"], res["n_landmarks"]))
    return solves


def _assert_backends_close(tb, jb, prior_values=True):
    assert tb.frame_of_kf == jb.frame_of_kf
    assert tb._frames_since_kf == jb._frames_since_kf
    assert tb._last_kf_n_tracked == jb._last_kf_n_tracked
    for a, b in zip(tb.kf_poses, jb.kf_poses, strict=True):
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=1e-4, rtol=0)
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=1e-5, rtol=0)
    assert tb.landmarks.keys() == jb.landmarks.keys()
    for t in jb.landmarks:
        np.testing.assert_allclose(tb.landmarks[t], jb.landmarks[t], atol=1e-3, rtol=1e-3)
    assert [o.keys() for o in tb.kf_obs] == [o.keys() for o in jb.kf_obs]
    assert (tb.prior is None) == (jb.prior is None)
    if jb.prior is not None and prior_values:
        for k in ("H", "b"):
            want = np.asarray(jb.prior[k])
            np.testing.assert_allclose(tb.prior[k], want, rtol=0,
                                       atol=1e-3 * max(np.abs(want).max(), 1.0))
    if jb.prior is not None:
        for k in ("T_lin", "mask"):
            np.testing.assert_allclose(tb.prior[k], np.asarray(jb.prior[k]), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(marginalize=False),
                                dict(marg_policy="underconstrained")],
                         ids=["marg_dying", "drop_oldest", "marg_underconstrained"])
def test_sliding_window_matches_jax(jax_run, seq, kw):
    j_sys, _, _ = jax_run
    jrig, trig = _rigs(seq)
    cfg = dict(BCFG, **kw)
    jb = jbackend.SlidingWindowBA(jrig.left, jbackend.BackendConfig(**cfg),
                                  T_rl=np.asarray(jrig.T_rl))
    tb = tbackend.SlidingWindowBA(trig.left, tbackend.BackendConfig(**cfg),
                                  T_rl=np.asarray(jrig.T_rl), device="cpu")
    frames = _frames(j_sys)
    got, want = _feed(tb, frames), _feed(jb, frames)
    assert [s[0] for s in got] == [s[0] for s in want] and len(got) >= 5
    assert [s[3] for s in got] == [s[3] for s in want]
    np.testing.assert_allclose([s[1:3] for s in got], [s[1:3] for s in want], rtol=1e-3)
    assert all(s[2] <= s[1] * 1.001 for s in got)
    _assert_backends_close(tb, jb, prior_values=cfg.get("marg_policy") != "underconstrained")
    if cfg.get("marginalize", True):
        assert jb.prior is not None and np.abs(tb.prior["H"]).max() > 0


def test_backend_from_jax_continues_like_jax(jax_run, seq):
    """A JAX backend's host state carried across by ``bridge.backend_from_jax``
    halfway through the recorded frames: the rest fed to both, the port ends
    where JAX does."""
    j_sys, _, _ = jax_run
    jrig, trig = _rigs(seq)
    frames = _frames(j_sys)
    jb = jbackend.SlidingWindowBA(jrig.left, jbackend.BackendConfig(**BCFG),
                                  T_rl=np.asarray(jrig.T_rl))
    _feed(jb, frames[:5])
    assert jb.prior is not None
    state = {k: copy.deepcopy(getattr(jb, k)) for k in bridge.BACKEND_STATE}
    tb = bridge.backend_from_jax(state, trig.left, tbackend.BackendConfig(**BCFG),
                                 np.asarray(jrig.T_rl))
    _assert_backends_close(tb, jb)
    got, want = _feed(tb, frames[5:]), _feed(jb, frames[5:])
    assert [s[0] for s in got] == [s[0] for s in want] and got
    _assert_backends_close(tb, jb)


# ---------------------------------------------------------------------- #
# System with a backend.

def _port_run(seq, draws, monkeypatch, backend=True):
    queue = [torch.from_numpy(u) for u in draws]
    orig = tpnp.ransac_pnp
    monkeypatch.setattr(tpnp, "ransac_pnp",
                        lambda *a, u=None, **kw: orig(*a, u=queue.pop(0), **kw))
    sys_ = System(RunConfig(camera=CameraConfig(**_cam(seq)), vo=tfront.VOConfig(**SMALL)),
                  device="cpu",
                  backend_cfg=tbackend.BackendConfig(**BCFG) if backend else None)
    traj = sys_.run(list(zip(seq["images_l"], seq["images_r"])))
    assert not queue
    return sys_, traj


def test_system_with_backend_matches_jax(jax_run, seq, monkeypatch):
    j_sys, j_traj, draws = jax_run
    t_sys, t_traj = _port_run(seq, draws, monkeypatch)
    solves = lambda s: [i for i, m in enumerate(s.metrics) if "ba" in m]
    assert solves(t_sys) == solves(j_sys) and len(solves(t_sys)) >= 5
    assert t_sys.backend.frame_of_kf == j_sys.backend.frame_of_kf
    assert [m["accept"] for m in t_sys.metrics] == [m["accept"] for m in j_sys.metrics]
    np.testing.assert_allclose(t_traj[:, :3, 3], j_traj[:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_traj[:, :3, :3], j_traj[:, :3, :3], atol=1e-4, rtol=0)
    for mt, mj in zip(t_sys.metrics, j_sys.metrics):
        if "ba" in mj:
            assert mt["ba"]["n_landmarks"] == mj["ba"]["n_landmarks"]
            assert mt["ba"]["cost_final"] <= mt["ba"]["cost_initial"] * 1.001
    ate = trajectory.ate_rmse(t_traj, seq["poses_gt"], align=False)
    assert ate < 0.45, ate  # the JAX package's own bound on this sequence


def test_system_records_the_corrected_pose(jax_run, seq, monkeypatch):
    """After a solve the recorded pose is the corrected one, the live state
    holds it, and the next frame composes onto it."""
    _, _, draws = jax_run
    sys_, traj = _port_run(seq, draws, monkeypatch)
    checked = 0
    for i, m in enumerate(sys_.metrics[:-1]):
        nxt = sys_.metrics[i + 1]
        if "ba" not in m or not nxt["accept"]:
            continue
        # The frontend's pose of frame i + 1, before that frame's own solve.
        fresh = traj[i + 1] if "ba" not in nxt else \
            np.linalg.inv(nxt["ba"]["correction"]) @ traj[i + 1]
        np.testing.assert_allclose(fresh, traj[i] @ np.linalg.inv(nxt["T_21"]), atol=1e-4)
        assert np.abs(m["ba"]["correction"] - np.eye(4)).max() > 1e-6  # a real correction
        checked += 1
    assert checked >= 5
    last = sys_.metrics[-1]
    assert "ba" in last
    np.testing.assert_allclose(sys_.state["T_wc"].numpy(), traj[-1].astype(np.float32))


def test_backend_refusals(seq):
    cam = CameraConfig(**_cam(seq))
    bcfg = tbackend.BackendConfig(**BCFG)
    with pytest.raises(ValueError, match="persistent_tracks"):
        System(RunConfig(camera=cam, vo=tfront.VOConfig(**dict(SMALL, persistent_tracks=False))),
               device="cpu", backend_cfg=bcfg)
    sys_ = System(RunConfig(camera=cam, vo=tfront.VOConfig(**SMALL)), device="cpu",
                  backend_cfg=bcfg)
    with pytest.raises(ValueError, match="frontend-only"):
        sys_.run_chunked(list(zip(seq["images_l"], seq["images_r"]))[:2])


def test_backend_defaults_to_cuda(seq):
    """The backend's solve runs on the card unless the caller asks for
    another device; a camera elsewhere is refused."""
    _, trig = _rigs(seq)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="camera"):
            tbackend.SlidingWindowBA(trig.left)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbackend.SlidingWindowBA(trig.left)
    assert tbackend.SlidingWindowBA(trig.left, device="cpu").device.type == "cpu"


def test_orb_system_with_backend():
    """The backend composes with the ORB frontend (JAX
    ``tests/test_backend.py:120``, on the port alone)."""
    seq = synthetic.render_sequence(n_frames=12, h=H, w=W, fx=FX, speed=1.0, n_points=4000)
    vo = tfront.VOConfig(mode="orb", height=H, width=W, max_features=512, orb_levels=4,
                         num_hypotheses=128, min_features_track=8, min_inlier_rate=0.05,
                         persistent_tracks=True)
    sys_ = System(RunConfig(camera=CameraConfig(**_cam(seq)), vo=vo), device="cpu",
                  backend_cfg=tbackend.BackendConfig(window=4, kf_every=2, max_landmarks=256,
                                                     max_obs=2048, ba_iters=6))
    traj = sys_.run(list(zip(seq["images_l"], seq["images_r"])))
    runs = [m["ba"] for m in sys_.metrics if "ba" in m]
    assert len(runs) >= 2
    for r in runs:
        assert r["cost_final"] <= r["cost_initial"] * 1.001 and r["n_landmarks"] >= 8
    assert trajectory.ate_rmse(traj, seq["poses_gt"], align=False) < 1.0
