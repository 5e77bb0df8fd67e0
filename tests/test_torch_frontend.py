"""Port frontend: config and data parity, import hygiene, the unknown-mode
refusal, the device default, and one LK step and one ORB step from a JAX state
carried across by ``state_from_jax``.

The JAX LK frontend runs its dense LK path (``lk_backend='pallas'``) with
the window kernel patched to Pallas interpret mode; the JAX CPU default
would run another tracker. The JAX ORB frontend runs K1 and K2 in interpret
mode (``torch_jax_kernels.jax_pallas_kernels``) on the synthetic frames
plus seeded sensor noise (``torch_jax_kernels.with_sensor_noise``). Both
packages step from the same state with the same RANSAC draws. Tolerances:
``accept`` equal; T_21 translation within 1e-3 m and rotation within 1e-4;
LK n_tracked within 2% (float32 sums in another order can flip an LK gate
that sits on its threshold); ORB n_tracked and the next state's features
equal (integer matching on the same descriptors).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.models import frontend as jfront
from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.ops import patch_pallas
from stereo_visual_odometry_tpu.utils import synthetic as jsyn
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.utils import bridge
from stereo_visual_odometry_tpu_torch.utils import synthetic as tsyn
from stereo_visual_odometry_tpu_torch.utils.config import (CameraConfig, RunConfig,
                                                           rig_from_config)
from torch_jax_kernels import jax_pallas_kernels, with_sensor_noise

REPO = Path(__file__).resolve().parent.parent
H, W, FX = 192, 256, 300.0
SMALL = dict(height=H, width=W, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)


def test_voconfig_fields_and_defaults_match_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(tfront.VOConfig) == spec(jfront.VOConfig)
    for mode in ("lk", "orb"):
        assert (tfront.VOConfig(mode=mode).inlier_px_resolved
                == jfront.VOConfig(mode=mode).inlier_px_resolved)


@pytest.mark.parametrize("kw", [dict(n_frames=3, h=64, w=96, seed=4),
                                dict(n_frames=2, h=80, w=120, seed=1, flicker=0.25,
                                     dropout=0.3, yaw_rate=0.02)])
def test_render_sequence_equals_jax(kw):
    a, b = tsyn.render_sequence(**kw), jsyn.render_sequence(**kw)
    assert a.keys() == b.keys() and a["rig"] == b["rig"]
    for k in ("images_l", "images_r", "poses_gt"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import stereo_visual_odometry_tpu_torch\n"
        "import stereo_visual_odometry_tpu_torch.models.system\n"
        "import stereo_visual_odometry_tpu_torch.utils.bridge\n"
        "from stereo_visual_odometry_tpu_torch.models import backend, ba, marg\n"
        "from stereo_visual_odometry_tpu_torch.ops import (interp, match, orb,\n"
        "                                                 orb_pattern, patch)\n"
        "assert not any(m == 'stereo_visual_odometry_tpu' or\n"
        "               m.startswith('stereo_visual_odometry_tpu.') for m in sys.modules)\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


LK_BRANCHES = [dict(lk_kernel="cell"), dict(lk_kernel="v1"), dict(lk_backend="xla"),
               dict(lk_sweep=False), dict(lk_predictive=False)]


@pytest.mark.parametrize("kw", LK_BRANCHES, ids=lambda kw: "-".join(map(str, kw.items())))
def test_lk_branches_take_a_step(kw):
    """Every LK branch of the JAX VOConfig builds, carries its prior in the
    state, and tracks: the second step on the 192x256 scene is accepted.
    (With the dense kernel and no sweep, the JAX package too tracks few
    points on the first step: 0 with the 24 px default grid, 78 with no
    prior, against 132 with the sweep; its convergence gate fails the rest.)"""
    seq = tsyn.render_sequence(n_frames=3, h=H, w=W, fx=FX, speed=1.0)
    rp = seq["rig"]
    cam = CameraConfig(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    sys_ = System(RunConfig(camera=cam, vo=tfront.VOConfig(**SMALL, **kw)), device="cpu")
    sys_.step(seq["images_l"][0], seq["images_r"][0])
    prior = {k for k in ("dmap", "disp_grid") if k in sys_.state}
    want = ({"dmap"} if kw.get("lk_sweep", True) else {"disp_grid"}) \
        if kw.get("lk_predictive", True) else set()
    assert prior == want
    sys_.step(seq["images_l"][1], seq["images_r"][1])
    m = sys_.step(seq["images_l"][2], seq["images_r"][2])
    assert m["accept"] and m["n_tracked"] > 0.3 * m["n_detected"], m


def test_orb_mode_builds_and_ignores_lk_options():
    cfg = RunConfig(vo=tfront.VOConfig(mode="orb", lk_kernel="cell", lk_sweep=False))
    assert System(cfg, device="cpu").device.type == "cpu"


def test_system_defaults_to_cuda():
    """No device given: the card, or an error where there is none; never a
    silent run on the CPU."""
    if torch.cuda.is_available():
        assert System(RunConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            System(RunConfig())


@pytest.mark.parametrize("make", [tfront.make_lk_frontend, tfront.make_orb_frontend,
                                  tfront.make_frontend, tfront.make_chunked_frontend])
def test_frontend_factories_default_to_cuda(make):
    """The factories too: no device means the card, an error without one,
    and a rig on another device than the frontend's is refused."""
    cfg = tfront.VOConfig(**SMALL)
    if torch.cuda.is_available():
        make(cfg, rig_from_config(CameraConfig(), device="cuda"))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg, rig_from_config(CameraConfig(), device="cpu"))
    with pytest.raises(ValueError, match="rig"):
        make(cfg, rig_from_config(CameraConfig(), device="meta"), device="cpu")
    make(cfg, rig_from_config(CameraConfig(), device="cpu"), device="cpu")


def test_unknown_mode_rejected():
    with pytest.raises(ValueError):
        tfront.check_supported(tfront.VOConfig(mode="sift"))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = patch_pallas.extract_windows_int
    monkeypatch.setattr(
        patch_pallas, "extract_windows_int",
        lambda img, corners, S, interpret=False: orig(img, corners, S, interpret=True))


def test_one_step_from_jax_state(pallas_interpret):
    seq = tsyn.render_sequence(n_frames=3, h=H, w=W, fx=FX, speed=1.0)
    rp = seq["rig"]
    jrig = jcam.StereoRig.kitti(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"],
                                baseline=rp["baseline"])
    trig = bridge.rig_from_numpy(
        [float(v) for v in (jrig.left.fx, jrig.left.fy, jrig.left.cx, jrig.left.cy)],
        [float(v) for v in (jrig.right.fx, jrig.right.fy, jrig.right.cx, jrig.right.cy)],
        np.asarray(jrig.T_rl))
    jcfg = jfront.VOConfig(lk_backend="pallas", **SMALL)
    j_init, j_step = jfront.make_lk_frontend(jcfg, jrig)
    _, t_step = tfront.make_lk_frontend(tfront.VOConfig(**SMALL), trig, device="cpu")
    il, ir = seq["images_l"], seq["images_r"]
    state = j_init(jnp.asarray(il[0]), jnp.asarray(ir[0]), jax.random.PRNGKey(0))
    state, _ = j_step(state, jnp.asarray(il[1]), jnp.asarray(ir[1]))  # motion prior
    state_np = jax.tree_util.tree_map(np.asarray, state)
    _, sub = jax.random.split(state["key"])
    u = np.array(jax.random.uniform(sub, (jcfg.num_hypotheses, 6)))  # the step's draws

    s_j, m_j = j_step(state, jnp.asarray(il[2]), jnp.asarray(ir[2]))
    s_t, m_t = t_step(bridge.state_from_jax(state_np), il[2], ir[2],
                      u=torch.from_numpy(u))

    assert bool(m_j["accept"]) and bool(m_t["accept"])
    T_j, T_t = np.asarray(m_j["T_21"]), m_t["T_21"].numpy()
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=1e-4, rtol=0)
    n_j, n_t = int(m_j["n_tracked"]), int(m_t["n_tracked"])
    assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    # The next state: same detections (exact ops) and same pose chain.
    np.testing.assert_array_equal(s_t["kp_valid"].numpy(), np.asarray(s_j["kp_valid"]))
    np.testing.assert_allclose(s_t["kp"].numpy(), np.asarray(s_j["kp"]), atol=1e-6)
    np.testing.assert_allclose(s_t["T_wc"].numpy(), np.asarray(s_j["T_wc"]), atol=1e-3)
    assert int(s_t["status"]) == int(s_j["status"])


def test_orb_one_step_from_jax_state():
    h, w = 128, 320
    seq = tsyn.render_sequence(n_frames=3, h=h, w=w, fx=FX, speed=1.0)
    il, ir = (with_sensor_noise(seq[k], seed=s) for k, s in
              (("images_l", 1), ("images_r", 2)))
    rp = seq["rig"]
    jrig = jcam.StereoRig.kitti(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"],
                                baseline=rp["baseline"])
    trig = bridge.rig_from_numpy([FX, FX, rp["cx"], rp["cy"]], [FX, FX, rp["cx"], rp["cy"]],
                                 np.asarray(jrig.T_rl))
    small = dict(SMALL, mode="orb", height=h, width=w, orb_levels=4)
    jcfg = jfront.VOConfig(**small)
    _, t_step = tfront.make_frontend(tfront.VOConfig(**small), trig, device="cpu")
    with jax_pallas_kernels():
        j_init, j_step = jfront.make_frontend(jcfg, jrig)
        state = j_init(jnp.asarray(il[0]), jnp.asarray(ir[0]), jax.random.PRNGKey(0))
        state, _ = j_step(state, jnp.asarray(il[1]), jnp.asarray(ir[1]))  # motion prior
        state_np = jax.tree_util.tree_map(np.asarray, state)
        _, sub = jax.random.split(state["key"])
        u = np.array(jax.random.uniform(sub, (jcfg.num_hypotheses, 6)))
        s_j, m_j = j_step(state, jnp.asarray(il[2]), jnp.asarray(ir[2]))
    t_state = bridge.state_from_jax(state_np)
    assert t_state["feat_l"]["desc"].dtype == torch.int64
    s_t, m_t = t_step(t_state, il[2], ir[2], u=torch.from_numpy(u))

    assert bool(m_j["accept"]) and bool(m_t["accept"])
    assert int(m_t["n_tracked"]) == int(m_j["n_tracked"]) >= 20
    T_j, T_t = np.asarray(m_j["T_21"]), m_t["T_21"].numpy()
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(s_t["T_wc"].numpy(), np.asarray(s_j["T_wc"]), atol=1e-3)
    for side in ("feat_l", "feat_r"):
        want = bridge.feat_from_jax(jax.tree_util.tree_map(np.asarray, s_j[side]))
        np.testing.assert_array_equal(s_t[side]["valid"].numpy(), want["valid"].numpy())
        np.testing.assert_array_equal(s_t[side]["desc"].numpy(), want["desc"].numpy())
        np.testing.assert_allclose(s_t[side]["xy"].numpy(), want["xy"].numpy(), atol=1e-3)
    assert int(s_t["status"]) == int(s_j["status"])
