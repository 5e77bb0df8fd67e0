"""Port parity for the LK branches beside the main path: ``circular_track``
without the sweep, one frontend step from a JAX state for
``lk_sweep=False`` and ``lk_predictive=False`` (the dense kernel). The
``System`` with ``lk_kernel='cell'`` and ``'v1'`` is in
``test_torch_lk_system.py``.

The JAX side runs its Pallas kernels in interpret mode
(``torch_jax_kernels.jax_pallas_kernels``; its CPU ``'auto'`` would take the
XLA tracker) and the XLA tracker as itself; the port runs the plain
versions (CPU tensors). Inputs: the port's synthetic frames (192x256),
pyramids built by the JAX package, FAST/top-K keypoints; both sides get the
same arrays, and the port steps with the JAX RANSAC draws injected.

Tolerances: flows within 1e-3 px where both sides keep a point and ok
masks agreeing on >= 99% of points (float32 sums in another order);
one step: accept equal, T_21 within 1e-3 m / 1e-4, n_tracked within 2%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import frontend as jfront
from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.ops import fast as jfast
from stereo_visual_odometry_tpu.ops import lk as jlk
from stereo_visual_odometry_tpu.ops import pyramid as jpyr
from stereo_visual_odometry_tpu.ops import se3 as jse3
from stereo_visual_odometry_tpu.ops import select as jsel
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.ops import camera as tcam
from stereo_visual_odometry_tpu_torch.ops import lk as tlk
from stereo_visual_odometry_tpu_torch.utils import bridge, synthetic
from torch_jax_kernels import jax_pallas_kernels

H, W, FX = 192, 256, 300.0
FLOW_ATOL = 1e-3
OK_AGREE = 0.99
SMALL = dict(height=H, width=W, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    seq = synthetic.render_sequence(n_frames=2, h=H, w=W, fx=FX, speed=1.0, seed=2)
    pyr = {name: [np.array(p) for p in jpyr.build_pyramid(jnp.asarray(img), 4)]
           for name, img in (("t1l", seq["images_l"][0]), ("t1r", seq["images_r"][0]),
                             ("t2l", seq["images_l"][1]), ("t2r", seq["images_r"][1]))}
    score = jfast.detect(jnp.asarray(seq["images_l"][0]), 20.0)
    xy, _, valid = jsel.grid_top_k(score, 256, cell=32, k_per_cell=8)
    xy = jsel.subpixel_refine(score, xy, valid, use_pallas=False)
    return seq, pyr, np.array(xy), np.array(valid)


def to_t(levels):
    return tuple(torch.from_numpy(a) for a in levels)


def to_j(levels):
    return tuple(jnp.asarray(a) for a in levels)


def rigs(seq):
    rp = seq["rig"]
    kw = dict(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    return jcam.StereoRig.kitti(**kw), tcam.StereoRig.kitti(**kw)


@pytest.mark.parametrize("prior,kernel", [("disp_prior", "cell"), ("none", "v1")])
def test_circular_track_without_sweep_matches_jax(scene, prior, kernel):
    """The ``lk_sweep=False`` branch (a per-point disparity prior and the
    motion model, 3 levels per leg, ``rounds_prior`` on the coarsest) and the
    ``lk_predictive=False`` branch (no guess at all, ``rounds_coarse``)."""
    seq, pyr, xy, valid = scene
    jrig, trig = rigs(seq)
    kw = dict(use_pallas=True, pallas_kernel=kernel, rounds_prior=4, rounds_coarse=8,
              rounds_refine=2)
    jkw, tkw = dict(kw), dict(kw)
    if prior == "disp_prior":
        T_gt = np.linalg.inv(seq["poses_gt"][1]) @ seq["poses_gt"][0]
        T_pred = (np.array(jse3.se3_exp(jnp.asarray([0.01, 0.0, -0.02, 0.0, 0.001, 0.0])))
                  @ T_gt).astype(np.float32)
        disp = np.random.default_rng(4).uniform(10.0, 30.0, len(xy)).astype(np.float32)
        jkw.update(rig=jrig, T_pred=jnp.asarray(T_pred), disp_prior=jnp.asarray(disp))
        tkw.update(rig=trig, T_pred=torch.from_numpy(T_pred),
                   disp_prior=torch.from_numpy(disp))
    pyrs = ("t1l", "t1r", "t2r", "t2l")
    with jax_pallas_kernels():
        qj = jlk.circular_track(tuple(to_j(pyr[k]) for k in pyrs), jnp.asarray(xy),
                                jnp.asarray(valid), **jkw)
    qt = tlk.circular_track(tuple(to_t(pyr[k]) for k in pyrs), torch.from_numpy(xy),
                            torch.from_numpy(valid), **tkw)
    assert set(qt) == set(qj) == {"t1l", "t1r", "t2r", "t2l", "valid"}
    okt, okj = qt["valid"].numpy(), np.asarray(qj["valid"])
    assert (okt == okj).mean() >= OK_AGREE
    both = okt & okj
    assert both.sum() > 0.2 * valid.sum(), both.sum()
    for k in ("t1r", "t2r", "t2l"):
        np.testing.assert_allclose(qt[k].numpy()[both], np.asarray(qj[k])[both],
                                   atol=FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(lk_sweep=False), dict(lk_predictive=False)],
                         ids=["no_sweep", "not_predictive"])
def test_one_step_from_jax_state(kw):
    """One LK step of each prior branch from a JAX state carried across by
    ``bridge.state_from_jax`` (which needs no ``dmap``), the dense kernel
    on both sides."""
    seq = synthetic.render_sequence(n_frames=4, h=H, w=W, fx=FX, speed=1.0)
    jrig, _ = rigs(seq)
    trig = bridge.rig_from_numpy(
        [float(v) for v in (jrig.left.fx, jrig.left.fy, jrig.left.cx, jrig.left.cy)],
        [float(v) for v in (jrig.right.fx, jrig.right.fy, jrig.right.cx, jrig.right.cy)],
        np.asarray(jrig.T_rl), device="cpu")
    jcfg = jfront.VOConfig(lk_backend="pallas", **SMALL, **kw)
    _, t_step = tfront.make_lk_frontend(tfront.VOConfig(**SMALL, **kw), trig,
                                        device="cpu")
    il, ir = seq["images_l"], seq["images_r"]
    with jax_pallas_kernels():
        j_init, j_step = jfront.make_lk_frontend(jcfg, jrig)
        state = j_init(jnp.asarray(il[0]), jnp.asarray(ir[0]), jax.random.PRNGKey(0))
        for i in (1, 2):  # the first step has no prior to speak of
            state, _ = j_step(state, jnp.asarray(il[i]), jnp.asarray(ir[i]))
        state_np = jax.tree_util.tree_map(np.asarray, state)
        _, sub = jax.random.split(state["key"])
        u = np.array(jax.random.uniform(sub, (jcfg.num_hypotheses, 6)))
        s_j, m_j = j_step(state, jnp.asarray(il[3]), jnp.asarray(ir[3]))
    t_state = bridge.state_from_jax(state_np)
    prior = {k for k in ("dmap", "disp_grid") if k in t_state}
    assert prior == ({"disp_grid"} if kw.get("lk_predictive", True) else set())
    s_t, m_t = t_step(t_state, il[3], ir[3], u=torch.from_numpy(u))

    assert bool(m_j["accept"]) and bool(m_t["accept"])
    T_j, T_t = np.asarray(m_j["T_21"]), m_t["T_21"].numpy()
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=1e-4, rtol=0)
    n_j, n_t = int(m_j["n_tracked"]), int(m_t["n_tracked"])
    assert n_j >= 30 and abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    assert set(s_t) - {"key"} == set(s_j) - {"key"}
    if "disp_grid" in s_t:
        np.testing.assert_allclose(s_t["disp_grid"].numpy(), np.asarray(s_j["disp_grid"]),
                                   atol=1e-3, rtol=0)
