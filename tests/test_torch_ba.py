"""The port's bundle adjustment (``models/ba.py``) against the JAX module on
``tests/test_ba.py``'s synthetic window problems, and the JAX tests'
single-device properties run on the port.

Both sides run float32 on the CPU (JAX at ``Precision.HIGHEST``, torch with
TF32 off), the same formulas summed in another order. Tolerances: residuals
and Jacobians within 1e-4 relative; normal-equation blocks within 1e-4 of
their largest entry (sums over hundreds of observations); one Schur step
within 1e-3 of its largest update (a float32 LU of the (6K, 6K) reduced
system, condition ~1e4, and batched 3x3 inverses); a whole solve (up to 20 LM
steps, each accepted or rejected on float32 costs) poses within 1e-4,
landmarks within 1e-3 relative (8-40 m deep, least constrained along the
ray), costs within 1e-3 relative, and the same observations pruned.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import ba as jba
from stereo_visual_odometry_tpu.models import marg as jmarg
from stereo_visual_odometry_tpu_torch.models import ba
from stereo_visual_odometry_tpu_torch.ops import se3
from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole
from test_ba import make_ba_problem

T_RL = np.eye(4, dtype=np.float32)
T_RL[0, 3] = -0.12


def _cam(jcam):
    return Pinhole.create(*(float(getattr(jcam, k)) for k in ("fx", "fy", "cx", "cy")))


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(noise_px=0.3, stereo=False, outliers=0, **kw):
    """``make_ba_problem`` as numpy, optionally with a right-camera
    observation for every second observation and ``outliers`` corrupted
    pixels; returns (jcam, poses_gt, p0, x0, obs dict)."""
    jcam, poses_gt, pts_gt, p0, x0, obs = make_ba_problem(noise_px=noise_px, **kw)
    obs_kf, obs_lm, obs_uv, obs_w = (np.array(o) for o in obs)
    obs_right = None
    if stereo:
        sel = np.arange(0, len(obs_kf), 2)
        pc = np.einsum("mij,mj->mi", poses_gt[obs_kf[sel], :3, :3], pts_gt[obs_lm[sel]]) \
            + poses_gt[obs_kf[sel], :3, 3] + T_RL[:3, 3]
        uv_r = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                         500 * pc[:, 1] / pc[:, 2] + 240], -1).astype(np.float32)
        obs_right = np.r_[np.zeros(len(obs_kf), bool), np.ones(len(sel), bool)]
        obs_kf, obs_lm = np.r_[obs_kf, obs_kf[sel]], np.r_[obs_lm, obs_lm[sel]]
        obs_uv, obs_w = np.r_[obs_uv, uv_r], np.r_[obs_w, np.ones(len(sel), np.float32)]
    if outliers:
        rng = np.random.default_rng(5)
        idx = rng.choice(len(obs_uv), len(obs_uv) // outliers, replace=False)
        obs_uv[idx] += rng.uniform(20, 60, size=(len(idx), 2)).astype(np.float32)
    obs = dict(obs_kf=obs_kf, obs_lm=obs_lm, obs_uv=obs_uv, obs_w=obs_w, obs_right=obs_right)
    return jcam, poses_gt, p0, x0, obs


def _args(obs, torch_side):
    conv = _t if torch_side else jnp.asarray
    out = {k: conv(v) for k, v in obs.items() if v is not None}
    if obs["obs_right"] is not None:
        out["T_rl"] = conv(T_RL)
    return out


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("stereo", [False, True], ids=["left", "stereo"])
def test_project_residuals_matches_jax(stereo):
    jcam, _, p0, x0, obs = _problem(stereo=stereo)
    kf, lm = obs["obs_kf"], obs["obs_lm"]
    right = obs["obs_right"]
    want = jba.project_residuals(jcam, jnp.asarray(p0[kf]), jnp.asarray(x0[lm]),
                                 jnp.asarray(obs["obs_uv"]),
                                 None if right is None else jnp.asarray(right),
                                 None if right is None else jnp.asarray(T_RL))
    got = ba.project_residuals(_cam(jcam), _t(p0[kf]), _t(x0[lm]), _t(obs["obs_uv"]),
                               None if right is None else _t(right),
                               None if right is None else _t(T_RL))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("robust", ["huber", "gm"])
def test_assemble_normal_eqs_matches_jax(robust):
    jcam, _, p0, x0, obs = _problem(stereo=True, outliers=10)
    n_kf, n_lm = p0.shape[0], x0.shape[0]
    want = jba.assemble_normal_eqs(jcam, jnp.asarray(p0), jnp.asarray(x0),
                                   huber_px=2.0, n_kf=n_kf, n_lm=n_lm, robust=robust,
                                   **_args(obs, False))
    got = ba.assemble_normal_eqs(_cam(jcam), _t(p0), _t(x0), huber_px=2.0, n_kf=n_kf,
                                 n_lm=n_lm, robust=robust, **_args(obs, True))
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k].numpy(), want[k], 1e-4)
    assert int(got["n_active"]) == int(want["n_active"])


@pytest.mark.parametrize("cross", [False, True], ids=["plain", "Hpp_cross"])
def test_solve_schur_matches_jax(cross):
    """One damped Schur step; with ``Hpp_cross`` a marginalization prior's
    dense pose blocks (built by the JAX ``marg.build_prior``) join it."""
    jcam, _, p0, x0, obs = _problem(stereo=True)
    n_kf, n_lm = p0.shape[0], x0.shape[0]
    jeqs = jba.assemble_normal_eqs(jcam, jnp.asarray(p0), jnp.asarray(x0), huber_px=2.0,
                                   n_kf=n_kf, n_lm=n_lm, **_args(obs, False))
    teqs = {k: _t(v) for k, v in jeqs.items()}
    if cross:
        prior = jmarg.build_prior(jcam, jnp.asarray(p0), jnp.asarray(x0),
                                  huber_px=jnp.asarray(2.0, jnp.float32),
                                  **_args(obs, False))
        jeqs = dict(jeqs, Hpp_cross=prior["H"])
        teqs["Hpp_cross"] = _t(prior["H"])
    want = jba.solve_schur(jeqs, jnp.asarray(1e-3, jnp.float32), 1)
    got = ba.solve_schur(teqs, torch.tensor(1e-3), 1)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-3)
    assert not got[0][0].any()  # the gauge pose does not move


BA_CASES = {  # bundle_adjust keyword arguments on top of n_iters=8, n_fixed=1
    "huber": dict(gm_polish=False),
    "gnc": dict(gm_polish=True),
    "gnc_prune": dict(gm_polish=True, prune_px=8.0),
    "huber_prior": dict(gm_polish=False, prior=True),
}


@pytest.mark.parametrize("case", list(BA_CASES))
def test_bundle_adjust_matches_jax(case):
    """A whole stereo solve with outliers: GNC on and off, prune-and-repolish,
    and a marginalization prior over the window (the JAX ``build_prior`` of
    the same problem, its slots on poses 1..)."""
    jcam, _, p0, x0, obs = _problem(stereo=True, outliers=12)
    kw = dict(BA_CASES[case], n_iters=8, n_fixed=1)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("prior", False):
        jprior = jmarg.build_prior(jcam, jnp.asarray(p0), jnp.asarray(x0),
                                   huber_px=jnp.asarray(2.0, jnp.float32),
                                   **_args(obs, False))
        jkw["prior"], tkw["prior"] = jprior, {k: _t(v) for k, v in jprior.items()}
    want = jba.bundle_adjust(jcam, jnp.asarray(p0), jnp.asarray(x0), **_args(obs, False),
                             **jkw)
    got = ba.bundle_adjust(_cam(jcam), _t(p0), _t(x0), **_args(obs, True), **tkw)
    np.testing.assert_allclose(got["poses"].numpy(), np.asarray(want["poses"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["points"].numpy(), np.asarray(want["points"]),
                               atol=1e-3, rtol=1e-3)
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3)
    np.testing.assert_array_equal(got["obs_w"].numpy() > 0, np.asarray(want["obs_w"]) > 0)
    assert float(got["cost_final"]) < float(got["cost_initial"])


def _pose_errors(poses_est, poses_gt):
    d = se3.se3_log(torch.linalg.inv(_t(poses_gt)) @ _t(np.asarray(poses_est)))
    return torch.linalg.vector_norm(d, dim=-1).numpy()


def _zero_weight_case(cam, obs_uv, obs_w):
    """30% of the observations moved 300 px and given weight 0."""
    rng = np.random.default_rng(21)
    idx = rng.choice(len(obs_uv), len(obs_uv) // 3, replace=False)
    obs_uv, obs_w = obs_uv.copy(), obs_w.copy()
    obs_uv[idx] += 300.0
    obs_w[idx] = 0.0
    return obs_uv, obs_w


def _outlier_case(cam, obs_uv, obs_w):
    """10% of the observations moved 15-60 px."""
    rng = np.random.default_rng(22)
    idx = rng.choice(len(obs_uv), len(obs_uv) // 10, replace=False)
    obs_uv = obs_uv.copy()
    obs_uv[idx] += rng.uniform(15, 60, size=(len(idx), 2))
    return obs_uv, obs_w


# tests/test_ba.py:64-121 on the port: problem keywords, data change,
# bundle_adjust keywords, check.
PROPERTIES = {
    "reduces_cost_and_recovers_poses": (dict(), None, dict(n_iters=15, n_fixed=1), "recover"),
    "perfect_data_zero_cost": (dict(noise_px=0.0, pose_noise=0.0, point_noise=0.0), None,
                               dict(n_iters=3), "zero"),
    "fixed_poses_stay_fixed": (dict(n_kf=5), None, dict(n_iters=8, n_fixed=2), "fixed"),
    "ignores_zero_weight_observations": (dict(noise_px=0.1), _zero_weight_case,
                                         dict(n_iters=12, n_fixed=1), 0.02),
    "huber_robust_to_outliers": (dict(noise_px=0.2), _outlier_case,
                                 dict(n_iters=15, n_fixed=1, huber_px=2.0, prune_px=10.0),
                                 0.05),
}


@pytest.mark.parametrize("name", list(PROPERTIES))
def test_ba_properties(name):
    problem_kw, change, kw, check = PROPERTIES[name]
    jcam, poses_gt, pts_gt, p0, x0, obs = make_ba_problem(**problem_kw)
    obs_kf, obs_lm, obs_uv, obs_w = (np.array(o) for o in obs)
    if change is not None:
        obs_uv, obs_w = change(jcam, obs_uv, obs_w)
    if check == "zero":
        p0, x0 = poses_gt, pts_gt
    out = ba.bundle_adjust(_cam(jcam), _t(p0), _t(x0), _t(obs_kf), _t(obs_lm),
                           _t(obs_uv.astype(np.float32)), _t(obs_w), **kw)
    c0, c1 = float(out["cost_initial"]), float(out["cost_final"])
    e1 = _pose_errors(out["poses"], poses_gt)
    if check == "recover":
        e0 = _pose_errors(p0, poses_gt)
        assert c1 < 0.2 * c0
        assert e1.mean() < 0.3 * e0.mean() and e1.mean() < 0.02, (e0.mean(), e1.mean())
    elif check == "zero":
        assert c0 < 1e-3 and c1 <= c0 + 1e-6
    elif check == "fixed":
        np.testing.assert_allclose(out["poses"].numpy()[:2], p0[:2], atol=1e-6)
    else:
        assert e1.mean() < check, e1.mean()
