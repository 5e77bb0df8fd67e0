"""The port's Schur marginalization (``models/marg.py``) against the JAX
module on ``tests/test_marg.py``'s problem, and that file's three
properties run on the port.

Both sides float32 on the CPU. Tolerances: a prior's H and b within 1e-3
of their largest entry (a 3x3 inverse per landmark and a 6x6 solve in
float32 over entries up to ~1e5), T_lin and the mask exact; deltas within
1e-5 rad / m; folded equations within 1e-4 of their largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import marg as jmarg
from stereo_visual_odometry_tpu_torch.models import ba, marg
from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole
from test_marg import _make_problem


def _t(a):
    return torch.from_numpy(np.array(a))


def _cam(jcam):
    return Pinhole.create(*(float(getattr(jcam, k)) for k in ("fx", "fy", "cx", "cy")))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


def _build_both(poses, carry=False, seed=0):
    """The prior of ``_make_problem``'s system in both packages (numpy
    leaves); with ``carry`` an earlier prior, shifted to ``poses`` and
    decayed by 0.5, is folded in, as ``SlidingWindowBA`` does."""
    jcam, pts, _, _, okf, olm, ouv = _make_problem(seed=seed)
    w = np.ones(len(okf), np.float32)
    obs = (okf, olm, ouv, w)
    jkw, tkw = {}, {}
    if carry:
        first = jmarg.build_prior(jcam, jnp.asarray(poses), jnp.asarray(pts),
                                  *map(jnp.asarray, obs), jnp.asarray(2.0, jnp.float32))
        H, b = jmarg.shift_prior(first, jnp.asarray(poses))
        jkw = dict(carry_H=0.5 * H, carry_b=0.5 * b)
        tkw = {k: _t(v) for k, v in jkw.items()}
    want = jmarg.build_prior(jcam, jnp.asarray(poses), jnp.asarray(pts),
                             *map(jnp.asarray, obs), jnp.asarray(2.0, jnp.float32), **jkw)
    got = marg.build_prior(_cam(jcam), _t(poses), _t(pts), *map(_t, obs), 2.0, **tkw)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_build_prior_matches_jax(carry):
    _, _, _, poses0, *_ = _make_problem()
    got, want = _build_both(poses0, carry)
    assert got.keys() == want.keys()
    _close(got["H"], want["H"], 1e-3)
    _close(got["b"], want["b"], 1e-3)
    np.testing.assert_array_equal(got["T_lin"], want["T_lin"])
    np.testing.assert_array_equal(got["mask"], want["mask"])


def _moved(prior_np, scale=0.02, seed=3):
    """The prior's linearization points moved by up to a few cm / mrad."""
    rng = np.random.default_rng(seed)
    poses = prior_np["T_lin"].copy()
    for k in range(poses.shape[0] - 1):
        poses[k][:3, 3] += rng.normal(size=3).astype(np.float32) * scale
    return poses


def test_prior_deltas_and_shift_match_jax():
    _, _, _, poses0, *_ = _make_problem()
    _, want = _build_both(poses0)
    prior_t = {k: _t(v) for k, v in want.items()}
    poses_now = _moved(want)
    d_t = marg.prior_deltas(prior_t, _t(poses_now)).numpy()
    d_j = np.asarray(jmarg.prior_deltas(want, jnp.asarray(poses_now)))
    np.testing.assert_allclose(d_t, d_j, atol=1e-5, rtol=0)
    H_t, b_t = marg.shift_prior(prior_t, _t(poses_now))
    H_j, b_j = jmarg.shift_prior(want, jnp.asarray(poses_now))
    np.testing.assert_array_equal(H_t.numpy(), np.asarray(H_j))
    _close(b_t.numpy(), b_j, 1e-4)


def test_add_prior_to_eqs_matches_jax():
    jcam, pts, _, poses0, okf, olm, ouv = _make_problem()
    _, want = _build_both(poses0)
    poses_now = _moved(want)
    w = np.ones(len(okf), np.float32)
    K, L = poses_now.shape[0], pts.shape[0]
    eqs = ba.assemble_normal_eqs(_cam(jcam), _t(poses_now), _t(pts), _t(okf), _t(olm),
                                 _t(ouv), _t(w), 2.0, K, L)
    got = marg.add_prior_to_eqs(eqs, {k: _t(v) for k, v in want.items()}, _t(poses_now))
    ref = jmarg.add_prior_to_eqs({k: jnp.asarray(v.numpy()) for k, v in eqs.items()},
                                 want, jnp.asarray(poses_now))
    assert got.keys() == ref.keys()
    for k in ("bp", "Hpp_cross", "cost"):
        _close(got[k].numpy(), ref[k], 1e-4)


def test_empty_prior_matches_jax():
    got, want = marg.empty_prior(4), jmarg.empty_prior(4)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == (torch.bool if k == "mask" else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# tests/test_marg.py's three properties, on the port.

def test_build_prior_structure():
    """Symmetry, mask and linearization points of the built prior; real,
    positive semi-definite information on the surviving slots."""
    _, _, _, poses0, *_ = _make_problem()
    got, _ = _build_both(poses0)
    H = got["H"]
    K = H.shape[0]
    for k in range(K):
        for j in range(K):
            np.testing.assert_allclose(H[k, j], H[j, k].T, atol=1e-3)
    assert got["mask"][: K - 1].all() and not got["mask"][K - 1]
    np.testing.assert_allclose(got["T_lin"][0], poses0[1], atol=1e-6)
    assert np.abs(H[K - 1]).max() == 0.0
    assert np.abs(H[: K - 1, : K - 1]).max() > 1.0
    Hf = H[:K - 1, :K - 1].transpose(0, 2, 1, 3).reshape(6 * (K - 1), -1)
    eigs = np.linalg.eigvalsh(0.5 * (Hf + Hf.T))
    assert eigs.min() > -1e-2 * max(eigs.max(), 1.0), eigs.min()


def test_prior_carries_marginalized_information():
    """After kf0 and most landmarks are marginalized, the remaining sparse
    window solved with the prior lands closer to the truth than without."""
    jcam, pts, poses_gt, poses0, okf, olm, ouv = _make_problem(
        K=3, L=40, noise_px=0.2, perturb=0.08)
    cam, L_dead = _cam(jcam), 32
    dead = olm < L_dead
    w = np.ones(len(okf), np.float32)
    prior3 = marg.build_prior(cam, _t(poses0), _t(pts), _t(okf[dead]), _t(olm[dead]),
                              _t(ouv[dead]), _t(w[dead]), 2.0)
    prior = {k: v[:2, :2] if k == "H" else v[:2] for k, v in prior3.items()}
    live = (olm >= L_dead) & (okf >= 1)
    okf_w, olm_w = okf[live] - 1, olm[live] - L_dead

    def solve(use_prior):
        out = ba.bundle_adjust(cam, _t(poses0[1:]), _t(pts[L_dead:]), _t(okf_w), _t(olm_w),
                               _t(ouv[live]), torch.ones(len(okf_w)), n_iters=10,
                               n_fixed=1, gm_polish=False,
                               prior=prior if use_prior else None)
        return out["poses"].numpy()

    err = lambda p: np.abs(p[1] - poses_gt[2]).max()  # kf2's pose error
    e_without, e_with = err(solve(False)), err(solve(True))
    assert e_with < 0.9 * e_without, (e_with, e_without)
    assert e_with < 0.15, e_with


def test_shift_prior_gradient_consistency():
    """Re-expressed at new poses, the prior's gradient there is H delta + b."""
    _, _, _, poses0, *_ = _make_problem()
    got, _ = _build_both(poses0)
    prior = {k: _t(v) for k, v in got.items()}
    poses_now = _moved(got)
    delta = marg.prior_deltas(prior, _t(poses_now)).numpy()
    want = np.einsum("kjab,jb->ka", got["H"], delta) + got["b"]
    H_s, b_s = marg.shift_prior(prior, _t(poses_now))
    np.testing.assert_allclose(b_s.numpy(), want, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(H_s.numpy(), got["H"], atol=0)
