"""Port parity: RANSAC-PnP, its Gauss-Newton refinement and the DLT pose.

``ransac_pnp`` gets the JAX-drawn hypothesis uniforms ``u`` injected, so both
packages score the same samples. Tolerances: poses within 1e-4 (rotation
entries, metres) — float32 Gauss-Newton on ~200 points, with the normal
equations summed in another order; inlier sets equal on >= 99% of points
(a residual on the 0.5 px gate can fall either side); the DLT pose within
1e-3 on 20-point samples (three inverse-iteration sweeps on a 12x12 system).
On minimal 6-point samples the float32 DLT is ill-conditioned on both
sides: each package degenerates on some samples, not the same ones, and
RANSAC's scoring drops them, so that case is compared through
``ransac_pnp`` above and not per sample.

The routes of the port's wrapper (the CUDA kernels are held to the plain
version in ``tests/test_torch_cuda.py``): a CPU tensor runs the plain
version and nothing else; under ``torch.func.vmap`` the custom op
``svo::ransac_pnp``'s CPU kernel equals the wrapper once per sequence, bit
for bit, whatever vmap batches; the CUDA launcher refuses bad inputs before
it builds or launches anything.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.ops import pnp as jpnp
from stereo_visual_odometry_tpu.ops import se3 as jse3
from stereo_visual_odometry_tpu_torch.ops import camera as tcam
from stereo_visual_odometry_tpu_torch.ops import native
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.probes import pnp_timing

FX, CX, CY = 718.856, 607.19, 185.22


def problem(seed, n=200, noise_px=0.3, outlier_frac=0.2):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                    rng.uniform(5, 40, n)], -1).astype(np.float32)
    xi = (rng.normal(size=6) * np.array([0.3, 0.3, 0.3, 0.05, 0.05, 0.05])).astype(np.float32)
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    px = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FX * pc[:, 1] / pc[:, 2] + CY], -1)
    px += rng.normal(size=px.shape) * noise_px
    n_out = int(outlier_frac * n)
    idx = rng.choice(n, n_out, replace=False)
    px[idx] += rng.uniform(20, 100, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    valid = rng.random(n) > 0.1
    return pts, px.astype(np.float32), valid, T


@pytest.mark.parametrize("seed,with_init", [(0, True), (1, False), (2, True)])
def test_ransac_pnp_with_injected_draws(seed, with_init):
    pts, px, valid, T_gt = problem(seed)
    H = 128
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, (H, 6)))  # what ransac_pnp draws
    T_init = (np.array(jse3.se3_exp(jnp.asarray([0.05, 0, 0.1, 0, 0.01, 0]))) @ T_gt
              ).astype(np.float32) if with_init else None
    rj = jpnp.ransac_pnp(jcam.Pinhole.create(FX, FX, CX, CY), jnp.asarray(pts),
                         jnp.asarray(px), jnp.asarray(valid), key,
                         num_hypotheses=H, inlier_px=0.5, refine_iters=6,
                         T_init=None if T_init is None else jnp.asarray(T_init))
    rt = tpnp.ransac_pnp(tcam.Pinhole.create(FX, FX, CX, CY), torch.from_numpy(pts),
                         torch.from_numpy(px), torch.from_numpy(valid),
                         num_hypotheses=H, inlier_px=0.5, refine_iters=6,
                         T_init=None if T_init is None else torch.from_numpy(T_init),
                         u=torch.from_numpy(u))
    np.testing.assert_allclose(rt["T"].numpy(), np.asarray(rj["T"]), atol=1e-4, rtol=0)
    assert (rt["inliers"].numpy() == np.asarray(rj["inliers"])).mean() >= 0.99
    assert abs(int(rt["num_inliers"]) - int(rj["num_inliers"])) <= 2
    assert bool(rt["ok"]) == bool(rj["ok"])
    # And both found the true pose.
    np.testing.assert_allclose(rt["T"].numpy(), T_gt, atol=2e-2)


def test_ransac_pnp_draws_from_generator():
    pts, px, valid, T_gt = problem(3)
    cam = tcam.Pinhole.create(FX, FX, CX, CY)
    args = (cam, torch.from_numpy(pts), torch.from_numpy(px), torch.from_numpy(valid))
    a = tpnp.ransac_pnp(*args, num_hypotheses=64, inlier_px=0.5,
                        generator=torch.Generator().manual_seed(5))
    b = tpnp.ransac_pnp(*args, num_hypotheses=64, inlier_px=0.5,
                        generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a["T"], b["T"], rtol=0, atol=0)
    np.testing.assert_allclose(a["T"].numpy(), T_gt, atol=2e-2)
    with pytest.raises(ValueError):
        tpnp.ransac_pnp(*args, num_hypotheses=64, u=torch.rand(8, 6))


def test_gauss_newton_pose():
    pts, px, valid, T_gt = problem(4, outlier_frac=0.0, noise_px=0.1)
    dxi = np.array([0.05, -0.02, 0.04, 0.01, -0.01, 0.005], np.float32)
    T0 = (np.array(jse3.se3_exp(jnp.asarray(dxi))) @ T_gt).astype(np.float32)
    w = valid.astype(np.float32)
    Tj = jpnp.gauss_newton_pose(jcam.Pinhole.create(FX, FX, CX, CY), jnp.asarray(T0),
                                jnp.asarray(pts), jnp.asarray(px), jnp.asarray(w),
                                iters=10)
    Tt = tpnp.gauss_newton_pose(tcam.Pinhole.create(FX, FX, CX, CY), torch.from_numpy(T0),
                                torch.from_numpy(pts), torch.from_numpy(px),
                                torch.from_numpy(w), iters=10)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4, rtol=0)


def test_dlt_pose_batched():
    pts, px, valid, T_gt = problem(5, outlier_frac=0.0, noise_px=0.3)
    norm = np.stack([(px[:, 0] - CX) / FX, (px[:, 1] - CY) / FX], -1).astype(np.float32)
    rng = np.random.default_rng(6)
    idx = np.stack([rng.choice(len(pts), 20, replace=False) for _ in range(16)])
    mask = (rng.random((16, 20)) > 0.1).astype(np.float32)
    Tj = jax.vmap(jpnp._dlt_pose)(jnp.asarray(pts[idx]), jnp.asarray(norm[idx]),
                                  jnp.asarray(mask))
    Tt = tpnp._dlt_pose(torch.from_numpy(pts[idx]), torch.from_numpy(norm[idx]),
                        torch.from_numpy(mask))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-3, rtol=0)


def _no_native(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the CPU route reached the CUDA entry {name}")
    monkeypatch.setattr(native, "entry", refuse)


@pytest.mark.parametrize("init,orb", [(True, True), (False, False)])
def test_cpu_route_is_the_plain_version(monkeypatch, init, orb):
    """A CPU tensor takes the plain version, bit for bit, launches nothing
    and counts nothing."""
    _no_native(monkeypatch)
    x = {k: v[0] for k, v in pnp_timing.problem(1, 200, 64, seed=7, device="cpu").items()}
    cam = pnp_timing.camera("cpu")
    before = tpnp.ransac_pnp.launches
    got = pnp_timing.call(cam, 64, init, orb)(*(x[k] for k in pnp_timing.ARGS))
    want = pnp_timing.call(cam, 64, init, orb, plain=True)(*(x[k] for k in pnp_timing.ARGS))
    assert tpnp.ransac_pnp.launches == before
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert int(got[2]) > 100  # a real pose was found


# name -> (in_dims of (pts, px, valid, u, T_init, weights), T_init and weights given)
VMAP_CASES = {"axis0": (0, True), "axis1": (1, True), "plain_inputs": (0, False),
              "shared_points": ((None, 0, 0, 0, 0, 0), True)}


@pytest.mark.parametrize("case", list(VMAP_CASES))
def test_op_under_vmap_equals_a_loop_over_sequences(monkeypatch, case):
    """``ransac_pnp`` under ``torch.func.vmap`` goes through the op's batch
    rule, whose CPU kernel runs the plain version once per sequence: equal
    bit for bit to the wrapper called per sequence, with the sequence axis
    first or second, without ``T_init`` and weights, and with points vmap
    did not batch (the rule broadcasts them)."""
    _no_native(monkeypatch)
    dims, full = VMAP_CASES[case]
    x = pnp_timing.problem(3, 120, 32, seed=len(case), device="cpu")
    cam = pnp_timing.camera("cpu")
    fn = pnp_timing.call(cam, 32, full, full)
    args = [x[k] for k in pnp_timing.ARGS]
    if dims is None or isinstance(dims, tuple):
        args[0] = args[0][0]
    if dims == 1:
        args = [a.movedim(0, 1) for a in args]
    got = torch.func.vmap(fn, in_dims=dims)(*args)
    for s in range(3):
        one = [a if d is None else a.select(d, s)
               for a, d in zip(args, dims if isinstance(dims, tuple) else (dims,) * 6)]
        for g, w in zip(got, fn(*one), strict=True):
            assert torch.equal(g[s], w)


def test_op_refuses_a_batched_camera():
    """The batch rule takes one camera for all sequences: intrinsics that
    vmap batches raise a ValueError."""
    x = pnp_timing.problem(2, 40, 16, device="cpu")
    cam = pnp_timing.camera("cpu")
    fn = lambda fx, p, q, v, u: tpnp.ransac_pnp(
        tcam.Pinhole(fx, cam.fy, cam.cx, cam.cy), p, q, v, num_hypotheses=16, u=u)
    with pytest.raises(ValueError, match="one camera"):
        torch.func.vmap(fn)(cam.fx.expand(2), *(x[k] for k in ("pts", "px", "valid", "u")))


def test_launcher_checks_before_it_builds(monkeypatch):
    """``pnp.launch`` refuses what the kernels cannot take with a
    ValueError before it builds or launches anything."""
    _no_native(monkeypatch)
    x = {k: v[0] for k, v in pnp_timing.problem(1, 50, 16, device="cpu").items()}
    cam = pnp_timing.camera("cpu")
    good = [x[k] for k in pnp_timing.ARGS]
    bad = {0: x["pts"].double(), 1: x["px"][:10], 2: x["valid"].float(),
           3: x["u"][:, :5], 4: x["T_init"][:3], 5: x["weights"][:7]}
    for i, t in bad.items():
        args = list(good)
        args[i] = t
        with pytest.raises(ValueError):
            tpnp.launch(cam.fx, cam.fy, cam.cx, cam.cy, *args, 0.5, 6)
    with pytest.raises(ValueError, match="intrinsics"):
        tpnp.launch(cam.fx, cam.fy.double(), cam.cx, cam.cy, *good, 0.5, 6)
