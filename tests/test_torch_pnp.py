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
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp

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
