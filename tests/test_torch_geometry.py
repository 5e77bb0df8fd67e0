"""Port parity: se3, camera, linalg_small and triangulate against the JAX package.

Same numpy inputs (seeded) go through both; outputs compared as float32.
Tolerance: rtol 1e-5 with atol 1e-5 on O(1) values. Both sides compute in
float32 but sum small products in their own order (XLA's dot vs torch's
matmul, FMA or not), so last-ulp differences are expected; 1e-5 is ~100 ulp
at 1.0 and far below any geometric effect.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.ops import linalg_small as jlin
from stereo_visual_odometry_tpu.ops import se3 as jse3
from stereo_visual_odometry_tpu.ops import triangulate as jtri
from stereo_visual_odometry_tpu_torch.ops import camera as tcam
from stereo_visual_odometry_tpu_torch.ops import linalg_small as tlin
from stereo_visual_odometry_tpu_torch.ops import se3 as tse3
from stereo_visual_odometry_tpu_torch.ops import triangulate as ttri

RTOL, ATOL = 1e-5, 1e-5


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def rotvecs(rng, n, scale=np.pi * 0.9):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.uniform(0.01, scale, size=(n, 1))).astype(np.float32)


@pytest.mark.parametrize("fn", ["so3_exp", "hat"])
def test_so3_functions(fn):
    w = rotvecs(np.random.default_rng(0), 64)
    close(getattr(tse3, fn)(torch.from_numpy(w)), getattr(jse3, fn)(jnp.asarray(w)))


def test_so3_log_and_se3_log_exp():
    rng = np.random.default_rng(1)
    R = np.array(jse3.so3_exp(jnp.asarray(rotvecs(rng, 64))))
    # arccos near theta=0 amplifies ulp differences: 1e-4 rad is still tiny.
    close(tse3.so3_log(torch.from_numpy(R)), jse3.so3_log(jnp.asarray(R)), atol=1e-4)
    xi = (rng.normal(size=(64, 6)) * 0.5).astype(np.float32)
    T = jse3.se3_exp(jnp.asarray(xi))
    close(tse3.se3_exp(torch.from_numpy(xi)), T)
    Tn = np.array(T)
    close(tse3.se3_log(torch.from_numpy(Tn)), jse3.se3_log(T), atol=1e-4)


def test_inv_transform_orthonormalize_euler():
    rng = np.random.default_rng(2)
    T = np.array(jse3.se3_exp(jnp.asarray(rng.normal(size=(16, 6)).astype(np.float32))))
    close(tse3.se3_inv(torch.from_numpy(T)), jse3.se3_inv(jnp.asarray(T)))
    pts = rng.normal(size=(100, 3)).astype(np.float32) * 10
    close(tse3.transform_points(torch.from_numpy(T[0]), torch.from_numpy(pts)),
          jse3.transform_points(jnp.asarray(T[0]), jnp.asarray(pts)), atol=1e-4)
    noisy = (T[:, :3, :3] + 0.01 * rng.normal(size=(16, 3, 3))).astype(np.float32)
    close(tse3.orthonormalize_newton(torch.from_numpy(noisy)),
          jse3.orthonormalize_newton(jnp.asarray(noisy)))
    small = np.array(jse3.so3_exp(jnp.asarray(rotvecs(rng, 16, scale=0.2))))
    close(tse3.euler_zyx(torch.from_numpy(small)), jse3.euler_zyx(jnp.asarray(small)))


def test_camera_and_rig():
    rng = np.random.default_rng(3)
    jr = jcam.StereoRig.kitti(cx=620.5, cy=188.0, baseline=0.537)
    tr = tcam.StereoRig.kitti(cx=620.5, cy=188.0, baseline=0.537)
    pc = np.stack([rng.uniform(-20, 20, 200), rng.uniform(-3, 3, 200),
                   rng.uniform(3, 80, 200)], -1).astype(np.float32)
    close(tr.left.project(torch.from_numpy(pc)), jr.left.project(jnp.asarray(pc)),
          atol=1e-3)  # pixels ~1e3: 1e-3 px is ~10 ulp
    px = rng.uniform(0, 1200, (200, 2)).astype(np.float32)
    d = rng.uniform(3, 80, 200).astype(np.float32)
    close(tr.left.unproject(torch.from_numpy(px), torch.from_numpy(d)),
          jr.left.unproject(jnp.asarray(px), jnp.asarray(d)), atol=1e-4)
    close(tr.P_left, jr.P_left)
    close(tr.P_right, jr.P_right, atol=1e-4)
    close(tr.baseline, jr.baseline)
    R = np.array(jse3.so3_exp(jnp.asarray([0.01, -0.02, 0.005])))
    jr2 = jcam.StereoRig.create(jcam.Pinhole.create(700, 710, 600, 180),
                                jcam.Pinhole.create(705, 712, 605, 182),
                                R_rl=R, t_rl=[-0.5, 0.01, 0.0])
    tr2 = tcam.StereoRig.create(tcam.Pinhole.create(700, 710, 600, 180),
                                tcam.Pinhole.create(705, 712, 605, 182),
                                R_rl=R, t_rl=[-0.5, 0.01, 0.0])
    close(tr2.T_rl, jr2.T_rl)
    close(tr2.P_right, jr2.P_right, atol=1e-3)


def test_linalg_small_cholesky_solve():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(32, 12, 12)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 12 * np.eye(12, dtype=np.float32)
    b = rng.normal(size=(32, 12)).astype(np.float32)
    Lt, okt = tlin.cholesky_unrolled_flagged(torch.from_numpy(A))
    Lj, okj = jlin.cholesky_unrolled_flagged(jnp.asarray(A))
    assert okt.numpy().tolist() == np.asarray(okj).tolist()
    close(tlin.cho_solve_unrolled(Lt, torch.from_numpy(b)),
          jlin.cho_solve_unrolled(Lj, jnp.asarray(b)), atol=1e-4)
    bad = A.copy()
    bad[:4] = 0.0  # not SPD: both flag it
    assert (tlin.cholesky_unrolled_flagged(torch.from_numpy(bad))[1].numpy().tolist()
            == np.asarray(jlin.cholesky_unrolled_flagged(jnp.asarray(bad))[1]).tolist())


def test_triangulate():
    rng = np.random.default_rng(5)
    jr = jcam.StereoRig.kitti(cx=620.5, cy=188.0)
    tr = tcam.StereoRig.kitti(cx=620.5, cy=188.0)
    assert ttri.is_rectified(tr) and jtri.is_rectified(jr)
    pl = rng.uniform(50, 1200, (300, 2)).astype(np.float32)
    pr = pl - np.stack([rng.uniform(-2, 90, 300), np.zeros(300)], -1).astype(np.float32)
    Xt, vt = ttri.stereo_depth_closed_form(tr, torch.from_numpy(pl), torch.from_numpy(pr))
    Xj, vj = jtri.stereo_depth_closed_form(jr, jnp.asarray(pl), jnp.asarray(pr))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    close(Xt[vt], np.asarray(Xj)[np.asarray(vj)], atol=1e-3)  # depths up to ~1.5e3 m
    Xt, vt = ttri.triangulate_dlt(tr.P_left, tr.P_right, torch.from_numpy(pl),
                                  torch.from_numpy(pr))
    Xj, vj = jtri.triangulate_dlt(jr.P_left, jr.P_right, jnp.asarray(pl), jnp.asarray(pr))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # DLT by a float32 eigensolver: relative 1e-3 on well-conditioned points.
    ok = vt.numpy() & (Xt[:, 2].numpy() < 100)
    np.testing.assert_allclose(Xt.numpy()[ok], np.asarray(Xj)[ok], rtol=1e-3, atol=1e-3)
    R = np.array(jse3.so3_exp(jnp.asarray([0.0, 0.01, 0.0])))
    rig = tcam.StereoRig.create(tr.left, tr.right, R_rl=R, t_rl=[-0.5, 0.0, 0.0])
    assert not ttri.is_rectified(rig)
