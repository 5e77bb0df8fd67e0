"""Port parity: the ``ops`` functions the main path does not call (camera
round trips, ``triangulate_stereo``, ``reprojection_error``,
``top_k_keypoints``, ``spd_solve``, ``orthonormalize``) against the JAX
package on seeded numpy inputs.

Integer and boolean outputs must be equal. Float32 outputs are held to 1e-5
relative to the array's largest magnitude (``close``): both sides compute in
float32 but sum small products in their own order. The exceptions say why
where they are made.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.ops import linalg_small as jlin
from stereo_visual_odometry_tpu.ops import se3 as jse3
from stereo_visual_odometry_tpu.ops import select as jsel
from stereo_visual_odometry_tpu.ops import triangulate as jtri
from stereo_visual_odometry_tpu_torch.ops import camera as tcam
from stereo_visual_odometry_tpu_torch.ops import linalg_small as tlin
from stereo_visual_odometry_tpu_torch.ops import se3 as tse3
from stereo_visual_odometry_tpu_torch.ops import select as tsel
from stereo_visual_odometry_tpu_torch.ops import triangulate as ttri

RTOL = 1e-5


def close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


def poses(rng, n):
    xi = np.concatenate([rng.normal(size=(n, 3)) * 2.0, rng.normal(size=(n, 3)) * 0.3], -1)
    return np.array(jse3.se3_exp(jnp.asarray(xi.astype(np.float32))))


def world_points(rng, n):
    return np.stack([rng.uniform(-20, 20, n), rng.uniform(-3, 3, n),
                     rng.uniform(5, 80, n)], -1).astype(np.float32)


def rigs():
    return jcam.StereoRig.kitti(cx=620.5, cy=188.0), tcam.StereoRig.kitti(cx=620.5, cy=188.0)


@pytest.mark.parametrize("batched", [False, True])
def test_camera_world_camera_pixel(batched):
    rng = np.random.default_rng(10 + batched)
    T = poses(rng, 4 if batched else 1)
    T = T if batched else T[0]
    pw = world_points(rng, 128)
    pw = np.broadcast_to(pw, T.shape[:-2] + pw.shape).copy()
    jr, tr = rigs()
    jT, tT = jnp.asarray(T), torch.from_numpy(T)
    close(tcam.world2camera(tT, torch.from_numpy(pw)), jcam.world2camera(jT, jnp.asarray(pw)))
    close(tcam.camera2world(tT, torch.from_numpy(pw)), jcam.camera2world(jT, jnp.asarray(pw)))
    px_t = tcam.world2pixel(tr.left, tT, torch.from_numpy(pw))
    px_j = jcam.world2pixel(jr.left, jT, jnp.asarray(pw))
    close(px_t, px_j)
    depth = rng.uniform(3, 80, pw.shape[:-1]).astype(np.float32)
    px = np.array(px_j)
    close(tcam.pixel2world(tr.left, tT, torch.from_numpy(px), torch.from_numpy(depth)),
          jcam.pixel2world(jr.left, jT, jnp.asarray(px), jnp.asarray(depth)))


def test_camera_pixel2world_scalar_depth():
    rng = np.random.default_rng(12)
    T = poses(rng, 1)[0]
    px = rng.uniform(0, 1200, (64, 2)).astype(np.float32)
    jr, tr = rigs()
    close(tcam.pixel2world(tr.left, torch.from_numpy(T), torch.from_numpy(px), 12.5),
          jcam.pixel2world(jr.left, jnp.asarray(T), jnp.asarray(px), 12.5))


def stereo_pairs(rng, n):
    pl = rng.uniform(50, 1200, (n, 2)).astype(np.float32)
    # Disparities from -2 px (behind the rig: invalid) to 90 px.
    pr = pl - np.stack([rng.uniform(-2, 90, n), rng.normal(size=n) * 0.3], -1).astype(np.float32)
    return pl, pr


def test_triangulate_stereo_rectified():
    rng = np.random.default_rng(13)
    jr, tr = rigs()
    pl, pr = stereo_pairs(rng, 300)
    Xt, vt = ttri.triangulate_stereo(tr, torch.from_numpy(pl), torch.from_numpy(pr))
    Xj, vj = jtri.triangulate_stereo(jr, jnp.asarray(pl), jnp.asarray(pr))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert 0 < int(vt.sum()) < len(vt)
    close(Xt[vt], np.asarray(Xj)[np.asarray(vj)])


def test_triangulate_stereo_general_rig():
    rng = np.random.default_rng(14)
    R = np.array(jse3.so3_exp(jnp.asarray([0.0, 0.01, 0.0])))
    jr0, tr0 = rigs()
    jr = jcam.StereoRig.create(jr0.left, jr0.right, R_rl=R, t_rl=[-0.5, 0.0, 0.0])
    tr = tcam.StereoRig.create(tr0.left, tr0.right, R_rl=R, t_rl=[-0.5, 0.0, 0.0])
    assert not ttri.is_rectified(tr) and not jtri.is_rectified(jr)
    # Correspondences of real points, so the DLT is well conditioned.
    pw = world_points(rng, 200)
    pl = np.array(jr.left.project(jnp.asarray(pw)))
    pr = np.array(jr.right.project(jse3.transform_points(jr.T_rl, jnp.asarray(pw))))
    Xt, vt = ttri.triangulate_stereo(tr, torch.from_numpy(pl), torch.from_numpy(pr))
    Xj, vj = jtri.triangulate_stereo(jr, jnp.asarray(pl), jnp.asarray(pr))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert bool(vt.all())
    # The DLT goes through a float32 eigensolver (LAPACK's against XLA's):
    # 1e-3 relative, as tests/test_torch_geometry.py's DLT test.
    close(Xt, Xj, rtol=1e-3)


def test_reprojection_error():
    rng = np.random.default_rng(15)
    jr, tr = rigs()
    T = poses(rng, 1)[0]
    pw = world_points(rng, 256)
    px = np.asarray(jcam.world2pixel(jr.left, jnp.asarray(T), jnp.asarray(pw)))
    px = (px + rng.normal(size=px.shape) * 2.0).astype(np.float32)
    et = ttri.reprojection_error(tr.left, torch.from_numpy(T), torch.from_numpy(pw),
                                 torch.from_numpy(px))
    ej = jtri.reprojection_error(jr.left, jnp.asarray(T), jnp.asarray(pw), jnp.asarray(px))
    assert et.shape == (256,)
    # A difference of two ~1e3 px numbers: 1e-5 of the pixels, not of the
    # ~2 px error.
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0,
                               atol=RTOL * np.abs(px).max())


@pytest.mark.parametrize("k", [1, 64, 500, 4096])
def test_top_k_keypoints_with_ties(k):
    rng = np.random.default_rng(16)
    # Few distinct levels and many zeros: long runs of equal scores, so the
    # order inside a tie decides which slots are kept.
    score = (rng.integers(0, 6, (48, 96)) * (rng.random((48, 96)) < 0.4)).astype(np.float32)
    xy_t, s_t, v_t = tsel.top_k_keypoints(torch.from_numpy(score), k)
    xy_j, s_j, v_j = jsel.top_k_keypoints(jnp.asarray(score), k)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    assert xy_t.dtype == torch.float32 and xy_t.shape == (k, 2)


@pytest.mark.parametrize("jitter", [0.0, 1e-2])
def test_spd_solve(jitter):
    rng = np.random.default_rng(17)
    M = rng.normal(size=(64, 6, 6)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(64, 6)).astype(np.float32)
    close(tlin.spd_solve(torch.from_numpy(A), torch.from_numpy(b), jitter=jitter),
          jlin.spd_solve(jnp.asarray(A), jnp.asarray(b), jitter=jitter))


@pytest.mark.parametrize("reflect", [False, True])
def test_orthonormalize(reflect):
    rng = np.random.default_rng(18)
    R = np.array(jse3.so3_exp(jnp.asarray(rng.normal(size=(32, 3)).astype(np.float32))))
    noisy = (R + 0.02 * rng.normal(size=R.shape)).astype(np.float32)
    if reflect:  # det < 0: the SVD's sign fix must bring it back to SO(3)
        noisy[:, :, 2] *= -1
    Rt = tse3.orthonormalize(torch.from_numpy(noisy))
    # With a reflection the sign fix turns the third singular pair, whose
    # float32 error is eps over the gap between singular values (all near 1
    # here, ~0.02 apart): 1e-4 relative for it, LAPACK's SVD against XLA's.
    close(Rt, jse3.orthonormalize(jnp.asarray(noisy)), rtol=1e-4 if reflect else RTOL)
    np.testing.assert_allclose(torch.linalg.det(Rt).numpy(), 1.0, atol=1e-5)
