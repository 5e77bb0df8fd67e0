"""Port parity: pyramid, plane sweep, FAST, grid top-K and subpixel refine.

Inputs are the port's synthetic stereo frames (seeded, 192x256), handed to
both packages as the same numpy arrays. Tolerances:
  * pyramid: atol 1e-4 on 0-255 images (the JAX side halves by matmul, the
    port by pairwise means; the sums may round in another order);
  * FAST scores and grid top-K outputs: exact (elementwise / integer ops,
    and the port breaks ties the JAX way);
  * sweep: equal disparity on >= 99.9% of pixels (box sums in another
    order can flip an argmin on a near-tie);
  * subpixel refine: atol 1e-6 px (a few float32 divisions).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import fast as jfast
from stereo_visual_odometry_tpu.ops import pyramid as jpyr
from stereo_visual_odometry_tpu.ops import select as jsel
from stereo_visual_odometry_tpu.ops import stereo_sweep as jsweep
from stereo_visual_odometry_tpu_torch.ops import fast as tfast
from stereo_visual_odometry_tpu_torch.ops import pyramid as tpyr
from stereo_visual_odometry_tpu_torch.ops import select as tsel
from stereo_visual_odometry_tpu_torch.ops import stereo_sweep as tsweep
from stereo_visual_odometry_tpu_torch.utils import synthetic


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.render_sequence(n_frames=2, h=192, w=256, fx=300.0,
                                    speed=1.0, seed=1)
    return seq["images_l"], seq["images_r"]


def test_pyramid(frames):
    img = frames[0][0]
    pj = jpyr.build_pyramid(jnp.asarray(img), 4)
    pt = tpyr.build_pyramid(torch.from_numpy(img), 4)
    assert [tuple(p.shape) for p in pt] == [p.shape for p in pj]
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_disparity_sweep(frames):
    l = np.array(jpyr.build_pyramid(jnp.asarray(frames[0][1]), 3)[2])
    r = np.array(jpyr.build_pyramid(jnp.asarray(frames[1][1]), 3)[2])
    dj = np.array(jsweep.disparity_sweep(jnp.asarray(l), jnp.asarray(r), d_max=24))
    dt = tsweep.disparity_sweep(torch.from_numpy(l), torch.from_numpy(r), d_max=24)
    assert dt.dtype == torch.float32 and dt.shape == dj.shape
    assert (dt.numpy() == dj).mean() >= 0.999
    xy = np.random.default_rng(0).uniform(0, 255, (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tsweep.sample_map(torch.from_numpy(dj), torch.from_numpy(xy), 4.0).numpy(),
        np.asarray(jsweep.sample_map(jnp.asarray(dj), jnp.asarray(xy), 4.0)))


@pytest.mark.parametrize("threshold", [20.0, 7.0])
def test_fast_scores_exact(frames, threshold):
    img = frames[0][0]
    np.testing.assert_array_equal(
        tfast.fast_score(torch.from_numpy(img), threshold).numpy(),
        np.asarray(jfast.fast_score(jnp.asarray(img), threshold)))
    np.testing.assert_array_equal(
        tfast.detect(torch.from_numpy(img), threshold).numpy(),
        np.asarray(jfast.detect(jnp.asarray(img), threshold)))


def test_grid_top_k_exact_with_ties():
    # Few distinct score values: many ties inside cells and across them.
    rng = np.random.default_rng(7)
    score = (rng.integers(0, 6, (96, 128)) * 5.0).astype(np.float32)
    score[rng.random(score.shape) < 0.5] = 0.0
    for k in (64, 200):
        xt, st, vt = tsel.grid_top_k(torch.from_numpy(score), k, cell=32, k_per_cell=8)
        xj, sj, vj = jsel.grid_top_k(jnp.asarray(score), k, cell=32, k_per_cell=8)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_detect_select_refine_on_frame(frames):
    """FAST -> grid top-K -> subpixel on a real frame; the JAX side runs the
    K1 path of ``subpixel_refine`` in Pallas interpret mode."""
    img = frames[0][0]
    score_j = jfast.detect(jnp.asarray(img), 20.0)
    score_t = tfast.detect(torch.from_numpy(img), 20.0)
    xj, _, vj = jsel.grid_top_k(score_j, 256, cell=32, k_per_cell=8)
    xt, _, vt = tsel.grid_top_k(score_t, 256, cell=32, k_per_cell=8)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert 50 < int(vt.sum()) <= 256
    rj = jsel.subpixel_refine(score_j, xj, vj, use_pallas=True, interpret=True)
    rt = tsel.subpixel_refine(score_t, xt, vt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6, rtol=0)
