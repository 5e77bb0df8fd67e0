"""Port ORB (``ops/orb.py``, ``ops/orb_pattern.py``, ``ops/interp.py``, the
ORB half of ``ops/pyramid.py`` and ``select.dedup_by_bin``) against the JAX
package on the CPU.

The JAX side runs K1 and K2 as Pallas kernels in interpret mode
(``torch_jax_kernels.jax_pallas_kernels``). Inputs are seeded numpy
textures (no flat regions, see ``torch_jax_kernels.with_sensor_noise``), at
128x320 with 4 levels and 256 features. Tolerances:
  * pattern table, sampling matrices, level budgets, ``pack_bits`` and
    ``dedup_by_bin``: exact;
  * ``interp``: 1e-4 abs (float32 elementwise, XLA may contract into FMAs);
  * ``scale_pyramid`` and ``gaussian_blur``: 1e-3 abs (matmuls summed in
    another order);
  * per-level FAST, top-K and subpixel given the JAX level image: exact;
  * BRIEF bits against a float64 numpy evaluation of the same patches:
    median Hamming 0 and at most 1e-4 of the meaningful bits (|pair
    difference| > 1) flipped, the criterion of ``bench.py:463-467``; the
    upright bin-0 product equals the all-bins result exactly;
  * ``detect_and_describe(_pair)``: >= 99% of valid slots with the same xy
    within 1e-3 px and the same descriptor.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import fast as jfast
from stereo_visual_odometry_tpu.ops import interp as jinterp
from stereo_visual_odometry_tpu.ops import orb as jorb
from stereo_visual_odometry_tpu.ops import orb_pattern as jpattern
from stereo_visual_odometry_tpu.ops import pyramid as jpyr
from stereo_visual_odometry_tpu.ops import select as jselect
from stereo_visual_odometry_tpu_torch.ops import interp, orb, orb_pattern, patch, pyramid
from stereo_visual_odometry_tpu_torch.ops import select
from torch_jax_kernels import jax_pallas_kernels, textured

H, W = 128, 320
KW = dict(n_features=256, levels=4)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    il = textured(rng, H, W)
    ir = np.roll(il, -6, axis=1) + rng.normal(0, 0.5, il.shape).astype(np.float32)
    return il, ir.astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def test_pattern_table_and_sampling_matrices_equal_jax():
    np.testing.assert_array_equal(orb_pattern.BIT_PATTERN_31, jpattern.BIT_PATTERN_31)
    assert orb_pattern.pattern_pairs().dtype == np.float32
    np.testing.assert_array_equal(orb_pattern.pattern_pairs(), jpattern.pattern_pairs())
    np.testing.assert_array_equal(orb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    all_bins = np.asarray(jorb._bin_diff_weights())
    np.testing.assert_array_equal(orb._bin_diff_np(False), all_bins)
    np.testing.assert_array_equal(orb._bin_diff_np(True), all_bins[:1])
    np.testing.assert_array_equal(orb._make_pattern(), jorb._make_pattern())
    np.testing.assert_array_equal(orb.IC_MASK, jorb.IC_MASK)
    np.testing.assert_array_equal(orb.IC_X, jorb.IC_X)
    np.testing.assert_array_equal(orb.IC_Y, jorb.IC_Y)


@pytest.mark.parametrize("n,levels,scale", [(2048, 8, 1.2), (256, 4, 1.2), (1000, 6, 1.3)])
def test_level_budgets_equal_jax(n, levels, scale):
    got = orb._level_budgets(n, levels, scale)
    assert got == jorb._level_budgets(n, levels, scale) and sum(got) == n
    if (n, levels) == (2048, 8):
        assert got == [445, 371, 309, 257, 214, 179, 149, 124]


def test_interp_matches_jax():
    rng = np.random.default_rng(0)
    img = textured(rng, 40, 56)
    xy = np.stack([rng.uniform(-5, 60, 300), rng.uniform(-5, 45, 300)], -1).astype(np.float32)
    np.testing.assert_allclose(interp.bilinear(t(img), t(xy)).numpy(),
                               np.asarray(jinterp.bilinear(jnp.asarray(img), jnp.asarray(xy))),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(interp.patch_grid(7).numpy(), np.asarray(jinterp.patch_grid(7)))
    np.testing.assert_allclose(
        interp.sample_patch(t(img), t(xy[0]), 9).numpy(),
        np.asarray(jinterp.sample_patch(jnp.asarray(img), jnp.asarray(xy[0]), 9)),
        atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        interp.sample_patches(t(img), t(xy[:20]), 11).numpy(),
        np.asarray(jinterp.sample_patches(jnp.asarray(img), jnp.asarray(xy[:20]), 11)),
        atol=1e-4, rtol=0)


def test_scale_pyramid_and_blur_match_jax(pair):
    imgs = np.stack(pair)
    jp = jpyr.scale_pyramid(jnp.asarray(imgs), 8, 1.2)
    tp = pyramid.scale_pyramid(t(imgs), 8, 1.2)
    assert [tuple(a.shape) for a in tp] == [tuple(a.shape) for a in jp]
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3, rtol=0)
        np.testing.assert_allclose(pyramid.gaussian_blur(b).numpy(),
                                   np.asarray(jpyr.gaussian_blur(a)), atol=1e-3, rtol=0)
    np.testing.assert_allclose(
        pyramid.resize_bilinear(t(imgs[0]), 50, 77).numpy(),
        np.asarray(jpyr.resize_bilinear(jnp.asarray(imgs[0]), 50, 77)), atol=1e-3, rtol=0)


def _jax_level_select(level_img, budget, ph, pw, ini_th=20.0, min_th=7.0, cell=32,
                      k_per_cell=8):
    """The JAX ``level_select`` of ``detect_and_describe_pair``
    (``orb.py:369-384``), step for step."""
    h, w = level_img.shape
    score_lo = jfast.detect(level_img, min_th)
    score = jnp.where(score_lo > ini_th, score_lo + 1e4, score_lo)
    score = jnp.pad(score, ((0, ph - h), (0, pw - w)))
    row = jnp.arange(ph)[:, None]
    col = jnp.arange(pw)[None, :]
    e = jorb.EDGE
    score = jnp.where((row >= e) & (row < h - e) & (col >= e) & (col < w - e), score, 0.0)
    xy, sc, valid = jselect.grid_top_k(score, budget, cell=cell, k_per_cell=k_per_cell)
    sc = jnp.where(sc > 1e4, sc - 1e4, sc)
    raw = jnp.pad(score_lo, ((0, ph - h), (0, pw - w)))
    return jselect.subpixel_refine(raw, xy, valid), sc, valid


def test_level_select_exact_given_jax_level_image(pair):
    levels = jpyr.scale_pyramid(jnp.asarray(pair[0]), 4, 1.2)
    with jax_pallas_kernels():
        for lvl, budget in enumerate(orb._level_budgets(256, 4, 1.2)):
            img = levels[lvl]
            h, w = img.shape
            ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
            want = _jax_level_select(img, budget, ph, pw)
            got = orb._level_select(t(img), budget, ph, pw, 20.0, 7.0, 32, 8)
            assert int(np.asarray(want[2]).sum()) > budget // 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _orb_patches(img, n=96, seed=3):
    rng = np.random.default_rng(seed)
    blur = pyramid.gaussian_blur(t(img))
    xy = np.stack([rng.uniform(19, img.shape[1] - 20, n),
                   rng.uniform(19, img.shape[0] - 20, n)], -1).astype(np.float32)
    return patch.extract_patches(blur, t(xy), orb.DESC_PATCH)


def _bits_f64(patches, angle):
    """Independent float64 evaluation: each point's own bin's differences."""
    D = orb._bin_diff_np(False).astype(np.float64)
    bins = np.round(np.mod(angle.astype(np.float64), 2 * np.pi) / (2 * np.pi)
                    * orb.N_ANGLE_BINS).astype(int) % orb.N_ANGLE_BINS
    flat = patches.reshape(len(patches), -1).astype(np.float64)
    return np.einsum("np,nkp->nk", flat, D[bins])


@pytest.mark.parametrize("upright", [True, False])
def test_brief_bits_match_f64(pair, upright):
    patches = _orb_patches(pair[0])
    ang = orb.ic_angle_from_patches(orb._ic_crop(patches))
    bits = orb.brief_bits_from_patches(patches, None if upright else ang).numpy()
    diffs = _bits_f64(patches.numpy(), np.zeros(len(bits)) if upright else ang.numpy())
    flipped = bits.astype(bool) != (diffs > 0)
    assert np.median(flipped.sum(1)) == 0
    meaningful = np.abs(diffs) > 1.0
    assert (flipped & meaningful).sum() <= 1e-4 * meaningful.sum()
    if upright:  # the bin-0 cut equals the all-bins product at angle 0
        zeros = torch.zeros(len(bits))
        np.testing.assert_array_equal(orb.brief_bits_from_patches(patches, zeros).numpy(),
                                      bits)


def test_brief_ic_angle_and_pack_match_jax(pair):
    patches = _orb_patches(pair[1], seed=4)
    jp = jnp.asarray(patches.numpy())
    ang_j = np.asarray(jorb.ic_angle_from_patches(jorb._ic_crop(jp)))
    ang_t = orb.ic_angle_from_patches(orb._ic_crop(patches))
    np.testing.assert_allclose(ang_t.numpy(), ang_j, atol=1e-4, rtol=0)
    for angle in (None, ang_t):
        got = orb.brief_from_patches(patches, angle).numpy()
        want = np.asarray(jorb.brief_from_patches(
            jp, jnp.zeros(len(got)) if angle is None else jnp.asarray(angle.numpy())))
        np.testing.assert_array_equal(got, want.astype(np.int64))
    bits = np.random.default_rng(5).integers(0, 2, (33, 256)).astype(np.int32)
    words = orb.pack_bits(t(bits))
    assert words.dtype == torch.int64
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jorb.pack_bits(jnp.asarray(bits))).astype(np.int64))


def test_dedup_by_bin_matches_jax():
    rng = np.random.default_rng(6)
    n = 300
    xy = rng.uniform(0, 60, (n, 2)).astype(np.float32)
    xy[100:150] = xy[:50] + rng.uniform(-1, 1, (50, 2)).astype(np.float32)  # duplicates
    score = rng.integers(1, 8, n).astype(np.float32)  # many ties
    valid = rng.random(n) > 0.1
    want = np.asarray(jselect.dedup_by_bin(jnp.asarray(xy), jnp.asarray(score),
                                           jnp.asarray(valid), 64, 64, 3.0))
    got = select.dedup_by_bin(t(xy), t(score), t(valid), 64, 64, 3.0).numpy()
    assert 0 < got.sum() < valid.sum()
    np.testing.assert_array_equal(got, want)


def _same_slots(f_t, f_j):
    v = np.asarray(f_j["valid"])
    np.testing.assert_array_equal(f_t["valid"].numpy(), v)
    np.testing.assert_array_equal(f_t["level"].numpy(), np.asarray(f_j["level"]))
    same_xy = np.all(np.abs(f_t["xy"].numpy() - np.asarray(f_j["xy"])) <= 1e-3, axis=1)
    same_desc = np.all(f_t["desc"].numpy() == np.asarray(f_j["desc"]).astype(np.int64),
                       axis=1)
    assert f_t["desc"].dtype == torch.int64 and v.sum() > 100
    assert (same_xy & same_desc)[v].mean() >= 0.99, (same_xy[v].mean(), same_desc[v].mean())


@pytest.mark.parametrize("opts", [dict(upright=True), dict(upright=False, dedup_radius=3.0)])
def test_detect_and_describe_pair_matches_jax(pair, opts):
    il, ir = pair
    with jax_pallas_kernels():
        jl, jr = jorb.detect_and_describe_pair(jnp.asarray(il), jnp.asarray(ir), **KW, **opts)
        tl, tr = orb.detect_and_describe_pair(t(il), t(ir), **KW, **opts)
        _same_slots(tl, jl)
        _same_slots(tr, jr)
        # The single-image entry point gives the pair's left result.
        single = orb.detect_and_describe(t(il), **KW, **opts)
        for k in tl:
            np.testing.assert_array_equal(single[k].numpy(), tl[k].numpy())
