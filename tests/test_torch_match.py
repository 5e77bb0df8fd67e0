"""Port Hamming matching (``ops/match.py``) against the JAX package.

Everything here is integer or boolean, so every comparison is exact: the
popcount, the (N, M) distance matrix, the per-row argmin (first minimal
index on ties, planted on purpose), the cross-check, the adaptive distance
gate and the two associations of the ORB pipeline given the same features.
Descriptors are the JAX uint32 words; the port holds the same bit patterns
in int64 (``utils/bridge.feat_from_jax``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import match as jmatch
from stereo_visual_odometry_tpu_torch.ops import match
from stereo_visual_odometry_tpu_torch.utils import bridge


def _words(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def _t(desc):
    return torch.from_numpy(desc.astype(np.int64))


def test_popcount_matches_python_and_jax():
    x = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x0F0F0F0F, 0x12345678, 0xDEADBEEF],
                 dtype=np.uint32)
    got = match.popcount_u32(_t(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(got, np.asarray(jmatch.popcount_u32(jnp.asarray(x))))


def test_hamming_matrix_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _words(rng, 37), _words(rng, 53)
    b[:5] = a[:5]  # distance 0
    b[5] = a[6] ^ np.uint32(1)  # distance 1
    va, vb = rng.random(37) > 0.2, rng.random(53) > 0.2
    for valid in ((None, None), (va, vb)):
        want = np.asarray(jmatch.hamming_matrix(
            jnp.asarray(a), jnp.asarray(b),
            *(None if v is None else jnp.asarray(v) for v in valid)))
        got = match.hamming_matrix(_t(a), _t(b),
                                   *(None if v is None else torch.from_numpy(v)
                                     for v in valid))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_argmin_ties_take_the_first_index():
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 6, size=(40, 30)).astype(np.int32)  # dense ties
    dist[3] = 7
    dist[3, [4, 9, 20]] = 1  # planted: three equal minima
    idx, best = match.match_best(torch.from_numpy(dist))
    assert idx[3] == 4 and best[3] == 1
    j_idx, j_best = jmatch.match_best(jnp.asarray(dist))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(best.numpy(), np.asarray(j_best))
    np.testing.assert_array_equal(
        match.mutual_mask(torch.from_numpy(dist), idx).numpy(),
        np.asarray(jmatch.mutual_mask(jnp.asarray(dist), j_idx)))


@pytest.mark.parametrize("floor,ratio", [(30.0, 2.0), (50.0, 2.0), (5.0, 3.0)])
def test_reference_distance_gate_matches_jax(floor, ratio):
    rng = np.random.default_rng(3)
    best = rng.integers(0, 120, 64).astype(np.int32)
    valid = rng.random(64) > 0.3
    got = match.reference_distance_gate(torch.from_numpy(best), torch.from_numpy(valid),
                                        floor, ratio)
    want = jmatch.reference_distance_gate(jnp.asarray(best), jnp.asarray(valid),
                                          floor, ratio)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _features(rng, n, base=None, shift=(0.0, 0.0), flip_bits=4):
    """A JAX-schema feature dict; with ``base``, its descriptors are base's
    with a few bits flipped and its points shifted (plausible matches)."""
    if base is None:
        xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
        desc = _words(rng, n)
        level = rng.integers(0, 4, n).astype(np.int32)
    else:
        xy = (base["xy"] + np.asarray(shift, np.float32)
              + rng.normal(0, 0.4, base["xy"].shape)).astype(np.float32)
        desc = base["desc"].copy()
        for _ in range(flip_bits):
            desc[np.arange(n), rng.integers(0, 8, n)] ^= (
                np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32))
        level = np.clip(base["level"] + rng.integers(-1, 2, n), 0, 3).astype(np.int32)
        perm = rng.permutation(n)
        xy, desc, level = xy[perm], desc[perm], level[perm]
    return {"xy": xy, "desc": desc, "angle": np.zeros(n, np.float32),
            "score": rng.uniform(7, 60, n).astype(np.float32), "level": level,
            "valid": rng.random(n) > 0.1}


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(4)
    t1l = _features(rng, 160)
    t1r = _features(rng, 160, base=t1l, shift=(-12.0, 0.0))
    t2l = _features(rng, 160, base=t1l, shift=(3.0, 1.0), flip_bits=10)
    return t1l, t1r, t2l


OPTS = [dict(), dict(max_level_diff=1, stereo_premask=True, temporal_radius=150.0),
        dict(use_mutual=True, max_level_diff=0, dist_floor=50.0),
        dict(stereo_premask=True, max_disparity=8.0, temporal_radius=2.0)]


@pytest.mark.parametrize("opts", OPTS)
def test_stereo_temporal_match_matches_jax(feats, opts):
    jf = [{k: jnp.asarray(v) for k, v in f.items()} for f in feats]
    tf = [bridge.feat_from_jax(f) for f in feats]
    want = jmatch.stereo_temporal_match(*jf, **opts)
    got = match.stereo_temporal_match(*tf, **opts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if not opts:
        assert 0 < got["valid"].sum() < len(feats[0]["xy"])


@pytest.mark.parametrize("opts", OPTS[:2])
def test_stereo_match_matches_jax(feats, opts):
    opts = {k: v for k, v in opts.items() if k not in ("temporal_radius", "use_mutual")}
    want = jmatch.stereo_match(*({k: jnp.asarray(v) for k, v in f.items()}
                                 for f in feats[:2]), **opts)
    got = match.stereo_match(*(bridge.feat_from_jax(f) for f in feats[:2]), **opts)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["valid"].sum() > 0
