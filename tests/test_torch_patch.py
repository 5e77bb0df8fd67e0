"""K1 (integer-corner window extraction) and K2 (bilinear patches): the port's
plain versions against the JAX Pallas kernels in interpret mode, and the
wrappers' input checks. The CUDA kernels themselves are tested on the card
by ``test_torch_cuda.py``.

K1 tolerance: exact. The op is a copy; any difference is a wrong index.
Shapes are the main path's at 192x256: level 0 and level 1 of the LK
pyramid padded as ``lk.track`` pads them (S = 24 templates, S = 22 reload
windows) and the unpadded FAST score map (S = 3).

K2 tolerances: exact against the interpret-mode kernel (the plain version
fuses the blend's products into the running sum as XLA does there, with an
exact float32 fma emulated in float64, ``patch.fma_f32``), and
0.01 against the JAX CPU route ``interp.sample_patches`` (per-tap
fractions, as ``tests/test_patch_pallas.py`` allows) where the two define
the same patch. Shapes are
ORB's at 128x320: P = 39 on level 0 and level 3 of the scale pyramid, and
P = 31 (``ic_angle``). The CUDA kernel reads the unpadded image with clamped
taps; its index arithmetic (``patch.extract_patches_clamped``, also the CPU
route) equals K2 on the edge-padded image bit for bit, for odd and even
extents and centres inside, on the border and up to 2 px outside.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import interp as jinterp
from stereo_visual_odometry_tpu.ops import patch_pallas
from stereo_visual_odometry_tpu_torch.ops import interp, patch

CASES = [  # (Hp, Wp, S)
    (216, 384, 24), (216, 384, 22),   # level 0 of 192x256, padded 12 + align
    (120, 256, 24), (120, 256, 22),   # level 1
    (192, 256, 3),                    # FAST score map, 3x3 neighbourhoods
]


def _inputs(hp, wp, S, n=64, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((hp, wp)) * 255).astype(np.float32)
    corners = np.stack([rng.integers(0, hp - S + 1, n),
                        rng.integers(0, wp - S + 1, n)], -1).astype(np.int32)
    corners[:4] = [[0, 0], [hp - S, wp - S], [0, wp - S], [hp - S, 0]]
    return img, corners


@pytest.mark.parametrize("hp,wp,S", CASES)
def test_reference_matches_pallas_interpret(hp, wp, S):
    img, corners = _inputs(hp, wp, S)
    want = np.asarray(patch_pallas.extract_windows_int(
        jnp.asarray(img), jnp.asarray(corners), S, interpret=True))
    got = patch.extract_windows_int(torch.from_numpy(img), torch.from_numpy(corners), S)
    assert got.shape == (len(corners), S, S) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_clamps_out_of_range_corners():
    img, _ = _inputs(40, 50, 5)
    corners = torch.tensor([[-3, -7], [100, 100], [36, 46]], dtype=torch.int32)
    out = patch.extract_windows_int_reference(torch.from_numpy(img), corners, 5)
    t = torch.from_numpy(img)
    torch.testing.assert_close(out[0], t[:5, :5], rtol=0, atol=0)
    torch.testing.assert_close(out[1], t[35:, 45:], rtol=0, atol=0)
    torch.testing.assert_close(out[2], t[35:, 45:], rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "corner_dtype", "corner_shape",
                                 "noncontig", "too_big"])
def test_wrapper_rejects_bad_inputs(bad):
    img = torch.zeros(32, 40)
    corners = torch.zeros(8, 2, dtype=torch.int32)
    S = 4
    if bad == "dtype":
        img = img.double()
    elif bad == "corner_dtype":
        corners = corners.long()
    elif bad == "corner_shape":
        corners = torch.zeros(8, 3, dtype=torch.int32)
    elif bad == "noncontig":
        img = torch.zeros(40, 32).t()
    elif bad == "too_big":
        S = 33
    with pytest.raises(ValueError):
        patch.extract_windows_int(img, corners, S)


def test_cpu_call_does_not_count_as_launch():
    before = patch.extract_windows_int.launches
    img, corners = _inputs(64, 64, 8, n=8)
    patch.extract_windows_int(torch.from_numpy(img), torch.from_numpy(corners), 8)
    assert patch.extract_windows_int.launches == before


def _centres(h, w, n=64, seed=0):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], -1)
    xy[:4] = [[0, 0], [w - 1, h - 1], [w - 1, 0], [0.5, h - 1.5]]  # corners
    return xy.astype(np.float32)


@pytest.mark.parametrize("h,w,P", [(128, 320, 39), (74, 185, 39), (128, 320, 31)])
def test_k2_reference_matches_pallas_interpret(h, w, P):
    img = (np.random.default_rng(P).random((h, w)) * 255).astype(np.float32)
    xy = _centres(h, w)
    want = np.asarray(patch_pallas.extract_patches(jnp.asarray(img), jnp.asarray(xy), P,
                                                   use_pallas=True, interpret=True))
    got = patch.extract_patches(torch.from_numpy(img), torch.from_numpy(xy), P)
    assert got.shape == (len(xy), P, P) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # The sampler clamps each tap, the kernel reads an edge-padded image: the
    # two agree where the patch lies inside the image, and at integer
    # centres (fy = fx = 0) anywhere.
    r = (P - 1) // 2 + 1
    inside = ((xy[:, 0] >= r) & (xy[:, 0] <= w - 1 - r) &
              (xy[:, 1] >= r) & (xy[:, 1] <= h - 1 - r))
    cmp = np.concatenate([xy[inside], np.round(xy[~inside])]).astype(np.float32)
    assert inside.sum() >= 8
    got = patch.extract_patches(torch.from_numpy(img), torch.from_numpy(cmp), P).numpy()
    xla = np.asarray(jinterp.sample_patches(jnp.asarray(img), jnp.asarray(cmp), P))
    np.testing.assert_allclose(got, xla, atol=0.01, rtol=0)
    port_sampler = interp.sample_patches(torch.from_numpy(img), torch.from_numpy(cmp), P)
    np.testing.assert_allclose(got, port_sampler.numpy(), atol=0.01, rtol=0)


def test_fma_f32_rounds_once():
    """Against exact rational arithmetic, on random float32 triples and on
    sums that float64 cannot hold (a tiny product beside a large addend),
    where rounding twice would be wrong."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    p = (rng.random(4000) * 255).astype(np.float32)
    q = rng.random(4000).astype(np.float32)
    acc = (rng.random(4000) * 255).astype(np.float32)
    q[:2000] *= np.float32(2.0 ** -30)
    got = patch.fma_f32(torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(acc))
    for i in range(0, 4000, 7):
        exact = Fraction(float(p[i])) * Fraction(float(q[i])) + Fraction(float(acc[i]))
        lo = np.float32(float(exact))  # the nearest double, then a float32 neighbour
        cands = {np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))}
        best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                         int(np.float32(c).view(np.int32)) & 1))
        assert got[i].item() == best, (i, p[i], q[i], acc[i])


def test_k2_reference_on_padded_image_and_clip():
    img = torch.arange(12 * 15, dtype=torch.float32).reshape(12, 15)
    pad = patch.pad_edge(img, 4, 4, 4, 4)
    assert pad.shape == (20, 23)
    torch.testing.assert_close(pad[4:-4, 4:-4], img, rtol=0, atol=0)
    torch.testing.assert_close(pad[0, :5], torch.full((5,), 0.0), rtol=0, atol=0)
    # A centre on the pixel grid reads the window itself (fy = fx = 0).
    out = patch.extract_patches_reference(pad, torch.tensor([[7.0, 5.0]]), 5, 4)
    torch.testing.assert_close(out[0], img[3:8, 5:10], rtol=0, atol=0)
    # Far outside: the integer corner clips to [0, Hp-P-1] x [0, Wp-P-1].
    far = patch.extract_patches_reference(pad, torch.tensor([[-40.0, 90.0]]), 5, 4)
    assert torch.isfinite(far).all()


def _centres_at(where, h, w, n=48, seed=0):
    """Centres inside the image, on its border lines and up to 2 px outside
    it, on all four sides."""
    rng = np.random.default_rng(seed)
    if where == "inside":
        xy = np.stack([rng.uniform(21, w - 22, n), rng.uniform(21, h - 22, n)], -1)
    elif where == "edge":
        t = rng.uniform(0, 1, n)
        side = np.arange(n) % 4
        xy = np.stack([np.where(side == 0, 0.0, np.where(side == 1, w - 1.0, t * (w - 1))),
                       np.where(side == 2, 0.0, np.where(side == 3, h - 1.0, t * (h - 1)))],
                      -1)
        xy[:4] = [[0.3, 0.0], [w - 1.3, h - 1.0], [0.0, h - 1.7], [w - 1.0, 0.5]]
    else:  # up to 2 px outside: x in [-2, 0) or (w-1, w+1], y likewise
        lo, hi = rng.uniform(-2, 0, (n, 2)), rng.uniform(0, 2, (n, 2)) + [w - 1, h - 1]
        xy = np.where(np.arange(n)[:, None] % 2 == 0, lo, hi)
        xy[1::4, 0] = rng.uniform(0, w - 1, len(xy[1::4]))  # outside on one axis only
        xy[:4] = [[-2.0, -2.0], [w + 1.0, h + 1.0], [-2.0, h + 1.0], [w + 1.0, -2.0]]
    return torch.from_numpy(xy.astype(np.float32))


@pytest.mark.parametrize("where", ["inside", "edge", "outside"])
@pytest.mark.parametrize("h,w", [(64, 96), (65, 97), (64, 97), (65, 96)])
@pytest.mark.parametrize("P", [31, 39])
def test_k2_clamped_taps_match_padded_reference(P, h, w, where):
    """The kernel's index arithmetic (clamped taps on the unpadded image, as
    ``csrc/extract_patches.cu`` reads it) against K2 on the edge-padded image:
    bit for bit, also through the wrapper's CPU route."""
    img = torch.from_numpy((np.random.default_rng(h * w + P).random((h, w)) * 255)
                           .astype(np.float32))
    xy = _centres_at(where, h, w, seed=P)
    pad = P // 2 + 2
    want = patch.extract_patches_reference(patch.pad_edge(img, pad, pad, pad, pad), xy, P,
                                           pad)
    got = patch.extract_patches_clamped(img, xy, P)
    assert got.shape == (len(xy), P, P)
    assert torch.equal(got, want)
    assert torch.equal(patch.extract_patches(img, xy, P), want)


@pytest.mark.parametrize("bad", ["dtype", "centre_dtype", "centre_shape", "ndim",
                                 "mixed_devices", "meta_device", "too_big"])
def test_k2_wrapper_rejects_bad_inputs(bad):
    img = torch.zeros(32, 40)
    xy = torch.zeros(8, 2)
    P = 5
    if bad == "dtype":
        img = img.double()
    elif bad == "centre_dtype":
        xy = xy.double()
    elif bad == "centre_shape":
        xy = torch.zeros(8, 3)
    elif bad == "ndim":
        img = torch.zeros(2, 32, 40)
    elif bad == "mixed_devices":
        img = img.to("meta")
    elif bad == "meta_device":  # neither the CPU nor a card: no route
        img, xy = img.to("meta"), xy.to("meta")
    elif bad == "too_big":  # above the JAX kernel's limit, though it fits the image
        img, P = torch.zeros(300, 300), patch.MAX_PATCH + 1
    with pytest.raises(ValueError, match="limit" if bad == "too_big" else None):
        patch.extract_patches(img, xy, P)


def test_k2_cpu_call_does_not_count_as_launch():
    before = patch.extract_patches.launches
    out = patch.extract_patches(torch.rand(40, 50), torch.zeros(0, 2), 39)
    assert out.shape == (0, 39, 39) and patch.extract_patches.launches == before


def test_patch_timing_probe_needs_a_gpu():
    """The timing probe measures on a card only: without one it raises
    before importing any package (no CPU numbers under device names)."""
    from stereo_visual_odometry_tpu_torch.probes import patch_timing
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        patch_timing.main([])


def test_lk_timing_probe_needs_a_gpu():
    """So does the LK kernels' timing probe."""
    from stereo_visual_odometry_tpu_torch.probes import lk_timing
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lk_timing.main([])
