"""K1 (integer-corner window extraction): the port's plain version against the
JAX Pallas kernel in interpret mode, and the wrapper's input checks. The
CUDA kernel itself is tested on the card by ``test_torch_cuda.py``.

Tolerance: exact. The op is a copy; any difference is a wrong index.
Shapes are the main path's at 192x256: level 0 and level 1 of the LK
pyramid padded as ``lk.track`` pads them (S = 24 templates, S = 22 reload
windows) and the unpadded FAST score map (S = 3).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import patch_pallas
from stereo_visual_odometry_tpu_torch.ops import patch

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
