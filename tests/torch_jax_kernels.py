"""Shared by the port's parity tests: run the JAX package with its Pallas
kernels in interpret mode, as the TPU runs them.

On the CPU the JAX package would take its XLA routes instead: the bilinear
sampler ``interp.sample_patches`` for K2, XLA gathers for the subpixel
reads, and ``lk._level_track`` for LK. Inside ``jax_pallas_kernels()``,
``lk.use_pallas_default`` says True, K1 (``extract_windows_int``) runs with
``interpret=True``, K2 (``extract_patches``) with ``use_pallas=True,
interpret=True``, and the LK level kernels K3
(``lk_pallas_cell.level_track_pallas_cell``) and K4
(``lk_pallas.level_track_pallas``) with ``interpret=True``. JAX's caches are
cleared on entry and exit: ``orb.detect_and_describe_pair`` and
``lk.track`` are module-level ``jax.jit``s, and a trace cached by another
test in the same process would keep the XLA route.
"""
import contextlib

import jax
import numpy as np
import pytest

from stereo_visual_odometry_tpu.ops import lk as jlk
from stereo_visual_odometry_tpu.ops import lk_pallas, lk_pallas_cell, patch_pallas


@contextlib.contextmanager
def jax_pallas_kernels():
    windows, patches = patch_pallas.extract_windows_int, patch_pallas.extract_patches
    cell, v1 = lk_pallas_cell.level_track_pallas_cell, lk_pallas.level_track_pallas
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "use_pallas_default", lambda: True)
        mp.setattr(patch_pallas, "extract_windows_int",
                   lambda img, c, S, interpret=False: windows(img, c, S, interpret=True))
        mp.setattr(patch_pallas, "extract_patches",
                   lambda img, c, P, use_pallas=None, interpret=False:
                   patches(img, c, P, use_pallas=True, interpret=True))
        mp.setattr(lk_pallas_cell, "level_track_pallas_cell",
                   lambda *a, interpret=False, **kw: cell(*a, interpret=True, **kw))
        mp.setattr(lk_pallas, "level_track_pallas",
                   lambda *a, interpret=False, **kw: v1(*a, interpret=True, **kw))
        try:
            yield
        finally:
            jax.clear_caches()


def jax_draws(n_steps: int, num_hypotheses: int, seed: int = 0) -> list[np.ndarray]:
    """The RANSAC uniforms each step of the JAX ``System`` draws
    (PRNGKey(seed) -> split for init -> split per step in the frontend,
    ``pnp.py:186``), to inject into the port's steps."""
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    draws = []
    for _ in range(n_steps):
        k, sub = jax.random.split(k)
        draws.append(np.array(jax.random.uniform(sub, (num_hypotheses, 6))))
    return draws


def textured(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Blurred uniform noise in [0, 255): texture everywhere, as the JAX
    package's own ORB tests use (``tests/test_orb_match.py``)."""
    img = rng.random((h + 8, w + 8)) * 255
    k = np.exp(-0.5 * (np.arange(-3, 4) / 1.2) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    return img[4:-4, 4:-4].astype(np.float32)


def with_sensor_noise(images: np.ndarray, seed: int, sigma: float = 1.0) -> np.ndarray:
    """The synthetic renderer's images plus seeded Gaussian noise.

    The renderer leaves ~73% of pixels at exactly 64 or 255. There a BRIEF
    pair difference is 0 up to the last ulp of the scale pyramid's and the
    blur's float32 matmuls, whose rounding differs between XLA's and torch's
    CPU products (one product per tap pair, or a fused one, depending on
    the shape), so its bit has no defined sign and the two packages match
    other features. Noise of 1 grey level gives most pairs a sign far above
    that rounding and stays far below FAST's thresholds (7 and 20: an arc of
    9 pixels 5 sigma off), so it creates no corners. It does not rule out a
    near-tie: at 2 grey levels on the 8-frame sequence of
    ``test_torch_system.py`` one bit flips, one match changes and the pose
    moves 2.1 mm (ROADMAP.md Queue 3).
    """
    rng = np.random.default_rng(seed)
    return (images + rng.normal(0.0, sigma, images.shape)).astype(np.float32)
