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

K5-K8 live in ``scripts/``: ``load_script`` imports the two kernel modules
(K5 ``lk_pallas_block``, K6 ``lk_pallas_v2``), which run nothing at import
and take ``interpret=True``; ``jax_roll`` (K7) and ``jax_lk_breakdown`` (K8)
execute only the function definitions of the probes, whose top level runs
on the TPU, with ``pallas_call`` in interpret mode. No script is edited.
"""
import ast
import contextlib
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stereo_visual_odometry_tpu.ops import lk as jlk
from stereo_visual_odometry_tpu.ops import lk_pallas, lk_pallas_cell, patch_pallas

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


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
    return jax_key_draws(k, n_steps, num_hypotheses)


def jax_key_draws(key, n_steps: int, num_hypotheses: int) -> list[np.ndarray]:
    """The RANSAC uniforms of ``n_steps`` steps of a JAX frontend whose state
    holds ``key``: each step splits it (``models/frontend.py:282``) and
    draws from the sub-key."""
    draws = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(sub, (num_hypotheses, 6))))
    return draws


def jax_batch_draws(n_steps: int, num_hypotheses: int, n_seq: int,
                    seed: int = 0) -> np.ndarray:
    """The (n_seq, n_steps, num_hypotheses, 6) uniforms of a vmapped JAX
    frontend initialised with ``split(PRNGKey(seed), n_seq)``
    (``parallel/evaluate.py:75``): sequence s draws from its own key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_seq)
    return np.stack([np.stack(jax_key_draws(k, n_steps, num_hypotheses)) for k in keys])


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


def load_script(name: str) -> types.ModuleType:
    """Import ``scripts/<name>.py``, a module that runs nothing at import
    (``lk_pallas_block``, ``lk_pallas_v2``), under its own name."""
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def interpret_pallas() -> types.ModuleType:
    """``jax.experimental.pallas`` with ``pallas_call`` in interpret mode."""
    module = types.ModuleType("pallas_interpret")
    module.__dict__.update(vars(pl))
    module.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return module


def script_functions(name: str, functions: dict, namespace: dict) -> dict:
    """Execute only the named top-level function definitions of
    ``scripts/<name>.py`` (whose top level runs a probe on the TPU, so it is
    not imported) in ``namespace``, and return the namespace.

    ``functions`` maps each name to None, or to the name of a function
    nested in it: the outer function's body is then cut after that
    definition and returns it (how a test reaches ``run_variant``'s jitted
    ``once`` without its timing loop)."""
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text())
    defs = [node for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name in functions]
    assert {d.name for d in defs} == set(functions), (name, functions)
    for node in defs:
        inner = functions[node.name]
        if inner is not None:
            cut = next(i for i, s in enumerate(node.body)
                       if isinstance(s, ast.FunctionDef) and s.name == inner)
            node.body = node.body[:cut + 1] + [
                ast.Return(value=ast.Name(id=inner, ctx=ast.Load()))]
    module = ast.fix_missing_locations(ast.Module(body=defs, type_ignores=[]))
    exec(compile(module, str(path), "exec"), namespace)
    return namespace


def jax_roll(rows: int, cols: int, axis: int):
    """K7, ``probe_roll.make(rows, cols, axis)`` in interpret mode: a jitted
    ``run(x, amt)`` with ``amt`` a (1, 1) int32 array."""
    ns = script_functions("probe_roll", {"make": None},
                          dict(jax=jax, jnp=jnp, pl=interpret_pallas(), pltpu=pltpu))
    return ns["make"](rows, cols, axis)


def jax_lk_breakdown(hp: int, wp: int, n: int, win: int = 21, iters: int = 30,
                     eps: float = 0.01, min_eig: float = 1e-4):
    """K8, ``probe_lk_breakdown``'s ``variant_kernel`` through
    ``run_variant``'s own ``pallas_call`` in interpret mode, with the
    probe's module constants set at a small shape (``wp`` >= 256: its
    canvas reads 256 columns). Returns ``run_variant(mode, rounds)``, cut to
    return its jitted ``once(prow, pcol, grow, gcol, prev, next) -> (flow
    (n, 2), ok (n, 1))``."""
    block = load_script("lk_pallas_block")
    ns = dict(jax=jax, jnp=jnp, pl=interpret_pallas(), pltpu=pltpu, B=block, hp=hp,
              wp=wp, N=n, P=-(-(win + 3) // 8) * 8, BLK=block.BLK, win=win,
              iters=iters, eps=eps, min_eig=min_eig)
    script_functions("probe_lk_breakdown",
                     {"variant_kernel": None, "run_variant": "once"}, ns)
    return ns["run_variant"]
