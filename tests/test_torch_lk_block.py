"""Port parity: K5 (``lk_block.level_track_block``), K6
(``lk_v2.level_track_v2``) and K8 (``lk_block.level_track_block_split``)
against the JAX kernels in ``scripts/``, and the routes and probes of the
port's block LK modules: the wrappers' contracts (K5's and K6's finished
flow and ok, K8's four variants), and the shared memory per CTA the
wrappers ask for, which is the layout of ``csrc/lk_block.cu``'s kernel.

The JAX side runs in Pallas interpret mode: K5 and K6 through
``level_track_pallas_block`` / ``level_track_pallas_v2(..., interpret=True)``
(their modules run nothing at import), K8 through the probe's own
``variant_kernel`` and ``pallas_call``, loaded from
``scripts/probe_lk_breakdown.py`` without running its top level
(``torch_jax_kernels.jax_lk_breakdown``). The port runs the plain versions
(CPU tensors). Inputs, the same arrays on both sides: blurred noise on one
(64, 256) level (the JAX kernels need Hp % 8 = 0, Wp % 128 = 0 and, for K8's
canvas, Wp >= 256), the next level moved by (2, -1) px, N = 16 points
(N % 8 = 0 for JAX), seeded numpy guesses and masks.

Tolerances: K5/K6 flows within 1e-4 px where both keep a point and ok masks
equal (the plain versions are K3's and K4's, which the JAX block kernels
match up to summation order: ~1e-5 px here). K8: each output within 1e-4 of
its largest value (the checksums are sums of ~441 products of ~1e2-1e3
values, ~1e5 in all, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.ops import lk_block, lk_cell, lk_v1, lk_v2
from stereo_visual_odometry_tpu_torch.probes import lk_block as probe_block
from stereo_visual_odometry_tpu_torch.probes import lk_breakdown as probe_breakdown
from torch_jax_kernels import jax_lk_breakdown, load_script, textured

HP, WP, N, PAD = 64, 256, 16, 12
FLOW_ATOL = 1e-4
REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(11)
    prev = textured(rng, HP, WP)
    nxt = np.roll(prev, (-1, 2), axis=(0, 1))
    pts = (rng.random((N, 2)) * [WP - 2 * PAD - 1, HP - 2 * PAD - 1]).astype(np.float32)
    guess = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
    active = rng.random(N) > 0.3
    active[:2] = [True, False]
    return prev, nxt, pts, guess, active


def assert_flows_agree(ft, okt, fj, okj):
    ft, okt = ft.numpy(), okt.numpy()
    fj, okj = np.asarray(fj), np.asarray(okj)
    np.testing.assert_array_equal(okt, okj)
    assert okt.sum() >= N // 2, okt.sum()
    np.testing.assert_allclose(ft[okt], fj[okt], atol=FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("with_guess", [False, True])
@pytest.mark.parametrize("with_active", [False, True])
def test_block_plain_matches_jax_kernel(level, with_active, with_guess):
    """K5's plain version against ``level_track_pallas_block`` in interpret
    mode, whose ``active`` mask applies after the kernel."""
    prev, nxt, pts, guess, active = level
    guess = guess if with_guess else np.zeros_like(guess)
    kw = dict(win=21, iters=30, eps=0.01, search_radius=6, pad=PAD)
    jax_block = load_script("lk_pallas_block")
    fj, okj = jax_block.level_track_pallas_block(
        jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts), jnp.asarray(guess),
        interpret=True, active=jnp.asarray(active) if with_active else None, **kw)
    stats = {}
    ft, okt = lk_block.level_track_block(
        torch.from_numpy(prev), torch.from_numpy(nxt), torch.from_numpy(pts),
        torch.from_numpy(guess), active=torch.from_numpy(active) if with_active else None,
        stats=stats, **kw)
    assert_flows_agree(ft, okt, fj, okj)
    if with_active:
        # Inactive points: flow = guess, not ok, no iterations (K3's contract).
        np.testing.assert_array_equal(ft.numpy()[~active], guess[~active])
        np.testing.assert_array_equal(np.asarray(fj)[~active], guess[~active])
        assert (stats["iters"].numpy()[~active] == 0).all()


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("radius", [1, 6])
def test_block_contract_matches_jax_kernel(level, radius, with_stats):
    """K5's wrapper contract on the CPU route, K3's: a bool ``active``, the
    ``search_radius`` test on the found delta, ``stats`` only when asked;
    held to ``level_track_pallas_block`` in interpret mode with the same
    mask and radius. At radius 1 the gate drops points that radius 6
    keeps."""
    prev, nxt, pts, guess, active = level
    kw = dict(win=21, iters=30, eps=0.01, search_radius=radius, pad=PAD)
    jax_block = load_script("lk_pallas_block")
    fj, okj = jax_block.level_track_pallas_block(
        jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts), jnp.asarray(guess),
        interpret=True, active=jnp.asarray(active), **kw)
    stats = {} if with_stats else None
    ft, okt = lk_block.level_track_block(
        torch.from_numpy(prev), torch.from_numpy(nxt), torch.from_numpy(pts),
        torch.from_numpy(guess), active=torch.from_numpy(active), stats=stats, **kw)
    assert okt.dtype == torch.bool and ft.dtype == torch.float32
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    kept = okt.numpy()
    np.testing.assert_allclose(ft.numpy()[kept], np.asarray(fj)[kept], atol=FLOW_ATOL, rtol=0)
    np.testing.assert_array_equal(ft.numpy()[~active], guess[~active])
    delta = np.abs(ft.numpy() - guess).max(-1)
    assert not kept[delta > radius].any()
    if radius == 1:
        assert (delta[active] > 1).any()  # the gate has points to drop
    if with_stats:
        assert set(stats) >= {"iters", "reloads"}
        assert stats["iters"].shape == (N,) and stats["iters"].dtype == torch.int32
        assert (stats["iters"].numpy()[~active] == 0).all()


@pytest.mark.parametrize("with_guess", [False, True])
def test_v2_plain_matches_jax_kernel(level, with_guess):
    """K6's plain version against ``level_track_pallas_v2`` in interpret
    mode (no ``active``: every point is tracked)."""
    prev, nxt, pts, guess, _ = level
    guess = guess if with_guess else np.zeros_like(guess)
    kw = dict(win=21, iters=30, eps=0.01, search_radius=6, pad=PAD)
    jax_v2 = load_script("lk_pallas_v2")
    fj, okj = jax_v2.level_track_pallas_v2(
        jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts), jnp.asarray(guess),
        interpret=True, **kw)
    stats = {}
    ft, okt = lk_v2.level_track_v2(torch.from_numpy(prev), torch.from_numpy(nxt),
                                   torch.from_numpy(pts), torch.from_numpy(guess),
                                   stats=stats, **kw)
    assert_flows_agree(ft, okt, fj, okj)
    np.testing.assert_array_equal(stats["reloads"].numpy(), stats["iters"].numpy())


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("radius", [1, 6])
def test_v2_contract_matches_jax_kernel(level, radius, with_stats):
    """K6's wrapper contract on the CPU route, K4's without a mask: flow =
    guess + delta, the ``search_radius`` test on the found delta, ``stats``
    only when asked with reloads = iterations; held to the tail of
    ``level_track_pallas_v2`` in interpret mode at the same radius. At radius
    1 the gate drops points that radius 6 keeps."""
    prev, nxt, pts, guess, _ = level
    kw = dict(win=21, iters=30, eps=0.01, search_radius=radius, pad=PAD)
    jax_v2 = load_script("lk_pallas_v2")
    fj, okj = jax_v2.level_track_pallas_v2(
        jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts), jnp.asarray(guess),
        interpret=True, **kw)
    stats = {} if with_stats else None
    ft, okt = lk_v2.level_track_v2(torch.from_numpy(prev), torch.from_numpy(nxt),
                                   torch.from_numpy(pts), torch.from_numpy(guess),
                                   stats=stats, **kw)
    assert okt.dtype == torch.bool and ft.dtype == torch.float32
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    kept = okt.numpy()
    np.testing.assert_allclose(ft.numpy()[kept], np.asarray(fj)[kept], atol=FLOW_ATOL, rtol=0)
    delta = np.abs(ft.numpy() - guess).max(-1)
    assert not kept[delta > radius].any()
    if radius == 1:
        assert (delta > 1).any() and kept.any()  # the gate drops some points, not all
    if with_stats:
        assert stats["iters"].shape == (N,) and stats["iters"].dtype == torch.int32
        np.testing.assert_array_equal(stats["reloads"].numpy(), stats["iters"].numpy())
        assert 1 <= stats["iters"].max() <= 30


def _slice_floats(win, keeps_template):
    """One point's slice of csrc/lk_block.cu's kernel, written out: the
    gradients (2 win^2), K6's template (win^2), the (win+3)^2 buffer, the
    (win+15)^2 region (margin 7) and the (win+2)^2 field, even."""
    floats = ((3 if keeps_template else 2) * win * win + (win + 3) ** 2 + (win + 15) ** 2
              + (win + 2) ** 2)
    return floats + floats % 2


@pytest.mark.parametrize("win", [5, 21, 31, 75])
def test_smem_helpers_give_the_kernel_layouts(win):
    """The wrappers' shared memory per CTA is the kernel's layout: K5/K8's
    slice, and K6's, which also holds T (win^2 more floats), 2 points each;
    at win 21 both stay below 48 KB, from win 31 both take the opt-in above
    it, which ``lk_v1.check_launch`` lets through up to the card's 227 KB
    (win 75 is above it)."""
    cell, it = lk_block.cell_smem_bytes(win), lk_block.iter_smem_bytes(win)
    assert cell == 4 * lk_block.CELL_POINTS_PER_CTA * _slice_floats(win, False)
    assert it == 4 * lk_block.ITER_POINTS_PER_CTA * _slice_floats(win, True)
    assert lk_block.STAGE_MARGIN == lk_v1.STAGE_MARGIN == 7
    if win == 21:
        assert (cell, it) == (26272, 29792)
    cuda = torch.device("cuda")  # a device type: no card is touched
    for smem in (cell, it):
        assert (smem > 48 * 1024) == (win >= 31)
        if smem <= lk_v1._SMEM_LIMIT:
            lk_v1.check_launch(cuda, win, smem)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                lk_v1.check_launch(cuda, win, smem)
    assert (it > lk_v1._SMEM_LIMIT) == (win == 75)


@pytest.mark.parametrize("label", list(probe_breakdown.VARIANTS))
def test_split_wrapper_gives_the_plain_outputs(level, label):
    """K8's CPU route is its plain version for every variant, bit for bit,
    with the JAX variant's outputs: ``full`` is K5's plain version from zero
    guesses with the raw delta and the gate as 0/1; ``tmpl``/``reload`` give
    the checksums flow = (acc [+ the last round's first dot], acc), ok =
    acc, and each round's 8 dots."""
    prev, nxt, pts, _, _ = level
    mode, rounds = probe_breakdown.VARIANTS[label]
    args = [torch.from_numpy(a) for a in (prev, nxt, pts)]
    before = lk_block.level_track_block_split.launches
    flow, ok, dots = lk_block.level_track_block_split(*args, PAD, mode, rounds)
    assert lk_block.level_track_block_split.launches == before
    for g, w in zip((flow, ok, dots),
                    lk_block.level_track_block_split_reference(*args, PAD, mode, rounds)):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dots.shape == (N, rounds if mode == "reload" else 0, 8)
    if mode == "full":
        f5, ok5 = lk_block.level_track_block_reference(*args, torch.zeros(N, 2), pad=PAD,
                                                       search_radius=float("inf"))
        assert torch.equal(flow, f5) and torch.equal(ok, ok5.float())
        assert set(ok.unique().tolist()) <= {0.0, 1.0}
    else:
        assert torch.equal(flow[:, 1], ok)
        extra = dots[:, -1, 0] if mode == "reload" else torch.zeros(N)
        assert torch.equal(flow[:, 0], ok + extra)


def rel_err(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("label", list(probe_breakdown.VARIANTS))
def test_split_plain_matches_jax_variant(level, label):
    """K8's plain version against ``probe_lk_breakdown.variant_kernel`` in
    interpret mode: the checksums (and, for ``full``, K5's raw delta and
    gate) within 1e-4 relative."""
    prev, nxt, pts, _, _ = level
    mode, rounds = probe_breakdown.VARIANTS[label]
    once = jax_lk_breakdown(HP, WP, N)(mode, rounds)
    zeros = jnp.zeros((N, 1), jnp.float32)
    fj, okj = once(jnp.asarray(pts[:, 1:2] + PAD), jnp.asarray(pts[:, 0:1] + PAD), zeros,
                   zeros, jnp.asarray(prev), jnp.asarray(nxt))
    ft, okt, dots = lk_block.level_track_block_split(
        torch.from_numpy(prev), torch.from_numpy(nxt), torch.from_numpy(pts), PAD, mode,
        rounds)
    assert ft.shape == (N, 2) and okt.shape == (N,)
    assert dots.shape == (N, rounds if mode == "reload" else 0, 8)
    assert rel_err(ft.numpy(), fj) <= REL_TOL
    assert rel_err(okt.numpy(), np.asarray(okj)[:, 0]) <= REL_TOL
    if mode == "reload":  # the last round's first dot rides on flow[:, 0]
        np.testing.assert_allclose(ft[:, 0] - ft[:, 1], dots[:, -1, 0],
                                   rtol=0, atol=REL_TOL * float(ft.abs().max()))


def _call(kernel, args, **kw):
    prev, nxt, pts, guess = args
    if kernel == "block":
        return lk_block.level_track_block(prev, nxt, pts, guess, pad=PAD, **kw)
    if kernel == "v2":
        return lk_v2.level_track_v2(prev, nxt, pts, guess, pad=PAD, **kw)
    return lk_block.level_track_block_split(prev, nxt, pts, PAD, "reload", 2)


PLAIN = {"block": (lk_block.level_track_block, lk_block.level_track_block_reference),
         "v2": (lk_v2.level_track_v2, lk_v2.level_track_v2_reference),
         "split": (lk_block.level_track_block_split,
                   lk_block.level_track_block_split_reference)}


@pytest.mark.parametrize("kernel", list(PLAIN))
def test_wrapper_routes_cpu_tensors_to_plain_version(level, kernel):
    prev, nxt, pts, guess, _ = level
    args = [torch.from_numpy(a) for a in (prev, nxt, pts, guess)]
    wrapper, plain = PLAIN[kernel]
    before = wrapper.launches
    got = _call(kernel, args)
    assert wrapper.launches == before
    want = (plain(*args[:3], PAD, "reload", 2) if kernel == "split"
            else plain(*args, pad=PAD))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["cell", "v1", "block", "v2", "split"])
def test_no_points_give_empty_outputs(level, kernel):
    """N = 0 through the plain route of K3-K6 and K8: empty outputs of the
    wrappers' shapes and dtypes, empty statistics, no launch counted."""
    prev, nxt, _, _, _ = level
    img_p, img_n, none = torch.from_numpy(prev), torch.from_numpy(nxt), torch.zeros(0, 2)
    if kernel == "split":
        before = lk_block.level_track_block_split.launches
        flow, ok, dots = lk_block.level_track_block_split(img_p, img_n, none, PAD, "reload", 2)
        assert lk_block.level_track_block_split.launches == before
        assert (flow.shape, ok.shape, dots.shape) == ((0, 2), (0,), (0, 2, 8))
        assert flow.dtype == ok.dtype == dots.dtype == torch.float32
        return
    fn = {"cell": lk_cell.level_track_cell, "v1": lk_v1.level_track_v1,
          "block": lk_block.level_track_block, "v2": lk_v2.level_track_v2}[kernel]
    before, stats = fn.launches, {}
    flow, ok = fn(img_p, img_n, none, none, pad=PAD, stats=stats)
    assert fn.launches == before
    assert flow.shape == (0, 2) and flow.dtype == torch.float32
    assert ok.shape == (0,) and ok.dtype == torch.bool
    for key in ("iters", "reloads"):
        assert stats[key].shape == (0,) and stats[key].dtype == torch.int32


@pytest.mark.parametrize("kernel", list(PLAIN))
def test_wrapper_rejects_a_device_with_no_route(level, kernel):
    """Neither the CPU nor a card: no plain fallback, the wrapper raises."""
    prev, nxt, pts, guess, _ = level
    args = [torch.from_numpy(a).to("meta") for a in (prev, nxt, pts, guess)]
    with pytest.raises(ValueError, match="unsupported device"):
        _call(kernel, args)


def test_split_checks_its_variant():
    img, pts = torch.zeros(64, 256), torch.zeros(8, 2)
    with pytest.raises(ValueError, match="mode"):
        lk_block.level_track_block_split(img, img, pts, PAD, "iterations")
    with pytest.raises(ValueError, match="rounds"):
        lk_block.level_track_block_split(img, img, pts, PAD, "reload", 0)
    with pytest.raises(ValueError, match="float32"):
        lk_block.level_track_block_split(img.double(), img, pts, PAD, "tmpl")


PROBES = {"lk_block": probe_block, "lk_breakdown": probe_breakdown}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_runs_on_the_cpu(name, capsys):
    assert PROBES[name].main(["--device", "cpu", "--height", "64", "--width", "256",
                              "--points", "8"]) == 0
    out = capsys.readouterr().out
    if name == "lk_block":
        assert out.count("[parity]") == 2 and "max|flow diff| 0.00e+00" in out
    else:
        assert out.count("rel err vs plain 0.00e+00") == 4 and "[split]" in out


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_needs_a_gpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROBES[name].main([])
