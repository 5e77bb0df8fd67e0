"""Port parity: the LK level kernels K3 (``lk_cell``) and K4 (``lk_v1``), the
XLA level tracker ``lk._level_track``, ``lk.track`` on each of the three,
and the disparity-grid prior, against the JAX package.

The JAX side runs K3 and K4 in Pallas interpret mode (as its own
``tests/test_lk_pallas.py`` does; ``torch_jax_kernels.jax_pallas_kernels``
inside ``lk.track``) and ``_level_track`` and the grid as pure XLA; the
port runs the plain versions (CPU tensors). Inputs: the port's
synthetic frames (seeded, 192x256), pyramids built by the JAX package,
FAST/top-K keypoints, and seeded numpy guesses and masks; both sides get
the same arrays. Levels 0 and 1 are padded as ``lk.track`` pads them for
the kernels ((216, 384) and (120, 256): the JAX kernels' 256-column block
path).

Tolerances, as ``test_torch_lk.py`` holds the dense tracker: flows within
1e-3 px where both sides keep a point, ok masks agreeing on >= 99% of
points. The plain versions sum in another order than the JAX kernels, so a
point whose step sits near eps can stop one iteration earlier or later; its
flow then moves by less than eps (one step), and the test allows eps for at
most 2% of the points. The grid: within 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import fast as jfast
from stereo_visual_odometry_tpu.ops import lk as jlk
from stereo_visual_odometry_tpu.ops import lk_pallas, lk_pallas_cell
from stereo_visual_odometry_tpu.ops import pyramid as jpyr
from stereo_visual_odometry_tpu.ops import select as jsel
from stereo_visual_odometry_tpu_torch.ops import lk as tlk
from stereo_visual_odometry_tpu_torch.ops import lk_cell, lk_v1
from stereo_visual_odometry_tpu_torch.utils import synthetic
from torch_jax_kernels import jax_pallas_kernels

H, W, FX = 192, 256, 300.0
FLOW_ATOL = 1e-3
OK_AGREE = 0.99
NEAR_EPS_SHARE = 0.02


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    seq = synthetic.render_sequence(n_frames=2, h=H, w=W, fx=FX, speed=1.0, seed=2)
    pyr = {name: [np.array(p) for p in jpyr.build_pyramid(jnp.asarray(img), 4)]
           for name, img in (("t1l", seq["images_l"][0]), ("t2l", seq["images_l"][1]))}
    score = jfast.detect(jnp.asarray(seq["images_l"][0]), 20.0)
    xy, _, valid = jsel.grid_top_k(score, 256, cell=32, k_per_cell=8)
    xy = jsel.subpixel_refine(score, xy, valid, use_pallas=False)
    return pyr, np.array(xy), np.array(valid)


def to_t(levels):
    return tuple(torch.from_numpy(a) for a in levels)


def to_j(levels):
    return tuple(jnp.asarray(a) for a in levels)


def pad_level(img, win=21):
    pad = (win - 1) // 2 + 2
    eh = (-(img.shape[0] + 2 * pad)) % 8
    ew = (-(img.shape[1] + 2 * pad)) % 128
    return np.pad(img, ((pad, pad + eh), (pad, pad + ew)), mode="edge"), pad


def assert_level_agrees(ft, okt, fj, okj, eps):
    ft, okt = ft.numpy(), okt.numpy()
    fj, okj = np.asarray(fj), np.asarray(okj)
    assert (okt == okj).mean() >= OK_AGREE, (okt == okj).mean()
    both = okt & okj
    assert both.sum() > 0.5 * len(both), both.sum()
    err = np.abs(ft[both] - fj[both]).max(axis=1)
    assert err.max() <= eps, err.max()
    assert (err > FLOW_ATOL).mean() <= NEAR_EPS_SHARE, np.sort(err)[-10:]


KERNELS = {"cell": (lk_cell.level_track_cell, lk_pallas_cell.level_track_pallas_cell),
           "v1": (lk_v1.level_track_v1, lk_pallas.level_track_pallas)}


@pytest.mark.parametrize("kernel", ["cell", "v1"])
@pytest.mark.parametrize("level,eps,radius", [(0, 0.01, 6), (1, 0.03, 20)])
def test_level_kernel_matches_jax(scene, kernel, level, eps, radius):
    """K3/K4 plain version vs the JAX kernel in interpret mode, with a
    nonzero guess and a quarter of the valid points switched off."""
    pyr, xy, valid = scene
    ip, pad = pad_level(pyr["t1l"][level])
    inx, _ = pad_level(pyr["t2l"][level])
    rng = np.random.default_rng(level)
    pts = (xy / 2.0 ** level).astype(np.float32)
    guess = rng.uniform(-1.5, 1.5, pts.shape).astype(np.float32)
    active = valid & (rng.random(len(pts)) > 0.25)
    port, jax_fn = KERNELS[kernel]
    fj, okj = jax_fn(jnp.asarray(ip), jnp.asarray(inx), jnp.asarray(pts),
                     jnp.asarray(guess), eps=eps, search_radius=radius, pad=pad,
                     interpret=True, active=jnp.asarray(active))
    stats = {}
    ft, okt = port(torch.from_numpy(ip), torch.from_numpy(inx), torch.from_numpy(pts),
                   torch.from_numpy(guess), eps=eps, search_radius=radius, pad=pad,
                   active=torch.from_numpy(active), stats=stats)
    assert_level_agrees(ft, okt, fj, okj, eps)
    # Inactive points: no iterations, flow = guess, not ok.
    assert not okt.numpy()[~active].any()
    np.testing.assert_array_equal(ft.numpy()[~active], guess[~active])
    assert (stats["iters"].numpy()[~active] == 0).all()
    it, rel = stats["iters"].numpy(), stats["reloads"].numpy()
    assert (rel <= it).all() and it.max() <= 30 and (it[okt.numpy()] >= 1).all()
    if kernel == "v1":
        np.testing.assert_array_equal(rel, it)
    assert len(stats["corners"]) == rel.sum()
    np.testing.assert_array_equal(np.bincount(stats["points"].numpy(), minlength=len(pts)),
                                  rel)


@pytest.mark.parametrize("kernel", ["cell", "v1"])
def test_staged_share_counts_reloads_inside_the_region(scene, kernel):
    """The share of a level call's reloads that K3/K4 read from their staged
    region of the next image: every one for a region over the whole level,
    and for a margin of 0 those at the window of the guess itself."""
    pyr, xy, valid = scene
    ip, pad = pad_level(pyr["t1l"][0])
    inx, _ = pad_level(pyr["t2l"][0])
    guess = np.random.default_rng(4).uniform(-1.5, 1.5, xy.shape).astype(np.float32)
    args = (torch.from_numpy(ip), torch.from_numpy(inx), torch.from_numpy(xy),
            torch.from_numpy(guess))
    stats = {}
    KERNELS[kernel][0](*args, pad=pad, active=torch.from_numpy(valid), stats=stats)
    hp, wp = ip.shape
    share = lambda m: lk_v1.staged_share(args[2], args[3], stats, hp, wp, pad=pad, margin=m)
    assert share(max(hp, wp)) == 1.0
    at_guess = np.stack([np.clip(np.floor(xy[:, 1] + pad + guess[:, 1] - 10), 0, hp - 22),
                         np.clip(np.floor(xy[:, 0] + pad + guess[:, 0] - 10), 0, wp - 22)],
                        -1)[stats["points"].numpy()]
    want = float(np.all(stats["corners"].numpy() == at_guess, axis=1).mean())
    assert 0.0 < want < 1.0 and share(0) == pytest.approx(want)
    assert share(0) <= share(2) <= share(lk_v1.STAGE_MARGIN) <= 1.0


def test_cell_and_v1_plain_versions_agree(scene):
    """K3 and K4 take the same iterations up to summation order."""
    pyr, xy, valid = scene
    ip, pad = pad_level(pyr["t1l"][0])
    inx, _ = pad_level(pyr["t2l"][0])
    args = (torch.from_numpy(ip), torch.from_numpy(inx), torch.from_numpy(xy),
            torch.zeros(len(xy), 2))
    fc, okc = lk_cell.level_track_cell(*args, pad=pad, active=torch.from_numpy(valid))
    fv, okv = lk_v1.level_track_v1(*args, pad=pad, active=torch.from_numpy(valid))
    assert_level_agrees(fc, okc, fv, okv, 0.01)


def test_level_kernels_check_inputs():
    img = torch.zeros(64, 64)
    pts = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="float32"):
        lk_v1.level_track_v1(img.double(), img, pts, pts)
    with pytest.raises(ValueError, match="devices"):
        lk_cell.level_track_cell(img, img, pts, pts.to("meta"))
    with pytest.raises(ValueError, match="does not fit"):
        lk_cell.level_track_cell(torch.zeros(16, 64), torch.zeros(16, 64), pts, pts)
    with pytest.raises(ValueError, match="active"):
        lk_v1.level_track_v1(img, img, pts, pts, active=torch.ones(4))
    flow, ok = lk_cell.level_track_cell(img, img, pts[:0], pts[:0])
    assert flow.shape == (0, 2) and ok.shape == (0,)


# (use_pallas, pallas_kernel) of each tracker the port adds.
TRACKERS = {"cell": (True, "cell"), "v1": (True, "v1"), "xla": (False, "cell")}


@pytest.mark.parametrize("tracker", ["cell", "v1", "xla"])
def test_track_matches_jax(scene, tracker):
    """Three levels from a prior off by a few pixels, a quarter of the valid
    points switched off."""
    pyr, xy, valid = scene
    use_pallas, kernel = TRACKERS[tracker]
    rng = np.random.default_rng(3)
    prior = (np.array([[-4.0, 1.0]]) + rng.uniform(-2, 2, xy.shape)).astype(np.float32)
    active = valid & (rng.random(len(xy)) > 0.25)
    kw = dict(levels=3, use_pallas=use_pallas, pallas_kernel=kernel)
    with jax_pallas_kernels():
        nj, okj = jlk.track(to_j(pyr["t1l"]), to_j(pyr["t2l"]), jnp.asarray(xy),
                            init_flow=jnp.asarray(prior), active=jnp.asarray(active), **kw)
    nt, okt = tlk.track(to_t(pyr["t1l"]), to_t(pyr["t2l"]), torch.from_numpy(xy),
                        init_flow=torch.from_numpy(prior),
                        active=torch.from_numpy(active), **kw)
    nt, okt, nj, okj = nt.numpy(), okt.numpy(), np.asarray(nj), np.asarray(okj)
    assert (okt == okj).mean() >= OK_AGREE
    both = okt & okj
    assert both.sum() > 0.5 * active.sum(), both.sum()
    np.testing.assert_allclose(nt[both], nj[both], atol=FLOW_ATOL, rtol=0)
    assert not okt[~active].any()


@pytest.mark.parametrize("level,radius", [(0, 6), (1, 20)])
def test_xla_level_track_matches_jax(scene, level, radius):
    pyr, xy, valid = scene
    pts = (xy / 2.0 ** level).astype(np.float32)
    guess = np.random.default_rng(5).uniform(-1.0, 1.0, pts.shape).astype(np.float32)
    ip, inx = pyr["t1l"][level], pyr["t2l"][level]
    fj, okj = jlk._level_track(jnp.asarray(ip), jnp.asarray(inx), jnp.asarray(pts),
                               jnp.asarray(guess), 21, 30, 0.01, 1e-4, radius,
                               active=jnp.asarray(valid))
    ft, okt = tlk._level_track(torch.from_numpy(ip), torch.from_numpy(inx),
                               torch.from_numpy(pts), torch.from_numpy(guess), 21, 30,
                               0.01, 1e-4, radius, active=torch.from_numpy(valid))
    ft, okt, fj, okj = ft.numpy(), okt.numpy(), np.asarray(fj), np.asarray(okj)
    assert (okt == okj).mean() >= OK_AGREE
    both = okt & okj
    assert both.sum() > 0.5 * valid.sum()
    np.testing.assert_allclose(ft[both], fj[both], atol=FLOW_ATOL, rtol=0)


def test_xla_level_track_on_a_level_smaller_than_the_window(scene):
    """Level 3 (24x32) padded by r+1 is 46 rows: the 64-px search window is
    clamped to (46, 64), a rectangular K1 read."""
    pyr, xy, valid = scene
    ip, inx = pyr["t1l"][3], pyr["t2l"][3]
    pts = (xy / 8.0).astype(np.float32)
    zero = np.zeros_like(pts)
    fj, okj = jlk._level_track(jnp.asarray(ip), jnp.asarray(inx), jnp.asarray(pts),
                               jnp.asarray(zero), 21, 30, 0.03, 1e-4, 20)
    ft, okt = tlk._level_track(torch.from_numpy(ip), torch.from_numpy(inx),
                               torch.from_numpy(pts), torch.from_numpy(zero), 21, 30,
                               0.03, 1e-4, 20)
    assert (okt.numpy() == np.asarray(okj)).mean() >= OK_AGREE
    both = okt.numpy() & np.asarray(okj)
    np.testing.assert_allclose(ft.numpy()[both], np.asarray(fj)[both], atol=FLOW_ATOL,
                               rtol=0)


def _grid_case(kind, rng):
    n = 300
    xy = rng.uniform([-10, -10], [W + 10, H + 10], (n, 2)).astype(np.float32)
    disp = rng.uniform(0.0, 60.0, n).astype(np.float32)
    valid = rng.random(n) > 0.3
    if kind == "none_valid":
        valid[:] = False
    elif kind == "empty_cells":
        # Only the left half of the frame: the right cells take the median.
        xy[:, 0] = np.abs(xy[:, 0]) % (W / 2)
    return xy, disp, valid


@pytest.mark.parametrize("kind", ["mixed", "none_valid", "empty_cells"])
def test_disparity_grid_and_sample_match_jax(kind):
    rng = np.random.default_rng(["mixed", "none_valid", "empty_cells"].index(kind))
    xy, disp, valid = _grid_case(kind, rng)
    gj = np.asarray(jlk.disparity_grid(jnp.asarray(xy), jnp.asarray(disp),
                                       jnp.asarray(valid), H, W, cell=64))
    gt = tlk.disparity_grid(torch.from_numpy(xy), torch.from_numpy(disp),
                            torch.from_numpy(valid), H, W, cell=64)
    assert gt.shape == gj.shape == (3, 4)
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-5, rtol=0)
    if kind == "none_valid":
        np.testing.assert_array_equal(gt.numpy(), 24.0)
    if kind == "empty_cells":
        med = np.sort(disp[valid])[valid.sum() // 2]
        assert (gt.numpy()[:, 2:] == med).all()
    sj = jlk.sample_disparity(jnp.asarray(gj), jnp.asarray(xy), cell=64)
    st = tlk.sample_disparity(gt, torch.from_numpy(xy), cell=64)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)
