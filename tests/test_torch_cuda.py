"""Card-only tests of the port: the CUDA kernels K1-K8 against their plain
versions, and the LK (dense and cell) and ORB slices on cuda against the
same slices on the CPU.

Marked ``cuda``; each skips without a GPU (decided inside the test). This
file imports neither JAX nor the JAX package, so it runs on a machine with
a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 exact (a copy). K2 exact (the kernel's __fmul_rn / __fmaf_rn
are the plain version's products and exactly emulated fmas). K3-K6:
ok masks >= 99% equal, flows within 1e-3 px for >= 98% of the points both
keep and within eps for all (block sums in another order can stop a point
one iteration earlier or later, which moves it by less than eps). K7 exact
(a copy). K8's checksums within 1e-4 of their largest value (sums of ~441
products in another order). The slices:
accept flags equal and poses within 1e-3 m / 1e-4, with the same RANSAC
draws fed to both devices — the GPU sums in another order than the CPU
(TF32 is off), nothing else differs.
"""
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.ops import lk_block, lk_cell, lk_v1, lk_v2, patch, roll
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.probes import lk_breakdown
from stereo_visual_odometry_tpu_torch.probes import roll as probe_roll
from stereo_visual_odometry_tpu_torch.utils import synthetic
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig

pytestmark = pytest.mark.cuda


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.parametrize("hp,wp,S", [(408, 1408, 24), (408, 1408, 22),
                                     (216, 768, 24), (216, 768, 22),
                                     (384, 1280, 3), (64, 64, 64)])
def test_k1_kernel_matches_reference(hp, wp, S):
    need_cuda()
    rng = np.random.default_rng(S)
    img = torch.from_numpy((rng.random((hp, wp)) * 255).astype(np.float32)).cuda()
    corners = np.stack([rng.integers(0, hp - S + 1, 1024),
                        rng.integers(0, wp - S + 1, 1024)], -1).astype(np.int32)
    corners[:8] = [[-5, 3], [hp, wp], [2, -9], [hp - S + 3, 0],
                   [0, wp + 40], [-1, -1], [hp - S, wp - S], [0, 0]]
    c = torch.from_numpy(corners).cuda()
    before = patch.extract_windows_int.launches
    got = patch.extract_windows_int(img, c, S)
    torch.cuda.synchronize()
    assert patch.extract_windows_int.launches == before + 1
    torch.testing.assert_close(got, patch.extract_windows_int_reference(img, c, S),
                               rtol=0, atol=0)
    empty = patch.extract_windows_int(img, c[:0], S)
    assert empty.shape == (0, S, S)


def test_k1_rejects_mixed_devices():
    need_cuda()
    with pytest.raises(ValueError):
        patch.extract_windows_int(torch.zeros(32, 32, device="cuda"),
                                  torch.zeros(4, 2, dtype=torch.int32), 4)


# The ORB level shapes at 384x1280 (8 levels, scale 1.2) and their budgets
# at 2048 features.
ORB_LEVELS = [(384, 1280), (320, 1067), (267, 889), (222, 741), (185, 617),
              (154, 514), (129, 429), (107, 357)]
ORB_BUDGETS = [445, 371, 309, 257, 214, 179, 149, 124]


def _k2_case(h, w, n, P, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((h, w), generator=g, device="cuda") * 255
    xy = torch.rand((n, 2), generator=g, device="cuda") * torch.tensor(
        [w - 1.0, h - 1.0], device="cuda")
    corners = torch.tensor([[0.0, 0.0], [w - 1.0, h - 1.0], [w - 1.0, 0.0],
                            [0.0, h - 1.0], [-2.0, -2.0], [w + 1.0, h + 1.0]],
                           device="cuda")
    return img, torch.cat([xy, corners[:n]])


@pytest.mark.parametrize("level", range(8))
def test_k2_kernel_matches_reference_at_orb_shapes(level):
    need_cuda()
    (h, w), n = ORB_LEVELS[level], ORB_BUDGETS[level]
    for P in (39, 31):
        img, xy = _k2_case(h, w, n, P, seed=level)
        before = patch.extract_patches.launches
        got = patch.extract_patches(img, xy, P)
        torch.cuda.synchronize()
        assert patch.extract_patches.launches == before + 1
        pad = P // 2 + 2
        want = patch.extract_patches_reference(patch.pad_edge(img, pad, pad, pad, pad),
                                               xy, P, pad)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    empty = patch.extract_patches(img, xy[:0], 39)
    assert empty.shape == (0, 39, 39)


def test_k2_rejects_mixed_devices():
    need_cuda()
    with pytest.raises(ValueError):
        patch.extract_patches(torch.zeros(64, 64, device="cuda"), torch.zeros(4, 2), 39)


def _textured(rng, hp, wp):
    """Blurred uniform noise: texture everywhere."""
    img = rng.random((hp + 8, wp + 8)) * 255
    k = np.exp(-0.5 * (np.arange(-3, 4) / 1.2) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    return img[4:-4, 4:-4].astype(np.float32)


# kernel -> (wrapper, plain version, takes an ``active`` mask)
LK_LEVEL = {"cell": (lk_cell.level_track_cell, lk_cell.level_track_cell_reference, True),
            "v1": (lk_v1.level_track_v1, lk_v1.level_track_v1_reference, True),
            "block": (lk_block.level_track_block, lk_block.level_track_block_reference,
                      True),
            "v2": (lk_v2.level_track_v2, lk_v2.level_track_v2_reference, False)}


@pytest.mark.parametrize("kernel", list(LK_LEVEL))
@pytest.mark.parametrize("hp,wp,eps,radius", [(408, 1408, 0.01, 6), (216, 768, 0.03, 20)])
def test_lk_level_kernel_matches_reference(kernel, hp, wp, eps, radius):
    """K3-K6 at the padded LK level shapes, N=1024: a pair moved by (2, -1)
    px, guesses within 1.5 px, a quarter of the points inactive (K6 takes no
    mask: every point is tracked)."""
    need_cuda()
    rng = np.random.default_rng(hp)
    prev = _textured(rng, hp, wp)
    nxt = np.roll(prev, (-1, 2), axis=(0, 1))
    pad = 12
    pts = (rng.random((1024, 2)) * [wp - 2 * pad - 1, hp - 2 * pad - 1]).astype(np.float32)
    guess = rng.uniform(-1.5, 1.5, (1024, 2)).astype(np.float32)
    fn, ref, masked = LK_LEVEL[kernel]
    active = rng.random(1024) > 0.25 if masked else np.ones(1024, bool)
    args = [torch.from_numpy(a).cuda() for a in (prev, nxt, pts, guess)]
    kw = dict(eps=eps, search_radius=radius, pad=pad)
    if masked:
        kw["active"] = torch.from_numpy(active).cuda()
    before = fn.launches
    stats = {}
    fk, okk = fn(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    fp, okp = ref(*args, **kw)
    okk, okp = okk.cpu().numpy(), okp.cpu().numpy()
    assert (okk == okp).mean() >= 0.99
    both = okk & okp
    assert both.sum() > 0.5 * active.sum()
    d = (fk - fp).abs().amax(-1).cpu().numpy()[both]
    assert d.max() <= eps and (d > 1e-3).mean() <= 0.02, np.sort(d)[-5:]
    assert not okk[~active].any()
    it = stats["iters"].cpu().numpy()
    assert (it[~active] == 0).all() and it.max() <= 30
    # The shift is recovered (interior points).
    assert np.median(np.abs(fk.cpu().numpy()[both] - [2.0, -1.0])) < 0.05
    empty, ok0 = fn(args[0], args[1], args[2][:0], args[3][:0], pad=pad)
    assert empty.shape == (0, 2) and ok0.shape == (0,)


@pytest.mark.parametrize("kernel", list(LK_LEVEL) + ["split"])
def test_lk_level_kernel_rejects_mixed_devices(kernel):
    need_cuda()
    img = torch.zeros(64, 64, device="cuda")
    with pytest.raises(ValueError, match="devices"):
        if kernel == "split":
            lk_block.level_track_block_split(img, img, torch.zeros(8, 2), 12, "tmpl")
        else:
            LK_LEVEL[kernel][0](img, img, torch.zeros(4, 2),
                                torch.zeros(4, 2, device="cuda"))


@pytest.mark.parametrize("axis", [0, 1])
def test_k7_roll_kernel_matches_reference(axis):
    """K7 over the probe's grid and amounts -1, the axis length and + 5:
    exact (a copy)."""
    need_cuda()
    before = roll.roll.launches
    worst = probe_roll.envelope("cuda", extended=True)
    assert roll.roll.launches > before
    assert all(err == 0.0 for ax, _, err in worst if ax == axis), worst
    x = torch.rand(128, 256, device="cuda")
    for amt in (-300, -1, 0, 9, 255, 256, 1000):
        a = torch.tensor([[amt]], dtype=torch.int32, device="cuda")
        torch.testing.assert_close(roll.roll(x, a, axis), roll.roll_reference(x, a, axis),
                                   rtol=0, atol=0)


def test_k7_rejects_mixed_devices():
    need_cuda()
    with pytest.raises(ValueError):
        roll.roll(torch.zeros(16, 256, device="cuda"), torch.zeros((1, 1), dtype=torch.int32),
                  0)


@pytest.mark.parametrize("label", list(lk_breakdown.VARIANTS))
def test_k8_split_kernel_matches_reference(label):
    """K8 at its probe's operating point, (408, 1408) and N = 1024: the
    tmpl/reload checksums and dots within 1e-4 relative; ``full`` is K5 on
    the same inputs, bit for bit."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.probes import lk_block as probe_block
    inputs = probe_block.make_inputs("cuda")
    before = lk_block.level_track_block_split.launches
    got = lk_breakdown.run_variant(label, inputs)
    torch.cuda.synchronize()
    assert lk_block.level_track_block_split.launches == before + 1
    if label == "full":
        flow, ok = lk_block.level_track_block(
            inputs["prev"], inputs["next"], inputs["pts"], inputs["guess"],
            search_radius=float("inf"), pad=probe_block.PAD)
        torch.testing.assert_close(got[0], flow, rtol=0, atol=0)
        torch.testing.assert_close(got[1] > 0, ok, rtol=0, atol=0)
    else:
        want = lk_breakdown.run_variant(label, inputs, plain=True)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert lk_breakdown.rel_err(g, w) <= 1e-4


COUNTERS = (patch.extract_windows_int, patch.extract_patches,
            lk_cell.level_track_cell, lk_v1.level_track_v1)


def _slice_on_both_devices(monkeypatch, seq, vo, chunk):
    rp = seq["rig"]
    cfg = RunConfig(camera=CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"],
                                        cy=rp["cy"], baseline=rp["baseline"]), vo=vo)
    n = len(seq["images_l"])
    draws = np.random.default_rng(0).random((n - 1, 128, 6)).astype(np.float32)
    orig = tpnp.ransac_pnp
    frames = list(zip(seq["images_l"], seq["images_r"]))
    runs = {}
    for device in ("cpu", "cuda"):
        queue = [torch.from_numpy(u).to(device) for u in draws]
        monkeypatch.setattr(tpnp, "ransac_pnp",
                            lambda *a, u=None, **kw: orig(*a, u=queue.pop(0), **kw))
        for fn in COUNTERS:
            fn.launches = 0
        sys_ = System(cfg, device=device)
        traj = sys_.run_chunked(frames, chunk=chunk)
        runs[device] = (sys_, traj, *(fn.launches for fn in COUNTERS))
    (s_c, t_c, *n_c), (s_g, t_g, *n_g) = runs["cpu"], runs["cuda"]
    assert n_c == [0, 0, 0, 0]
    assert [m["accept"] for m in s_g.metrics] == [m["accept"] for m in s_c.metrics]
    np.testing.assert_allclose(t_g[:, :3, 3], t_c[:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_g[:, :3, :3], t_c[:, :3, :3], atol=1e-4, rtol=0)
    return n_g


def test_slice_on_cuda_matches_cpu(monkeypatch):
    need_cuda()
    seq = synthetic.render_sequence(n_frames=8, h=192, w=256, fx=300.0)
    vo = VOConfig(height=192, width=256, max_features=256, num_hypotheses=128,
                  min_features_track=8, min_inlier_rate=0.3)
    assert _slice_on_both_devices(monkeypatch, seq, vo, chunk=4) == [1 + 27 * 7, 0, 0, 0]


def test_cell_slice_on_cuda_matches_cpu(monkeypatch):
    """``lk_kernel='cell'``: 6 K3 launches per tracked frame, K1 only for
    the subpixel refine (once per frame)."""
    need_cuda()
    seq = synthetic.render_sequence(n_frames=8, h=192, w=256, fx=300.0)
    vo = VOConfig(height=192, width=256, max_features=256, num_hypotheses=128,
                  min_features_track=8, min_inlier_rate=0.3, lk_kernel="cell")
    assert _slice_on_both_devices(monkeypatch, seq, vo, chunk=4) == [8, 0, 6 * 7, 0]


def test_orb_slice_on_cuda_matches_cpu(monkeypatch):
    need_cuda()
    seq = synthetic.render_sequence(n_frames=8, h=128, w=320, fx=300.0)
    rng = np.random.default_rng(1)  # sensor noise: no flat regions (test_torch_system.py)
    for k in ("images_l", "images_r"):
        seq[k] = (seq[k] + rng.normal(0, 1.0, seq[k].shape)).astype(np.float32)
    vo = VOConfig(mode="orb", height=128, width=320, max_features=256, orb_levels=4,
                  num_hypotheses=128, min_features_track=8, min_inlier_rate=0.3)
    # Per frame (the init included): two images x 4 levels, one K1 and one K2 each.
    assert _slice_on_both_devices(monkeypatch, seq, vo, chunk=4) == [8 * 8, 8 * 8, 0, 0]
