"""Card-only tests of the port: the CUDA kernels K1-K8 against their plain
versions, the LK (dense and cell) and ORB slices on cuda against the
same slices on the CPU, and the step's CUDA graph (``models/step_graph.py``)
against the eager step.

The bench (``probes/bench.py``): its kernel parity block on the card.

Slice 5: the command line at KITTI's shape (384x1248) counting K1, the
online feed's worker capturing the graph, a checkpoint from the card
loading on the CPU and back.

Marked ``cuda``; each skips without a GPU (decided inside the test). This
file imports neither JAX nor the JAX package, so it runs on a machine with
a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 exact (a copy). K2 exact (the kernel's __fmul_rn / __fmaf_rn
are the plain version's products and exactly emulated fmas). K3-K6:
ok masks >= 99% equal, flows within 1e-3 px for >= 98% of the points both
keep and within eps for all (block sums in another order can stop a point
one iteration earlier or later, which moves it by less than eps); K5 and
K6 are also held to the K3 and K4 kernels. K7 exact (a copy), through its C++ binding,
which refuses bad inputs with a ValueError. K8's checksums within 1e-4 of their largest value (sums of ~441
products in another order). The slices:
accept flags equal and poses within 1e-3 m / 1e-4, with the same RANSAC
draws fed to both devices — the GPU sums in another order than the CPU
(TF32 is off), nothing else differs. The graph: its replay equals the eager
step on the card bit for bit (the same kernels on the same inputs, the same
draws from the generator), and the launch counts it tallies are the kernels
a profiled replay runs.
"""
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.ops import (cuda_stream, lk_block, lk_cell, lk_v1, lk_v2,
                                                  native, orb, patch, roll)
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.probes import lk_breakdown
from stereo_visual_odometry_tpu_torch.probes import roll as probe_roll
from stereo_visual_odometry_tpu_torch.utils import profiling, synthetic
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


@pytest.mark.parametrize("n", [0, 1, 7, 1023])
@pytest.mark.parametrize("S", [24, 3, (5, 7), (64, 36)])
def test_k1_kernel_ragged_and_non_square(S, n):
    """Ragged N (a CTA's last group of points partly empty) and non-square
    windows: quads that break a row (Sw = 7, 36), the scalar path (3x3,
    5x7) and a window split over a whole CTA (64x36)."""
    need_cuda()
    sh, sw = (S, S) if isinstance(S, int) else S
    hp, wp = 408, 1408
    rng = np.random.default_rng(n + sh * sw)
    img = torch.from_numpy((rng.random((hp, wp)) * 255).astype(np.float32)).cuda()
    corners = np.stack([rng.integers(-4, hp - sh + 5, n),
                        rng.integers(-4, wp - sw + 5, n)], -1).astype(np.int32)
    c = torch.from_numpy(corners.reshape(n, 2)).cuda()
    before = patch.extract_windows_int.launches
    got = patch.extract_windows_int(img, c, S)
    torch.cuda.synchronize()
    assert got.shape == (n, sh, sw)
    assert patch.extract_windows_int.launches == before + (n > 0)  # nothing to launch at 0
    assert torch.equal(got, patch.extract_windows_int_reference(img, c, S))


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


@pytest.mark.parametrize("n", [1, 7, 445])
@pytest.mark.parametrize("P", [39, 31])
def test_k2_kernel_outside_and_ragged(P, n):
    """Centres up to 2 px outside the image on all four sides, N = 1 and
    ragged N: exact against the padded-image reference and the clamped plain
    version, and (P = 39) the same BRIEF bits."""
    need_cuda()
    h, w = 267, 889  # ORB level 2: odd extents
    rng = np.random.default_rng(P * n)
    img = torch.from_numpy((rng.random((h, w)) * 255).astype(np.float32)).cuda()
    out_lo = rng.uniform(-2, 0, (n, 2))
    out_hi = rng.uniform(0, 2, (n, 2)) + [w - 1, h - 1]
    inside = rng.uniform(0, 1, (n, 2)) * [w - 1, h - 1]
    pick = rng.integers(0, 3, (n, 2))  # per axis: below 0, inside, beyond the last pixel
    xy = np.where(pick == 0, out_lo, np.where(pick == 1, inside, out_hi))
    xy[:4] = [[-2.0, -2.0], [w + 1.0, h + 1.0], [-2.0, h + 1.0], [w + 1.0, -2.0]][:n]
    xy = torch.from_numpy(xy.astype(np.float32)).cuda()
    before = patch.extract_patches.launches
    got = patch.extract_patches(img, xy, P)
    torch.cuda.synchronize()
    assert patch.extract_patches.launches == before + 1
    pad = P // 2 + 2
    want = patch.extract_patches_reference(patch.pad_edge(img, pad, pad, pad, pad), xy, P,
                                           pad)
    assert torch.equal(got, want)
    assert torch.equal(got, patch.extract_patches_clamped(img, xy, P))
    if P == orb.DESC_PATCH:
        assert torch.equal(orb.brief_bits_from_patches(got, None),
                           orb.brief_bits_from_patches(want, None))


def test_k2_launches_one_kernel_and_no_pad(monkeypatch):
    """The CUDA route reads the unpadded image: no edge pad, no F.pad."""
    need_cuda()

    def no_pad(*args, **kwargs):
        raise AssertionError("the CUDA route of extract_patches padded the image")

    monkeypatch.setattr(patch, "pad_edge", no_pad)
    monkeypatch.setattr(torch.nn.functional, "pad", no_pad)
    img = torch.rand(320, 1067, device="cuda") * 255
    xy = torch.rand(371, 2, device="cuda") * torch.tensor([1066.0, 319.0], device="cuda")
    before = patch.extract_patches.launches
    out = patch.extract_patches(img, xy, 39)
    torch.cuda.synchronize()
    assert out.shape == (371, 39, 39) and patch.extract_patches.launches == before + 1


def test_k1_k2_in_a_cuda_graph_match_eager():
    """Captured in a CUDA graph (the capture stream, outputs from the graph's
    pool), K1 and K2 give the eager outputs bit for bit, also after the
    inputs change in place between replays."""
    need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    img1 = torch.rand(408, 1408, generator=g, device="cuda") * 255
    corners = torch.randint(0, 380, (1024, 2), generator=g, device="cuda").to(torch.int32)
    img2 = torch.rand(384, 1280, generator=g, device="cuda") * 255
    xy = torch.rand(445, 2, generator=g, device="cuda") * torch.tensor(
        [1279.0, 383.0], device="cuda")
    calls = lambda: (patch.extract_windows_int(img1, corners, 24),
                     patch.extract_windows_int(img1, corners, (5, 7)),
                     patch.extract_patches(img2, xy, 39), patch.extract_patches(img2, xy, 31))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for step in range(2):
        if step:
            img1.mul_(0.5).add_(3.0)
            img2.copy_(img2.flip(1))
            xy.add_(0.37)
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, calls()):
            assert torch.equal(got, want)


def test_k2_patch_size_limits():
    """P = 127 (the JAX kernel's limit) takes opt-in shared memory and stays
    exact; P = 128 raises, naming the limit; and the C entry refuses a
    window above the card's opt-in shared memory."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.ops import native
    img = torch.rand(150, 260, device="cuda") * 255
    xy = torch.tensor([[0.0, 0.0], [130.4, 75.6], [259.0, 149.0], [-2.0, 151.0]],
                      device="cuda")
    P = patch.MAX_PATCH
    pad = P // 2 + 2
    want = patch.extract_patches_reference(patch.pad_edge(img, pad, pad, pad, pad), xy, P,
                                           pad)
    assert torch.equal(patch.extract_patches(img, xy, P), want)
    with pytest.raises(ValueError, match=f"P <= {patch.MAX_PATCH}"):
        patch.extract_patches(img, xy, P + 1)
    big, P = torch.zeros(600, 600, device="cuda"), 300  # a 301^2 window: 362 KB
    out = torch.empty(len(xy), P, P, device="cuda")
    index = big.get_device()
    err = native.entry("svo_extract_patches")(
        big.data_ptr(), 600, 600, xy.data_ptr(), len(xy), P, P // 2 + 2, out.data_ptr(),
        index, cuda_stream.current_stream(index))
    assert err != 0


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
    stats0 = {}
    empty, ok0 = fn(args[0], args[1], args[2][:0], args[3][:0], pad=pad, stats=stats0)
    assert fn.launches == before + 1  # nothing to launch at N = 0
    assert empty.shape == (0, 2) and empty.dtype == torch.float32
    assert ok0.shape == (0,) and ok0.dtype == torch.bool
    assert stats0["iters"].shape == (0,) and stats0["iters"].dtype == torch.int32


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
    """K7 over the probe's grid and amounts -1, the axis length and + 5, and
    on both of its kernels' paths: exact (a copy)."""
    need_cuda()
    before = roll.roll.launches
    worst = probe_roll.envelope("cuda", extended=True)
    assert roll.roll.launches > before and roll._launch is not None  # through the binding
    assert all(err == 0.0 for ax, _, err in worst if ax == axis), worst
    # The 16-byte path (cols % 4 == 0, aligned) and the one-element path: an
    # odd width, and a view 4 bytes off 16-byte alignment.
    flat = torch.rand(129 * 256, device="cuda")
    for x in (flat[:128 * 256].view(128, 256), torch.rand(37, 255, device="cuda"),
              torch.rand(3, 6, device="cuda"), flat[1:1 + 128 * 256].view(128, 256)):
        for amt in (-300, -5, -4, -1, 0, 3, 4, 9, 255, 256, 1000):
            a = torch.tensor([[amt]], dtype=torch.int32, device="cuda")
            torch.testing.assert_close(roll.roll(x, a, axis), roll.roll_reference(x, a, axis),
                                       rtol=0, atol=0)


def test_k7_rejects_mixed_devices():
    need_cuda()
    with pytest.raises(ValueError):
        roll.roll(torch.zeros(16, 256, device="cuda"), torch.zeros((1, 1), dtype=torch.int32),
                  0)


@pytest.mark.parametrize("bad", ["x_float64", "x_3d", "x_1d", "x_empty", "amt_int64",
                                 "amt_shape", "axis"])
def test_k7_binding_rejects_bad_inputs(bad):
    """The binding refuses what the kernel does not take with a ValueError
    before any launch: no fallback to torch.roll, no launch counted."""
    need_cuda()
    x = torch.rand(16, 256, device="cuda")
    amt, axis = torch.zeros((1, 1), dtype=torch.int32, device="cuda"), 0
    if bad == "x_float64":
        x = x.double()
    elif bad == "x_3d":
        x = x[None]
    elif bad == "x_1d":
        x = x[0]
    elif bad == "x_empty":
        x = x[:0]
    elif bad == "amt_int64":
        amt = amt.long()
    elif bad == "amt_shape":
        amt = amt.reshape(1)
    else:
        axis = 2
    before = roll.roll.launches
    with pytest.raises(ValueError):
        roll.roll(x, amt, axis)
    assert roll.roll.launches == before


def test_k7_output_is_new_memory():
    """K7's output never aliases its input (nor a non-contiguous input's
    storage), and it leaves the input as it was."""
    need_cuda()
    x = torch.rand(128, 256, device="cuda")
    keep = x.clone()
    a = torch.tensor([[7]], dtype=torch.int32, device="cuda")
    for src in (x, x.t()):  # the transpose takes the contiguous copy
        out = roll.roll(src, a, 1)
        assert out.is_contiguous() and out.shape == src.shape
        assert out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
        torch.testing.assert_close(out, torch.roll(src, -7, 1), rtol=0, atol=0)
    assert torch.equal(x, keep)


def test_k7_in_a_cuda_graph_matches_eager():
    """Captured in a CUDA graph, K7 calls replay exactly what they compute
    eagerly, also after the input and the amount change in place (the amount
    is read on the card at each replay)."""
    need_cuda()
    x = torch.rand(64, 256, device="cuda")
    a = torch.tensor([[9]], dtype=torch.int32, device="cuda")
    calls = lambda: [roll.roll(x, a, 0), roll.roll(x, a, 1)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = roll.roll.launches
    with torch.cuda.graph(graph):
        captured = calls()
    assert roll.roll.launches == before + 2
    for step in range(2):
        if step:
            x.copy_(torch.rand_like(x))
            a.fill_(-300)
        graph.replay()
        torch.cuda.synchronize()
        for got, axis in zip(captured, (0, 1)):
            torch.testing.assert_close(got, roll.roll_reference(x, a, axis), rtol=0, atol=0)


@pytest.mark.parametrize("shape,kernel", [((128, 256), "roll4_kernel"),
                                          ((37, 255), "roll_kernel")])
def test_k7_call_is_one_kernel(shape, kernel):
    """A K7 call launches one kernel (the 16-byte one where the width allows,
    else the one-element one) and no other device work (the binding
    allocates, checks and launches on the host), by the profiler's count."""
    need_cuda()
    x = torch.rand(*shape, device="cuda")
    a = torch.tensor([[9]], dtype=torch.int32, device="cuda")
    roll.roll(x, a, 0)
    torch.cuda.synchronize()
    assert roll._launch is not None  # the binding, not ctypes or torch.roll
    device_work = _device_work(lambda: roll.roll(x, a, 0))
    assert len(device_work) == 1 and f"::{kernel}(" in device_work[0], device_work


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
    mode, rounds = lk_breakdown.VARIANTS[label]
    flow0, ok0, dots0 = lk_block.level_track_block_split(
        inputs["prev"], inputs["next"], inputs["pts"][:0], probe_block.PAD, mode, rounds)
    assert lk_block.level_track_block_split.launches == before + 1  # none at N = 0
    assert (flow0.shape, ok0.shape, dots0.shape) == ((0, 2), (0,), (0, got[2].shape[1], 8))
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


def _smooth_pair(rng, hp, wp, shift_xy):
    """A smooth zero-mean texture (12 sinusoids, periods 40-100 px) and the
    same moved by ``shift_xy`` px: LK converges from 10 px away. Zero mean
    keeps K3's 8 dots from cancelling a large constant, so two orders of
    the sums agree to ~1e-3 px (K3's plain version on the transposed pair,
    on the CPU: 7.9e-4 px at most)."""
    k = 12
    period, theta = rng.uniform(40, 100, k), rng.uniform(0, 2 * np.pi, k)
    phase, amp = rng.uniform(0, 2 * np.pi, k), rng.uniform(10, 30, k)
    wx, wy = 2 * np.pi * np.cos(theta) / period, 2 * np.pi * np.sin(theta) / period
    y, x = np.arange(hp)[:, None, None], np.arange(wp)[None, :, None]
    img = lambda dx, dy: ((amp * np.sin(wx * (x - dx) + wy * (y - dy) + phase))
                          .sum(-1) / 4).astype(np.float32)
    return img(0.0, 0.0), img(*shift_xy)


def _off_region_inputs():
    """Guesses STAGE_MARGIN + 4 px off the motion on a smooth pair: the
    points' windows leave the region of the next image staged around the
    guess (on average more than one window per point: 2.1 for K3, 3.0 for
    K4, by the plain version on the CPU; every point converges within 8
    iterations, where from 12 px some run all 30)."""
    rng = np.random.default_rng(9)
    hp, wp, pad, n = 216, 768, 12, 1024
    prev, nxt = _smooth_pair(rng, hp, wp, (2.0, -1.0))
    pts = (rng.random((n, 2)) * [wp - 2 * pad - 1, hp - 2 * pad - 1]).astype(np.float32)
    guess = (np.float32([2.0 + lk_v1.STAGE_MARGIN + 4, -1.0])
             + rng.uniform(-0.5, 0.5, (n, 2))).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (prev, nxt, pts, guess)], pad


def _assert_level_calls_agree(got, want, n):
    """Phase 5's criteria: ok masks >= 99% equal, flows within 1e-3 px for
    >= 98% of the kept points and within eps for all, the mean iterations and
    reloads within 0.01, the motion recovered."""
    (fk, okk, st_k), (fp, okp, st_p) = got, want
    assert float((okk == okp).float().mean()) >= 0.99
    both = okk & okp
    assert int(both.sum()) > 0.9 * n
    d = (fk - fp).abs().amax(-1)[both]
    assert float((d > 1e-3).float().mean()) <= 0.02 and float(d.max()) <= 0.01
    for key in ("iters", "reloads"):
        assert abs(float(st_k[key].float().mean()) - float(st_p[key].float().mean())) <= 0.01
    assert float((fk[both] - torch.tensor([2.0, -1.0], device="cuda")).norm(dim=-1)
                 .median()) < 0.05


def _with_stats(fn, args, **kw):
    stats = {}
    return (*fn(*args, stats=stats, **kw), stats)


@pytest.mark.parametrize("kernel", ["cell", "v1"])
def test_k3_k4_windows_outside_the_staged_region(kernel):
    """Windows off the staged region are read from device memory; the
    results match the plain version under phase 5's criteria."""
    need_cuda()
    args, pad = _off_region_inputs()
    fn, ref, _ = LK_LEVEL[kernel]
    kw = dict(eps=0.01, search_radius=20, pad=pad)
    want = _with_stats(ref, args, **kw)
    share = lk_v1.staged_share(args[2], args[3], want[2], *args[0].shape, pad=pad)
    assert (1.0 - share) * len(want[2]["corners"]) > len(args[2])
    _assert_level_calls_agree(_with_stats(fn, args, **kw), want, len(args[2]))


def test_k6_windows_outside_the_staged_region():
    """K6 stages K3's region and reloads every iteration; its windows off
    the region come from device memory. The results match its plain version
    and the K4 kernel under phase 5's criteria (every point tracked: K6 takes
    no mask)."""
    need_cuda()
    args, pad = _off_region_inputs()
    kw = dict(eps=0.01, search_radius=20, pad=pad)
    want = _with_stats(lk_v2.level_track_v2_reference, args, **kw)
    share = lk_v1.staged_share(args[2], args[3], want[2], *args[0].shape, pad=pad,
                               margin=lk_block.STAGE_MARGIN)
    assert (1.0 - share) * len(want[2]["corners"]) > len(args[2])
    got = _with_stats(lk_v2.level_track_v2, args, **kw)
    _assert_level_calls_agree(got, want, len(args[2]))
    _assert_level_calls_agree(got, _with_stats(lk_v1.level_track_v1, args, **kw),
                              len(args[2]))
    np.testing.assert_array_equal(got[2]["reloads"].cpu(), got[2]["iters"].cpu())


def test_k5_windows_outside_the_staged_region():
    """K5 stages K3's region; its windows off the region come from device
    memory. The results match the plain version and the K3 kernel under
    phase 5's criteria."""
    need_cuda()
    args, pad = _off_region_inputs()
    kw = dict(eps=0.01, search_radius=20, pad=pad)
    want = _with_stats(lk_block.level_track_block_reference, args, **kw)
    share = lk_v1.staged_share(args[2], args[3], want[2], *args[0].shape, pad=pad,
                               margin=lk_block.STAGE_MARGIN)
    assert (1.0 - share) * len(want[2]["corners"]) > len(args[2])
    got = _with_stats(lk_block.level_track_block, args, **kw)
    _assert_level_calls_agree(got, want, len(args[2]))
    _assert_level_calls_agree(got, _with_stats(lk_cell.level_track_cell, args, **kw),
                              len(args[2]))


@pytest.mark.parametrize("radius", [2.5, 6])
def test_k5_kernel_matches_the_k3_kernel(radius):
    """K5 and K3 compute one function: on K3's card-test inputs (a quarter of
    the points inactive, guesses within 1.5 px of a (2, -1) px motion, so
    that radius 2.5 drops about a third of them) the same ok masks (>= 99%),
    flows within 1e-3 px for >= 98% and within eps for all, the same mean
    iterations and reloads; inactive points keep their guess, and a call
    without ``stats`` gives the same outputs bit for bit."""
    need_cuda()
    (prev, nxt, pts, guess, active), pad = _k3_k4_inputs()
    args = (prev, nxt, pts, guess)
    kw = dict(pad=pad, active=active, search_radius=radius)
    got = _with_stats(lk_block.level_track_block, args, **kw)
    want = _with_stats(lk_cell.level_track_cell, args, **kw)
    assert float((got[1] == want[1]).float().mean()) >= 0.99
    both = got[1] & want[1]
    assert int(both.sum()) > 0.5 * int(active.sum())
    d = (got[0] - want[0]).abs().amax(-1)[both]
    assert float(d.max()) <= 0.01 and float((d > 1e-3).float().mean()) <= 0.02
    for key in ("iters", "reloads"):
        assert abs(float(got[2][key][active].float().mean())
                   - float(want[2][key][active].float().mean())) <= 0.01
    assert torch.equal(got[0][~active], guess[~active]) and not bool(got[1][~active].any())
    assert int(got[2]["iters"][~active].abs().sum()) == 0
    flow, ok = lk_block.level_track_block(*args, **kw)
    assert torch.equal(flow, got[0]) and torch.equal(ok, got[1])


def _k6_bare(args, kw, active):
    """K6 through its bare C entry (K4's contract) with ``active``: (flow,
    ok, stats)."""
    from stereo_visual_odometry_tpu_torch.probes import lk_timing
    held = lk_timing.bare_entry(native, cuda_stream.current_stream, "svo_lk_level_v2", args,
                                dict(kw, active=active), stats=True)()
    torch.cuda.synchronize()
    flow, ok, counts = held[-3:]
    return flow, ok, {"iters": counts[:, 0], "reloads": counts[:, 1]}


@pytest.mark.parametrize("radius", [2.5, 6])
def test_k6_kernel_matches_the_k4_kernel(radius):
    """K6 and K4 compute one function: on K4's card-test inputs with K4's
    mask passed through K6's bare C entry (the wrapper, like the JAX kernel,
    takes none), the same ok masks (>= 99%), flows within 1e-3 px for >= 98%
    and within eps for all, the same mean iterations and reloads; inactive
    points keep their guess. Without a mask the wrapper and the bare entry
    give the same outputs bit for bit."""
    need_cuda()
    (prev, nxt, pts, guess, active), pad = _k3_k4_inputs()
    args = (prev, nxt, pts, guess)
    kw = dict(win=21, iters=30, eps=0.01, pad=pad, search_radius=radius)
    got = _k6_bare(args, kw, active)
    want = _with_stats(lk_v1.level_track_v1, args, active=active, **kw)
    assert float((got[1] == want[1]).float().mean()) >= 0.99
    both = got[1] & want[1]
    assert int(both.sum()) > 0.5 * int(active.sum())
    d = (got[0] - want[0]).abs().amax(-1)[both]
    assert float(d.max()) <= 0.01 and float((d > 1e-3).float().mean()) <= 0.02
    for key in ("iters", "reloads"):
        assert abs(float(got[2][key][active].float().mean())
                   - float(want[2][key][active].float().mean())) <= 0.01
    assert torch.equal(got[0][~active], guess[~active]) and not bool(got[1][~active].any())
    assert int(got[2]["iters"][~active].abs().sum()) == 0
    bare = _k6_bare(args, kw, None)
    flow, ok = lk_v2.level_track_v2(*args, **kw)
    assert torch.equal(flow, bare[0]) and torch.equal(ok, bare[1])


def _k3_k4_inputs(seed=6):
    rng = np.random.default_rng(seed)
    hp, wp, pad, n = 408, 1408, 12, 1024
    prev = _textured(rng, hp, wp)
    nxt = np.roll(prev, (-1, 2), axis=(0, 1))
    pts = (rng.random((n, 2)) * [wp - 2 * pad - 1, hp - 2 * pad - 1]).astype(np.float32)
    guess = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    active = rng.random(n) > 0.25
    return [torch.from_numpy(a).cuda() for a in (prev, nxt, pts, guess, active)], pad


def test_k3_k4_in_a_cuda_graph_match_eager():
    """Captured in a CUDA graph, K3, K4 and K5 (with and without a mask,
    with statistics) give the eager outputs bit for bit, also after the
    inputs change in place between replays."""
    need_cuda()
    (prev, nxt, pts, guess, active), pad = _k3_k4_inputs()
    stats = [{}, {}, {}]

    def calls():
        return (*lk_cell.level_track_cell(prev, nxt, pts, guess, pad=pad, active=active,
                                          stats=stats[0]),
                *lk_v1.level_track_v1(prev, nxt, pts, guess, pad=pad, stats=stats[1]),
                *lk_cell.level_track_cell(prev, nxt, pts, guess, pad=pad, search_radius=20),
                *lk_block.level_track_block(prev, nxt, pts, guess, pad=pad, active=active,
                                            stats=stats[2]),
                *lk_block.level_track_block(prev, nxt, pts, guess, pad=pad))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    captured_stats = [dict(st) for st in stats]
    for step in range(2):
        if step:
            nxt.copy_(torch.roll(nxt, 1, 1))
            guess.add_(0.25)
            active.copy_(~active)
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, calls()):
            assert torch.equal(got, want)
        for got, want in zip(captured_stats, stats):
            assert all(torch.equal(got[k], want[k]) for k in ("iters", "reloads"))


def _device_work(call) -> list:
    """The names of the device work one ``call`` does, by the profiler. A
    session that recorded no device work at all (CUPTI now and then delivers
    no record of a short session; the kernel ran) is taken again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        device_work = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
        if device_work:
            break
    return device_work


def _level_call_is_one_kernel(kernel, masked, name):
    (prev, nxt, pts, guess, active), pad = _k3_k4_inputs()
    fn = LK_LEVEL[kernel][0]
    kw = dict(pad=pad, active=active) if masked else dict(pad=pad)
    fn(prev, nxt, pts, guess, **kw)  # the build and the first launch
    torch.cuda.synchronize()
    device_work = _device_work(lambda: fn(prev, nxt, pts, guess, **kw))
    assert len(device_work) == 1 and name in device_work[0], device_work


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", ["cell", "v1"])
def test_k3_k4_wrapper_call_is_one_kernel(kernel, masked):
    """One level call is one CUDA kernel and no other device work (no mask
    conversion, no tail), by the profiler's count."""
    need_cuda()
    _level_call_is_one_kernel(kernel, masked, "lk_level_kernel")


@pytest.mark.parametrize("masked", [False, True])
def test_k5_wrapper_call_is_one_kernel(masked):
    """A K5 level call is one CUDA kernel, as K3's: its tail, the mask and
    the statistics are the kernel's, no other node."""
    need_cuda()
    _level_call_is_one_kernel("block", masked, "lk_block_cell_kernel")


def test_k6_wrapper_call_is_one_kernel():
    """A K6 level call is one CUDA kernel (K5's, with K4's body): its tail
    and the statistics are the kernel's, no mask is made, no other node."""
    need_cuda()
    _level_call_is_one_kernel("v2", False, "lk_block_cell_kernel")


@pytest.mark.parametrize("label", list(lk_breakdown.VARIANTS))
def test_k8_call_is_one_kernel(label):
    """Each K8 variant is one CUDA kernel, K5's, and no other device work:
    no guess or mask is made, only the outputs are allocated."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.probes import lk_block as probe_block
    inputs = probe_block.make_inputs("cuda")
    lk_breakdown.run_variant(label, inputs)  # the build and the first launch
    torch.cuda.synchronize()
    device_work = _device_work(lambda: lk_breakdown.run_variant(label, inputs))
    assert len(device_work) == 1 and "lk_block_cell_kernel" in device_work[0], device_work


# ---- slice 4's batched entries (their one-kernel test with the others) ---- #

def _batched_inputs(B=3, seed=0):
    """B textured level pairs at LK level 0's padded shape, (B, N, 2) points
    inside, guesses within 1.5 px, a quarter inactive; other images and
    points per sequence."""
    rng = np.random.default_rng(seed)
    hp, wp, pad, n = 408, 1408, 12, 1024
    prev = np.stack([_textured(rng, hp, wp) for _ in range(B)])
    nxt = np.roll(prev, (-1, 2), axis=(1, 2))
    pts = (rng.random((B, n, 2)) * [wp - 2 * pad - 1, hp - 2 * pad - 1]).astype(np.float32)
    guess = rng.uniform(-1.5, 1.5, (B, n, 2)).astype(np.float32)
    active = rng.random((B, n)) > 0.25
    corners = np.stack([rng.integers(0, hp - 24, (B, n)), rng.integers(0, wp - 24, (B, n))],
                       -1).astype(np.int32)
    centers = (rng.random((B, 445, 2)) * [wp - 1, hp - 1]).astype(np.float32)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return {k: cuda(v) for k, v in dict(prev=prev, nxt=nxt, pts=pts, guess=guess,
                                        active=active, corners=corners,
                                        centers=centers).items()}, pad


# name -> (the batched call, the B = 1 wrapper call of sequence b, its counter)
BATCHED = {
    "K1": (lambda x, p: patch.extract_windows_int_batched(x["prev"], x["corners"], 24),
           lambda x, p, b: patch.extract_windows_int(x["prev"][b], x["corners"][b], 24),
           patch.extract_windows_int),
    "K2": (lambda x, p: patch.extract_patches_batched(x["prev"], x["centers"], 39),
           lambda x, p, b: patch.extract_patches(x["prev"][b], x["centers"][b], 39),
           patch.extract_patches),
    "K3": (lambda x, p: lk_cell.level_track_cell_batched(
               x["prev"], x["nxt"], x["pts"], x["guess"], pad=p, active=x["active"]),
           lambda x, p, b: lk_cell.level_track_cell(x["prev"][b], x["nxt"][b], x["pts"][b],
                                                    x["guess"][b], pad=p,
                                                    active=x["active"][b]),
           lk_cell.level_track_cell),
    "K4": (lambda x, p: lk_v1.level_track_v1_batched(
               x["prev"], x["nxt"], x["pts"], x["guess"], pad=p, active=x["active"]),
           lambda x, p, b: lk_v1.level_track_v1(x["prev"][b], x["nxt"][b], x["pts"][b],
                                                x["guess"][b], pad=p, active=x["active"][b]),
           lk_v1.level_track_v1),
}


def _graph_node_types(call) -> list:
    """The node types (``CUgraphNodeType``: 0 a kernel) of a CUDA graph that
    captures one ``call`` after an eager warm-up: the device work the call
    does, read from the graph itself (``cuGraphGetNodes``), so it does not
    depend on what the profiler records late in a process."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # the build and the first launch
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


@pytest.mark.parametrize("name", list(BATCHED))
def test_batched_entry_is_one_kernel(name):
    """A batched call (B = 3) is one CUDA kernel and no other device work:
    a graph that captures it holds one node, a kernel, wherever the test
    runs in its process."""
    need_cuda()
    x, pad = _batched_inputs()
    batched = BATCHED[name][0]
    assert _graph_node_types(lambda: batched(x, pad)) == [0]


def test_k6_k8_in_a_cuda_graph_match_eager():
    """Captured in a CUDA graph, K6 (with statistics and without) and K8's
    four variants give the eager outputs bit for bit, also after the inputs
    change in place between replays."""
    need_cuda()
    (prev, nxt, pts, guess, _), pad = _k3_k4_inputs()
    stats = {}

    def calls():
        out = [*lk_v2.level_track_v2(prev, nxt, pts, guess, pad=pad, stats=stats),
               *lk_v2.level_track_v2(prev, nxt, pts, guess, pad=pad, search_radius=2.5)]
        for mode, rounds in lk_breakdown.VARIANTS.values():
            out += lk_block.level_track_block_split(prev, nxt, pts, pad, mode, rounds)
        return out

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    captured_stats = dict(stats)
    for step in range(2):
        if step:
            nxt.copy_(torch.roll(nxt, 1, 1))
            guess.add_(0.25)
            pts.add_(0.5)
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, calls(), strict=True):
            assert torch.equal(got, want)
        assert all(torch.equal(captured_stats[k], stats[k]) for k in ("iters", "reloads"))


COUNTERS = (patch.extract_windows_int, patch.extract_patches,
            lk_cell.level_track_cell, lk_v1.level_track_v1)


def _slice_on_both_devices(monkeypatch, seq, vo, chunk):
    rp = seq["rig"]
    cfg = RunConfig(camera=CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"],
                                        cy=rp["cy"], baseline=rp["baseline"]), vo=vo)
    n = len(seq["images_l"])
    draws = np.random.default_rng(0).random((n - 1, 128, 6)).astype(np.float32)
    frames = list(zip(seq["images_l"], seq["images_r"]))
    runs = {}
    for device in ("cpu", "cuda"):
        # The draws of both routes: ransac_pnp's own on the CPU, System's
        # outside the graph on cuda.
        queue = [torch.from_numpy(u).to(device) for u in draws]
        monkeypatch.setattr(tpnp, "draw_uniforms", lambda *a, **kw: queue.pop(0))
        for fn in COUNTERS:
            fn.launches = 0
        sys_ = System(cfg, device=device)
        traj = sys_.run_chunked(frames, chunk=chunk)
        assert not queue
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


SMALL = dict(height=192, width=256, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)
GRAPH_PATHS = {  # VOConfig, and the kernels one step launches
    "dense": (SMALL, {"extract_windows_int": 27}),
    "cell": (dict(SMALL, lk_kernel="cell"),
             {"extract_windows_int": 1, "level_track_cell": 6}),
    "v1": (dict(SMALL, lk_kernel="v1"), {"extract_windows_int": 1, "level_track_v1": 6}),
    "no_sweep": (dict(SMALL, lk_sweep=False), {"extract_windows_int": 45}),
    "orb": (dict(SMALL, mode="orb", height=128, width=320, orb_levels=4),
            {"extract_windows_int": 8, "extract_patches": 8}),
    "lk_persistent": (dict(SMALL, persistent_tracks=True), {"extract_windows_int": 27}),
    "orb_persistent": (dict(SMALL, mode="orb", height=128, width=320, orb_levels=4,
                            persistent_tracks=True),
                       {"extract_windows_int": 8, "extract_patches": 8}),
}
KERNEL_NAMES = {"extract_windows_int": "extract_windows_int_kernel",  # counter -> kernel
                "extract_patches": "extract_patches_kernel",
                "level_track_cell": "lk_level_kernel", "level_track_v1": "lk_level_kernel"}


def _graph_sequence(vo, n_frames=8):
    seq = synthetic.render_sequence(n_frames=n_frames, h=vo["height"], w=vo["width"],
                                    fx=300.0)
    if vo.get("mode") == "orb":  # sensor noise: no flat regions (test_torch_system.py)
        rng = np.random.default_rng(1)
        for k in ("images_l", "images_r"):
            seq[k] = (seq[k] + rng.normal(0, 1.0, seq[k].shape)).astype(np.float32)
    rp = seq["rig"]
    cfg = RunConfig(camera=CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"],
                                        cy=rp["cy"], baseline=rp["baseline"]),
                    vo=VOConfig(**vo))
    return cfg, seq, list(zip(seq["images_l"], seq["images_r"]))


def _assert_runs_equal(sys_g, traj_g, sys_e, traj_e):
    """Graph and eager runs bit for bit: poses, every metric, the status and
    the generator (the same draws were taken)."""
    assert np.array_equal(traj_g, traj_e)
    assert len(sys_g.metrics) == len(sys_e.metrics)
    for mg, me in zip(sys_g.metrics, sys_e.metrics):
        assert mg.keys() == me.keys()
        for k in mg.keys() - {"time_s"}:
            assert np.array_equal(mg[k], me[k]), k
    assert sys_g.status == sys_e.status
    assert torch.equal(sys_g.generator.get_state(), sys_e.generator.get_state())
    for k in ("track_id", "track_age", "next_id"):  # persistent tracks
        if k in sys_e.state:
            assert torch.equal(sys_g.state[k], sys_e.state[k]), k


def test_disparity_grid_is_deterministic_on_cuda():
    """``lk.disparity_grid`` (the ``lk_sweep=False`` prior) sums each cell in
    index order on the card: the same bits on every call, and the CPU's."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.ops import lk
    rng = np.random.default_rng(8)
    n = 1024
    xy = torch.from_numpy((rng.random((n, 2)) * [1279, 383]).astype(np.float32))
    disp = torch.from_numpy((rng.random(n) * 60).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.2)
    want = lk.disparity_grid(xy, disp, valid, 384, 1280)
    args = [t.cuda() for t in (xy, disp, valid)]
    for _ in range(20):
        assert torch.equal(lk.disparity_grid(*args, 384, 1280).cpu(), want)


@pytest.mark.parametrize("method", ["step", "run_chunked"])
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_replay_matches_eager(path, method):
    """8 frames through ``System`` with the graph and without it (the same
    seed, so the same draws): equal bit for bit, through ``step`` (``run``)
    and ``run_chunked`` (chunks of 3: one graph serves the short last one)."""
    need_cuda()
    cfg, _, frames = _graph_sequence(GRAPH_PATHS[path][0])
    runs = []
    for graph in (True, False):
        sys_ = System(cfg, device="cuda", graph=graph)
        traj = sys_.run(frames) if method == "step" else sys_.run_chunked(frames, chunk=3)
        runs += [sys_, traj]
    assert runs[0].graph is not None and runs[2].graph is None
    _assert_runs_equal(*runs)
    assert sum(m["accept"] for m in runs[0].metrics) >= 5


@pytest.mark.parametrize("method", ["step", "run_chunked"])
def test_graph_reinit_after_lost_matches_eager(method):
    """LOST->reinit under the graph, with blank frames as in
    ``test_torch_system.py``: the fresh state goes into the graph's buffers
    (the pose chain kept) and tracking comes back, as eagerly."""
    need_cuda()
    cfg, seq, frames = _graph_sequence(SMALL, n_frames=4)
    blank = np.zeros_like(seq["images_l"][0])
    frames = frames[:2] + [(blank, blank)] * 3 + frames[2:]
    runs = []
    for graph in (True, False):
        sys_ = System(cfg, device="cuda", graph=graph)
        sys_.max_lost_before_reinit = 2 if method == "step" else 3
        traj = sys_.run(frames) if method == "step" else sys_.run_chunked(frames, chunk=2)
        runs += [sys_, traj]
    _assert_runs_equal(*runs)
    sys_g, traj = runs[:2]
    np.testing.assert_allclose(traj[2:5], np.broadcast_to(traj[1], (3, 4, 4)), atol=1e-5)
    assert sys_g.metrics[-1]["accept"] and sys_g.status == 1
    assert sys_g.state is sys_g.graph.state  # a reinit copies into the buffers


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_replay_launches_tallied_kernels(path):
    """The capture's launches per replay are the path's kernels per step;
    a replay adds exactly those to the counters, and a profiled replay runs
    exactly that many of each kernel. A profiler session that recorded no
    device work is taken again, up to three times (see
    ``test_k3_k4_wrapper_call_is_one_kernel``)."""
    need_cuda()
    vo, per_step = GRAPH_PATHS[path]
    cfg, _, frames = _graph_sequence(vo, n_frames=3)
    sys_ = System(cfg, device="cuda")
    sys_.run(frames[:2])  # init, then the capture and the first replay
    assert sys_.graph.per_replay == per_step
    for fn in COUNTERS:
        fn.launches = 0
    sys_.step(*frames[2])
    assert {fn.__name__: fn.launches for fn in COUNTERS if fn.launches} == per_step
    torch.cuda.synchronize()
    for _ in range(3):
        with profiling.trace(None) as prof:
            sys_.graph.launch()
            torch.cuda.synchronize()
        names = profiling.device_activity(prof)["names"]
        if names:
            break
    want, ran = {}, {}
    for name, n in per_step.items():
        want[KERNEL_NAMES[name]] = want.get(KERNEL_NAMES[name], 0) + n
    for kernel in set(KERNEL_NAMES.values()):
        n = sum(c for op, c in names.items() if kernel in op)
        if n:
            ran[kernel] = n
    assert ran == want, names


def test_graph_rejects_another_shape_or_dtype():
    """A pair of another shape or dtype than the captured one raises; the
    graph still replays the captured shape afterwards."""
    need_cuda()
    cfg, seq, frames = _graph_sequence(SMALL, n_frames=4)
    sys_ = System(cfg, device="cuda")
    sys_.run(frames[:2])
    il, ir = frames[3]
    with pytest.raises(ValueError, match="captured"):
        sys_.step(il[:, :128], ir[:, :128])
    with pytest.raises(ValueError, match="captured"):
        sys_.step(il.astype(np.float64), ir.astype(np.float64))
    with pytest.raises(ValueError, match="pair differs"):
        sys_.step(il, ir[:, :128])
    assert sys_.step(*frames[2])["accept"]


# ---------------------------------------------------------------------- #
# The BA backend (slice 3) on the card.

def _ba_problem(n_kf=6, n_lm=120, seed=7):
    """A window like ``tests/test_ba.py``'s ``make_ba_problem`` (forward
    motion, landmarks 8-40 m ahead, 0.3 px noise, 10% of the observations
    dropped, every second one also seen by a right camera 0.12 m away),
    with perturbed initial poses and landmarks; numpy, no JAX."""
    from stereo_visual_odometry_tpu_torch.ops import se3
    rng = np.random.default_rng(seed)
    poses = np.stack([np.eye(4) for _ in range(n_kf)]).astype(np.float32)
    poses[:, :3, 3] = np.arange(n_kf)[:, None] * np.float32([0.02, -0.01, -0.8])
    pts = np.stack([rng.uniform(-8, 8, n_lm), rng.uniform(-4, 4, n_lm),
                    rng.uniform(8, 40, n_lm)], -1).astype(np.float32)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.12
    kf, lm, uv, right = [], [], [], []
    for k in range(n_kf):
        for r, T in ((False, poses[k]), (True, T_rl @ poses[k])):
            pc = pts @ T[:3, :3].T + T[:3, 3]
            px = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240], -1)
            vis = (px[:, 0] > 0) & (px[:, 0] < 640) & (px[:, 1] > 0) & (px[:, 1] < 480)
            for l in np.nonzero(vis)[0]:
                if r and l % 2:
                    continue
                kf.append(k), lm.append(l), right.append(r)
                uv.append(px[l] + rng.normal(size=2) * 0.3)
    keep = rng.random(len(kf)) > 0.1
    p0 = poses.copy()
    p0[1:] = (se3.se3_exp(torch.from_numpy(rng.normal(size=(n_kf - 1, 6)).astype(np.float32)
                                           * 0.02)) @ torch.from_numpy(poses[1:])).numpy()
    x0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.2
    obs = dict(obs_kf=np.int32(kf)[keep], obs_lm=np.int32(lm)[keep],
               obs_uv=np.float32(uv)[keep], obs_w=np.ones(int(keep.sum()), np.float32),
               obs_right=np.bool_(right)[keep])
    return p0, x0, obs, T_rl


def _ba_call(device, prior=False):
    """``bundle_adjust`` and its arguments on ``device``. With ``prior``, as
    a window slide makes it: keyframe 0 and the first half of the landmarks
    are marginalized (``marg.build_prior`` over their observations), and
    the solve runs on keyframes 1.. and the other landmarks with the prior."""
    from stereo_visual_odometry_tpu_torch.models import ba, marg
    from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole
    p0, x0, obs, T_rl = _ba_problem()
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    cam = Pinhole.create(500.0, 500.0, 320.0, 240.0, device=device)
    table = lambda keep: {k: t(v[keep]) for k, v in obs.items()}
    args = dict(cam=cam, poses=t(p0), points=t(x0), T_rl=t(T_rl))
    if prior:
        dead = obs["obs_lm"] < len(x0) // 2
        built = marg.build_prior(huber_px=2.0, **args, **table(dead))
        args["prior"] = {k: v[:-1, :-1] if k == "H" else v[:-1] for k, v in built.items()}
        live = ~dead & (obs["obs_kf"] >= 1)
        obs = dict(obs, obs_kf=obs["obs_kf"] - 1)
        args.update(poses=t(p0[1:]), **table(live))
    else:
        args.update(table(np.ones(len(obs["obs_kf"]), bool)))
    return ba.bundle_adjust, dict(args, n_iters=8, n_fixed=1, prune_px=8.0)


@pytest.mark.parametrize("prior", [False, True], ids=["plain", "prior"])
def test_bundle_adjust_on_cuda_matches_cpu(prior):
    """The whole GNC + prune schedule (with a marginalization prior) on the
    card against the port on the CPU: the same observations pruned, costs
    within 1e-4 relative, poses within 5e-3 and landmarks within 3e-3
    relative. On the card ``index_add_`` sums with atomics, in another
    order; the fixed-iteration schedule ends on a flat cost surface, where
    the order of the sums alone moves the poses: over 10 reorderings of the
    observation table on the CPU, up to 9.3e-4 (plain) and 2.4e-3 (prior)
    in the poses, 1.3e-3 relative in the landmarks and 4e-6 relative in
    the final cost. The bounds are about twice those."""
    need_cuda()
    fn, kw = _ba_call("cpu", prior)
    want = fn(**kw)
    fn, kw = _ba_call("cuda", prior)
    got = {k: v.cpu() for k, v in fn(**kw).items()}
    np.testing.assert_allclose(got["poses"].numpy(), want["poses"].numpy(), atol=5e-3, rtol=0)
    np.testing.assert_allclose(got["points"].numpy(), want["points"].numpy(),
                               atol=3e-3, rtol=3e-3)
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)
    assert torch.equal(got["obs_w"] > 0, want["obs_w"] > 0)
    assert float(got["cost_final"]) < 0.5 * float(got["cost_initial"])


def test_bundle_adjust_needs_no_host_sync():
    """One solve (with a prior: the ``_ex`` inverse and solves, the LM
    accept/reject on the device) under ``set_sync_debug_mode('error')``:
    any synchronizing call would raise."""
    need_cuda()
    fn, kw = _ba_call("cuda", prior=True)
    fn(**kw)  # warm-up: the first solver calls may load libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(**kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out["poses"]).all())


@pytest.mark.parametrize("graph", [True, False], ids=["graph", "eager"])
def test_system_backend_composes_onto_the_corrected_pose(graph):
    """A ``System`` with a backend on the card: after each solve the live
    state (under the graph its buffer) holds the corrected pose, the
    recorded pose is it, and the next frame composes onto it."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    cfg, _, frames = _graph_sequence(dict(SMALL, persistent_tracks=True), n_frames=10)
    sys_ = System(cfg, device="cuda", graph=graph,
                  backend_cfg=BackendConfig(window=3, kf_every=1, max_landmarks=256,
                                            max_obs=2048, ba_iters=6))
    traj = sys_.run(frames)
    assert (sys_.graph is not None) == graph
    if graph:
        assert sys_.state is sys_.graph.state
    checked = 0
    for i, m in enumerate(sys_.metrics[:-1]):
        nxt = sys_.metrics[i + 1]
        if "ba" not in m or not nxt["accept"]:
            continue
        fresh = traj[i + 1] if "ba" not in nxt else \
            np.linalg.inv(nxt["ba"]["correction"]) @ traj[i + 1]
        np.testing.assert_allclose(fresh, traj[i] @ np.linalg.inv(nxt["T_21"]), atol=1e-4)
        assert np.abs(m["ba"]["correction"] - np.eye(4)).max() > 1e-6
        checked += 1
    assert checked >= 5
    assert "ba" in sys_.metrics[-1]
    np.testing.assert_allclose(sys_.state["T_wc"].cpu().numpy(), traj[-1].astype(np.float32))


# ---- slice 4: the sequence axis, the batched step graph, NCCL -------------- #

@pytest.mark.parametrize("name", list(BATCHED))
def test_batched_entry_equals_b1_calls(name):
    """A batched call at B = 3 is one launch counted and equals the three B =
    1 calls bit for bit: the same per-point arithmetic, on its own
    sequence's image (one device op: ``test_batched_entry_is_one_kernel``)."""
    need_cuda()
    x, pad = _batched_inputs()
    batched, single, counter = BATCHED[name]
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    before = counter.launches
    got = as_tuple(batched(x, pad))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for b in range(3):
        for g, w in zip(got, as_tuple(single(x, pad, b)), strict=True):
            assert torch.equal(g[b], w)


@pytest.mark.parametrize("name", ["K1", "K3"])
def test_batched_wrapper_under_vmap_is_one_launch(name):
    """The wrapper under ``torch.func.vmap`` goes through its op's batch rule:
    one launch for the three sequences, the batched entry's outputs."""
    need_cuda()
    x, pad = _batched_inputs()
    batched, single, counter = BATCHED[name]
    if name == "K1":
        fn = lambda img, c: patch.extract_windows_int(img, c, 24)
        args = (x["prev"], x["corners"])
    else:
        fn = lambda a, b, p, g, m: lk_cell.level_track_cell(a, b, p, g, pad=pad, active=m)
        args = tuple(x[k] for k in ("prev", "nxt", "pts", "guess", "active"))
    before = counter.launches
    got = torch.func.vmap(fn)(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = batched(x, pad)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


def _batched_run(vo_kw, S, n_frames=5, graph=True):
    """S synthetic sequences through ``run_chunk_scan`` on cuda, the batched
    step replayed from its graph or run eagerly; returns (state, metrics,
    the graph or None)."""
    from stereo_visual_odometry_tpu_torch.parallel import sequences
    from stereo_visual_odometry_tpu_torch.utils.config import rig_from_config
    seqs = [synthetic.render_sequence(n_frames=n_frames, h=vo_kw.get("height", 192),
                                      w=vo_kw.get("width", 256), fx=300.0, seed=s)
            for s in range(S)]
    rp = seqs[0]["rig"]
    cam = CameraConfig(fx=300.0, fy=300.0, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    vo = VOConfig(**dict(dict(height=192, width=256, max_features=256, num_hypotheses=128,
                              min_features_track=8, min_inlier_rate=0.3), **vo_kw))
    init, step, _ = sequences.make_batched_frontend(vo, rig_from_config(cam, device="cuda"))
    il = torch.tensor(np.stack([s["images_l"] for s in seqs]), device="cuda")
    ir = torch.tensor(np.stack([s["images_r"] for s in seqs]), device="cuda")
    u = torch.rand(S, n_frames - 1, vo.num_hypotheses, 6, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    state = init(il[:, 0], ir[:, 0])
    state, m = sequences.run_chunk_scan(step, state, il[:, 1:], ir[:, 1:], u, graph=graph)
    return state, m, (step.graph(S) if graph else None)


@pytest.mark.parametrize("vo_kw", [dict(), dict(lk_kernel="cell"), dict(lk_kernel="v1"),
                                   dict(mode="orb", height=128, width=320, orb_levels=4)],
                         ids=["dense", "cell", "v1", "orb"])
def test_batched_graph_replay_equals_eager_vmapped_step(vo_kw):
    """``run_chunk_scan`` replaying the batched step graph against the same
    chunk through the eager vmapped step: outputs and state bit for bit (the
    same kernels on the same inputs and draws)."""
    need_cuda()
    s_g, m_g, _ = _batched_run(vo_kw, 3)
    s_e, m_e, _ = _batched_run(vo_kw, 3, graph=False)
    for k in m_g:
        assert torch.equal(m_g[k], m_e[k]), k
    assert torch.equal(s_g["T_wc"], s_e["T_wc"])
    assert bool(m_g["accept"][-1].all())


def test_batched_graph_launches_per_replay_as_unbatched():
    """K1 per batched replay at S = 4 equals S = 1's (27 on the dense path):
    the batch rule launches once for all sequences."""
    need_cuda()
    counts = {}
    for S in (1, 4):
        _, _, graph = _batched_run({}, S, n_frames=3)
        counts[S] = graph.per_replay
    assert counts[1] == counts[4] == {"extract_windows_int": 27}, counts


def test_distributed_solve_on_nccl_world_size_one():
    """``dist_ba`` on NCCL at world size 1 (a HashStore) against
    ``bundle_adjust`` on the card, with
    ``test_bundle_adjust_on_cuda_matches_cpu``'s tolerances."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models import ba
    from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole
    from stereo_visual_odometry_tpu_torch.parallel import dist_ba, multihost
    from stereo_visual_odometry_tpu_torch.probes import multihost_demo
    multihost.initialize(world_size=1, rank=0, backend="nccl")
    try:
        cam_p, poses_gt, _, table, p0, x0 = multihost_demo.problem(1)
        t = lambda a: torch.as_tensor(np.asarray(a), device="cuda")
        cam = Pinhole.create(*cam_p, device="cuda")
        solve = dist_ba.make_distributed_ba(cam, None, n_kf=len(p0), n_lm=len(x0),
                                            prune_px=8.0)
        got = solve(t(p0), t(x0), *(t(a) for a in table))
        want = ba.bundle_adjust(cam, t(p0), t(x0), *(t(a) for a in table), n_iters=10,
                                n_fixed=1, prune_px=8.0)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(got["poses"].cpu().numpy(), want["poses"].cpu().numpy(),
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(got["points"].cpu().numpy(), want["points"].cpu().numpy(),
                               atol=3e-3, rtol=3e-3)
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)
    assert torch.equal(got["obs_w"] > 0, want["obs_w"] > 0)
    assert float(np.abs(got["poses"].cpu().numpy() - poses_gt).max()) < 0.02


def test_evaluate_batch_defaults_to_cuda():
    """No device given: the card (the trajectories come back, the batched
    step graph was captured on cuda)."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.parallel import evaluate, sequences
    from stereo_visual_odometry_tpu_torch.utils.config import rig_from_config
    seq = synthetic.render_sequence(n_frames=4, h=192, w=256, fx=300.0)
    rp = seq["rig"]
    cam = CameraConfig(fx=300.0, fy=300.0, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    vo = VOConfig(height=192, width=256, max_features=256, num_hypotheses=128,
                  min_features_track=8, min_inlier_rate=0.3)
    il = np.stack([seq["images_l"]] * 2)
    ir = np.stack([seq["images_r"]] * 2)
    sequences.clear()
    rig = rig_from_config(cam, device="cuda")
    out = evaluate.evaluate_batch(il, ir, np.array([4, 3]), vo, rig, chunk=2)
    assert [t.shape for t in out["trajectories"]] == [(4, 4, 4), (3, 4, 4)]
    step = sequences.batched_frontend(vo, rig, 2)[1]
    assert step.device.type == "cuda" and step.graph(2).per_replay
    assert min(out["accept_rate"]) >= 0.5


# ---- slice 5: the command line, the online feed, checkpoint/resume ------------ #

def _kitti_dir(root, n_frames):
    """The bench scene's first frames at KITTI's 376x1241 as 8-bit PNGs, its
    pose file and a reference-format YAML with its camera (``VOConfig``'s
    defaults otherwise); returns (the YAML's path, the frames edge-padded to
    the command line's 384x1248)."""
    from PIL import Image
    from stereo_visual_odometry_tpu_torch.utils import trajectory
    from stereo_visual_odometry_tpu_torch.utils.kitti import pad_to
    seq = synthetic.render_sequence(n_frames=n_frames, h=376, w=1241, fx=718.856,
                                    baseline=0.537, n_points=9000, speed=1.1, seed=3)
    for sub, key in (("image_0", "images_l"), ("image_1", "images_r")):
        (root / sub).mkdir(parents=True)
        for i, img in enumerate(seq[key].astype(np.uint8)):
            Image.fromarray(img).save(root / sub / f"{i:06d}.png")
    trajectory.save_kitti(str(root / "poses.txt"), seq["poses_gt"])
    (root / "cfg.yaml").write_text(
        "%YAML:1.0\ncamera1.fx: 718.856\ncamera1.fy: 718.856\ncamera1.cx: 620.5\n"
        "camera1.cy: 188.0\nt_lr0: -0.537\ntrack_mode: LK_stereof2f_pnp\n"
        "iterationsCount: 256\n")
    frames = [(pad_to(l, 384, 1248), pad_to(r, 384, 1248))
              for l, r in zip(seq["images_l"].astype(np.uint8), seq["images_r"].astype(np.uint8))]
    return str(root / "cfg.yaml"), frames


@pytest.mark.parametrize("overlays", [False, True])
def test_cli_at_kitti_shape_counts_k1(tmp_path, monkeypatch, overlays):
    """``cli.main`` on a KITTI directory runs on the card at 384x1248 (the
    images' static shape), replaying the step graph with K1 counted 1 + 27
    per tracked frame, and gives ``System.run``'s trajectory on the decoded
    frames bit for bit, with the overlay dump on or off."""
    need_cuda()
    import dataclasses
    from stereo_visual_odometry_tpu_torch import cli
    from stereo_visual_odometry_tpu_torch.models import system as system_mod
    n = 8
    yaml, frames = _kitti_dir(tmp_path / "seq", n)
    made = []
    run = system_mod.System.run

    def spy(self, *a, **kw):
        made.append((self, run(self, *a, **kw)))
        return made[-1][1]
    monkeypatch.setattr(system_mod.System, "run", spy)
    args = [yaml, "--dataset", str(tmp_path / "seq"), "--gt", str(tmp_path / "seq/poses.txt")]
    if overlays:
        args += ["--dump-overlays", str(tmp_path / "ovl"), "--every", "2"]
    patch.extract_windows_int.launches = 0
    assert cli.main(args) == 0
    assert patch.extract_windows_int.launches == 1 + 27 * (n - 1)
    (sys_, traj), = made
    assert (sys_.vo_cfg.height, sys_.vo_cfg.width) == (384, 1248)
    assert sys_.graph is not None and sys_.graph.per_replay == {"extract_windows_int": 27}
    assert ("tracked_prev" in sys_.metrics[2]) == overlays
    monkeypatch.setattr(system_mod.System, "run", run)
    cfg = dataclasses.replace(sys_.config, overlay_dir="")
    assert np.array_equal(traj, System(cfg, device="cuda").run(frames))


def test_online_worker_captures_the_graph_and_equals_run():
    """``OnlineVO`` on cuda: the worker makes the card current, its first
    tracked step captures the graph there, and the trajectory equals
    ``System.run``'s bit for bit; after ``close()`` the worker is gone."""
    need_cuda()
    import time
    from stereo_visual_odometry_tpu_torch.models.online import OnlineVO
    cfg, seq, frames = _graph_sequence(SMALL)
    sys_ = System(cfg, device="cuda")
    vo = OnlineVO(sys_, slop=0.02)
    results, deadline = [], time.time() + 300
    try:
        for i, (l, r) in enumerate(frames):
            vo.push_right(0.1 * i + 0.003, r)
            vo.push_left(0.1 * i, l)
        while len(results) < len(frames) and time.time() < deadline:
            got = vo.poll(timeout=1.0)
            if got is not None:
                results.append(got)
    finally:
        vo.close()
    assert not vo._worker.is_alive() and vo.dropped == 0 and len(results) == len(frames)
    assert sys_.graph.key is not None  # captured, on the worker: no other thread stepped
    assert np.array_equal(np.stack(sys_.poses), System(cfg, device="cuda").run(frames))


def test_checkpoint_saved_on_cuda_loads_on_cpu_and_back(tmp_path):
    """A checkpoint of a cuda ``System`` (the graph's buffers, persistent
    tracks, the backend after its first slide) loads into a CPU ``System``
    and, saved again there, back into a cuda one: the state's leaves, the
    poses and the prior come back exact; under the graph ``load`` writes the
    graph's own buffers. The generator's state stays on its device type
    (the CPU's and CUDA's generators are other algorithms)."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    from stereo_visual_odometry_tpu_torch.utils import checkpoint
    from stereo_visual_odometry_tpu_torch.utils.tree import tree_pairs
    cfg, _, frames = _graph_sequence(dict(SMALL, persistent_tracks=True), n_frames=9)
    bcfg = BackendConfig(window=3, kf_every=2, max_landmarks=128, max_obs=1024, ba_iters=4)
    src = System(cfg, device="cuda", backend_cfg=bcfg)
    src.run(frames)
    assert src.backend.prior is not None and src.state is src.graph.state
    checkpoint.save(str(tmp_path / "cuda.npz"), src)
    cpu = System(cfg, device="cpu", backend_cfg=bcfg)
    cpu.step(*frames[0])
    checkpoint.load(str(tmp_path / "cuda.npz"), cpu)
    checkpoint.save(str(tmp_path / "cpu.npz"), cpu)
    back = System(cfg, device="cuda", backend_cfg=bcfg)
    back.step(*frames[0])
    buffers = back.state
    checkpoint.load(str(tmp_path / "cpu.npz"), back)
    assert back.state is buffers is back.graph.state  # written in place
    for sys_ in (cpu, back):
        pairs = tree_pairs(src.state, sys_.state)
        assert len(pairs) > 10
        for path, a, b in pairs:
            assert b.device.type == sys_.device.type and torch.equal(a.cpu(), b.cpu()), path
        np.testing.assert_array_equal(np.stack(sys_.poses), np.stack(src.poses))
        for k, v in src.backend.prior.items():
            np.testing.assert_array_equal(sys_.backend.prior[k], v)
        assert sys_.backend._last_kf_n_tracked == src.backend._last_kf_n_tracked
    assert torch.equal(back.generator.get_state(),
                       torch.Generator(device="cuda").manual_seed(cfg.seed).get_state())
    back.step(*frames[-1])  # the next replay reads the loaded buffers
    assert back.frame_idx == src.frame_idx + 1


def test_bench_gpu_parity_launches_k1_k2_k3():
    """``probes/bench.py``'s kernel parity block on the bench's first pair:
    ok (K2 within 2e-3 of the bilinear sampler, LK on K1 and K3 within a
    median 0.05 px of the XLA formulation on >= 30 points, BRIEF bits equal
    to float64's), with each of the three kernels launched."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.probes import bench

    il, ir, _ = bench.make_frames(n_frames=2)
    counted = (patch.extract_windows_int, patch.extract_patches, lk_cell.level_track_cell)
    before = [fn.launches for fn in counted]
    res = bench.run_gpu_parity(il, ir)
    torch.cuda.synchronize()
    assert res["ok"] is True, res
    assert res["n_points_compared"] >= 30 and res["per_kernel"]["cell"]["n"] >= 30
    assert all(fn.launches > b for fn, b in zip(counted, before)), res
