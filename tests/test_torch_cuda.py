"""Card-only tests of the port: the CUDA kernels K1-K8 and RANSAC-PnP's
three (``csrc/pnp.cu``) against their plain versions, the LK (dense and
cell) and ORB slices on cuda against the same slices on the CPU, and the
step's CUDA graph (``models/step_graph.py``) against the eager step.

The probes (``probes/``): the bench's kernel parity block, and the parity
checks of ``lk_block``, ``lk_breakdown`` and ``roll``, each launching
exactly its kernels.

The bench sequence at full size (384x1280) through ``System.run_chunked``
on the paths no cell runs and on the bench's flicker and yaw variants,
with their ATE, accept and launch bounds; ``cell``, ``v1`` and ORB two
sequences at a time through ``evaluate_batch``, on one device and over a
``seq`` mesh; the JAX bench's 120-frame BA leg, and ORB with the backend.

Slice 5: the command line at KITTI's shape (384x1248) in each of its modes,
counting the kernels, K1 and K2 exact on the calls it makes, the online
feed's worker capturing the graph, a checkpoint from the card loading on
the CPU and back, and a resume on the card continuing the straight run.

The ``seq`` mesh: two shards on one card, each capturing its own batched
step graph, each bit for bit a single-device run at its batch size.

The BA backend's window solve: eagerly against the CPU, without a host
sync; replayed from its CUDA graph (``models/ba_graph.py``) against the
eager solve, each call's outputs its own, a replay without a host sync,
and a ``System`` capturing once per key.

The evaluator's uploads: chunks prefetched on the copy stream bit for bit
one chunk's run, alone and over two shards; the staging buffers reused
across passes and dropped by ``sequences.clear()``, which frees each
batched step's graph at once.

Marked ``cuda``; each skips without a GPU (decided inside the test). This
file imports neither JAX nor the JAX package, so it runs on a machine with
a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 exact (a copy). K2 exact (the kernel's __fmul_rn / __fmaf_rn
are the plain version's products and exactly emulated fmas). K3-K6:
ok masks >= 99% equal, flows within 1e-3 px for >= 98% of the points both
keep and within eps for all (block sums in another order can stop a point
one iteration earlier or later, which moves it by less than eps); K5 and
K6 are also held to the K3 and K4 kernels. K7 exact (a copy), launched
through its C entry ``svo_roll``; the wrapper refuses bad inputs with a
ValueError. K8's checksums within 1e-4 of their largest value (sums of ~441
products in another order). RANSAC-PnP's kernels against the plain version
on the card: samples, duplicate flags, inlier masks and counts exact, T
within 1e-4 (``test_torch_pnp.py``'s tolerance: float32 Gauss-Newton summed
in another order), each hypothesis's score within 1e-4 relative of the
plain scoring of the same pose, and the chosen hypothesis exact where the
scores leave no near tie; on test data with no residual near a gate. The
slices:
accept flags equal and poses within 1e-3 m / 1e-4, with the same RANSAC
draws fed to both devices — the GPU sums in another order than the CPU
(TF32 is off), nothing else differs. The graph: its replay equals the eager
step on the card bit for bit (the same kernels on the same inputs, the same
draws from the generator), and the launch counts it tallies are the kernels
a profiled replay runs.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.step_graph import KERNELS
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
                                     (384, 1280, 3), (64, 64, 64),
                                     (406, 1302, 64), (406, 1302, 36)])
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


def _entries_used(monkeypatch) -> list:
    """The names of the C entries the wrappers look up from now on."""
    used, real = [], native.entry
    monkeypatch.setattr(native, "entry", lambda name: used.append(name) or real(name))
    return used


@pytest.mark.parametrize("axis", [0, 1])
def test_k7_roll_kernel_matches_reference(axis, monkeypatch):
    """K7 over the probe's grid and amounts -1, the axis length and + 5, and
    on both of its kernels' paths: exact (a copy), each call through the C
    entry ``svo_roll``."""
    need_cuda()
    before = roll.roll.launches
    used = _entries_used(monkeypatch)
    worst = probe_roll.envelope("cuda", extended=True)
    assert roll.roll.launches - before == len(used) > 0 and set(used) == {"svo_roll"}
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
def test_k7_rejects_bad_inputs(bad):
    """The wrapper refuses what the kernel does not take with a ValueError
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
def test_k7_call_is_one_kernel(shape, kernel, monkeypatch):
    """A K7 call launches one kernel (the 16-byte one where the width allows,
    else the one-element one) through its C entry and no other device work
    (the wrapper checks, allocates and launches on the host), by the
    profiler's count."""
    need_cuda()
    x = torch.rand(*shape, device="cuda")
    a = torch.tensor([[9]], dtype=torch.int32, device="cuda")
    used = _entries_used(monkeypatch)
    roll.roll(x, a, 0)
    torch.cuda.synchronize()
    assert used == ["svo_roll"]  # the C entry, not torch.roll
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
    """Two level calls agree: ok masks >= 99% equal, flows within 1e-3 px for
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
    results match the plain version under ``_assert_level_calls_agree``'s
    criteria."""
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
    and the K4 kernel under ``_assert_level_calls_agree``'s criteria (every
    point tracked: K6 takes no mask)."""
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
    ``_assert_level_calls_agree``'s criteria."""
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


# ---- RANSAC-PnP's kernels (csrc/pnp.cu) --------------------------------- #

def _pnp_inputs(S, n, H, seed=0, n_valid=None, dup=False):
    """``probes/pnp_timing.problem``: S PnP problems of n points on the card,
    0.05 px of noise and 20% outliers 5-50 px off (none near LK's 0.5 px or
    ORB's 2 px gate), ``T_init`` near the motion, ORB's weights."""
    from stereo_visual_odometry_tpu_torch.probes import pnp_timing
    return pnp_timing.problem(S, n, H, seed=seed, n_valid=n_valid, dup=dup)


def _pnp_cam():
    from stereo_visual_odometry_tpu_torch.probes import pnp_timing
    return pnp_timing.camera()


def _pnp_fn(cam, H, init, orb, refine_iters=6):
    """``ransac_pnp`` on one sequence's (pts, px, valid, u, T_init, weights)."""
    kw = dict(num_hypotheses=H, inlier_px=2.0 if orb else 0.5, refine_iters=refine_iters)
    return lambda p, q, v, u, ti, w: tpnp.ransac_pnp(
        cam, p, q, v, u=u, T_init=ti if init else None, weights=w if orb else None, **kw)


_PNP_ARGS = ("pts", "px", "valid", "u", "T_init", "weights")


def _pnp_plain(cam, x, s, H, init, orb, refine_iters=6):
    """The plain version on the card, sequence s, with its stages."""
    return tpnp.ransac_pnp_reference(
        cam, x["pts"][s], x["px"][s], x["valid"][s], x["u"][s], 2.0 if orb else 0.5,
        refine_iters, x["T_init"][s] if init else None, x["weights"][s] if orb else None,
        stages=True)


def _pnp_stages(cam, x, init, orb, refine_iters=6):
    """The kernels on the whole stack through ``pnp.launch``, with the
    stages: a dict of ``OUTPUTS`` and ``STAGE_OUTPUTS``."""
    out = tpnp.launch(cam.fx, cam.fy, cam.cx, cam.cy, x["pts"], x["px"], x["valid"], x["u"],
                      x["T_init"] if init else None, x["weights"] if orb else None,
                      2.0 if orb else 0.5, refine_iters, stages=True)
    return dict(zip(tpnp.OUTPUTS + tpnp.STAGE_OUTPUTS, out))


def _assert_pnp_matches_plain(got, want, s, compare_T=True):
    """Sequence s of the kernels' outputs and stages against the plain
    version's: samples, duplicate flags, inliers and counts exact, T within
    1e-4; the scores of the kernels' own hypotheses as the plain version
    scores them (within 1e-4 relative, inf alike); the chosen hypothesis the
    first lowest of the kernels' scores, and the plain version's own where
    its lowest score leads the next by 0.1% and the kernels' hypothesis
    scores the same."""
    assert torch.equal(got["samp_idx"][s].long(), want["samp_idx"])
    assert torch.equal(got["samp_dup"][s], want["samp_dup"])
    assert int(got["best"][s]) == int(torch.argmin(got["msac"][s]))
    w = want["msac"]
    order = torch.argsort(w)
    p = int(order[0])
    if (len(w) > 1 and torch.isfinite(w[p]) and w[order[1]] > w[p] * 1.001
            and torch.isclose(got["msac"][s][p], w[p], rtol=1e-4)):
        assert int(got["best"][s]) == p
    if compare_T:
        torch.testing.assert_close(got["T"][s], want["T"], atol=1e-4, rtol=0, equal_nan=True)
    assert torch.equal(got["inliers"][s], want["inliers"])
    assert int(got["num_inliers"][s]) == int(want["num_inliers"])
    assert bool(got["ok"][s]) == bool(want["ok"])
    assert float(got["inlier_ratio"][s]) == float(want["inlier_ratio"])


# name -> (S, N, H, T_init given, ORB's weights and gate)
PNP_CASES = {"lk_s1": (1, 1024, 256, True, False),
             "lk_s1_h128_no_init": (1, 1024, 128, False, False),
             "orb_s1": (1, 2048, 256, True, True),
             "lk_s11": (11, 1024, 256, True, False),
             "orb_s11_h128_no_init": (11, 2048, 128, False, True)}


@pytest.mark.parametrize("case", list(PNP_CASES))
def test_pnp_kernels_match_the_plain_version(case):
    """The wrapper on CUDA tensors (S = 1 directly, S = 11 under
    ``torch.func.vmap`` through the op's batch rule) launches the three
    kernels once for all S, and matches the plain version on the card
    sequence by sequence (``_assert_pnp_matches_plain``); every sequence
    finds the true motion."""
    need_cuda()
    S, n, H, init, orb = PNP_CASES[case]
    x = _pnp_inputs(S, n, H, seed=len(case))
    cam = _pnp_cam()
    fn = _pnp_fn(cam, H, init, orb)
    args = [x[k] for k in _PNP_ARGS]
    before = tpnp.ransac_pnp.launches
    if S == 1:
        got = {k: v[None] for k, v in fn(*(a[0] for a in args)).items()}
    else:
        got = torch.func.vmap(fn)(*args)
    torch.cuda.synchronize()
    assert tpnp.ransac_pnp.launches == before + tpnp.STAGES
    stages = _pnp_stages(cam, x, init, orb)
    for k in tpnp.OUTPUTS:
        assert torch.equal(stages[k], got[k]), k
    thr2 = (2.0 if orb else 0.5) ** 2
    for s in range(S):
        want = _pnp_plain(cam, x, s, H, init, orb)
        weights = x["weights"][s] if orb else torch.ones_like(x["weights"][s])
        rescored, _ = tpnp.msac_scores(cam, stages["T_hyp"][s], x["pts"][s], x["px"][s],
                                       x["valid"][s], weights, thr2, stages["samp_dup"][s])
        finite = torch.isfinite(rescored)
        assert torch.equal(finite, torch.isfinite(stages["msac"][s]))
        torch.testing.assert_close(stages["msac"][s][finite], rescored[finite], rtol=1e-4,
                                   atol=1e-4)
        _assert_pnp_matches_plain(stages, want, s)
        torch.testing.assert_close(got["T"][s], x["T_gt"][s], atol=2e-2, rtol=0)
        assert bool(got["ok"][s])


def test_pnp_kernels_repeat_and_replay_bit_for_bit():
    """Two calls give the same bits; a call captured in a CUDA graph is three
    kernel nodes and nothing else, at S = 1 and at S = 11 under vmap, and its
    replays equal the eager calls bit for bit, on the captured draws and on
    new ones copied in."""
    need_cuda()
    cam = _pnp_cam()
    fn = _pnp_fn(cam, 256, True, True)
    for S in (1, 11):
        x = _pnp_inputs(S, 2048, 256, seed=S)
        args = [x[k] if S > 1 else x[k][0] for k in _PNP_ARGS]
        call = (lambda: fn(*args)) if S == 1 else (lambda: torch.func.vmap(fn)(*args))
        a, b = call(), call()
        for k in tpnp.OUTPUTS:
            assert torch.equal(a[k], b[k]), k
        assert _graph_node_types(call) == [0] * tpnp.STAGES
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for step in range(2):
            if step:
                args[3].copy_(torch.rand_like(args[3]))
            graph.replay()
            torch.cuda.synchronize()
            want = call()
            for k in tpnp.OUTPUTS:
                assert torch.equal(out[k], want[k]), (S, step, k)


# name -> (n_valid, duplicate samples, T_init given, T compared)
PNP_EDGES = {"few_valid": (4, False, True, True),
             "none_valid": (0, False, True, True),
             "none_valid_no_init": (0, False, False, True),
             "duplicates": (None, True, True, True),
             "duplicates_no_init": (None, True, False, False)}


@pytest.mark.parametrize("edge", list(PNP_EDGES))
def test_pnp_kernels_edge_cases(edge):
    """Fewer than 6 valid points, none at all, and every sample a repeat,
    with and without ``T_init``: the kernels against the plain version on
    the card as in ``test_pnp_kernels_match_the_plain_version``. Every
    hypothesis then scores inf but ``T_init``, which wins; without it the
    first hypothesis wins, whose pose a repeated sample leaves undetermined
    (each version's own rounding picks one), so there T is not compared."""
    need_cuda()
    n_valid, dup, init, compare_T = PNP_EDGES[edge]
    x = _pnp_inputs(2, 1024, 128, seed=5, n_valid=n_valid, dup=dup)
    cam = _pnp_cam()
    stages = _pnp_stages(cam, x, init, False)
    for s in range(2):
        want = _pnp_plain(cam, x, s, 128, init, False)
        assert bool(stages["samp_dup"][s].all())
        assert int(stages["best"][s]) == (128 if init else 0)
        _assert_pnp_matches_plain(stages, want, s, compare_T=compare_T)
        if n_valid == 0:
            assert not bool(stages["inliers"][s].any()) and not bool(stages["ok"][s])
        if n_valid == 0 and init:
            assert torch.equal(stages["T"][s], x["T_init"][s])


def test_pnp_launch_rejects_bad_inputs():
    """``pnp.launch`` raises a ValueError, and launches nothing, on a dtype,
    shape or device it cannot take."""
    need_cuda()
    cam = _pnp_cam()
    x = {k: v[0] for k, v in _pnp_inputs(1, 64, 16).items()}
    good = dict(pts3d=x["pts"], px=x["px"], valid=x["valid"], u=x["u"], T_init=x["T_init"],
                weights=x["weights"])
    bad = [dict(pts3d=x["pts"].double()), dict(valid=x["valid"].float()),
           dict(px=x["px"][:10]), dict(u=x["u"][:, :5]), dict(T_init=x["T_init"][:3]),
           dict(weights=x["weights"].cpu()), dict(pts3d=x["pts"][:0], px=x["px"][:0],
                                                  valid=x["valid"][:0],
                                                  weights=x["weights"][:0])]
    before = tpnp.ransac_pnp.launches
    for change in bad:
        kw = dict(good, **change)
        with pytest.raises(ValueError):
            tpnp.launch(cam.fx, cam.fy, cam.cx, cam.cy, kw["pts3d"], kw["px"], kw["valid"],
                        kw["u"], kw["T_init"], kw["weights"], 0.5, 6)
    with pytest.raises(ValueError):
        tpnp.launch(cam.fx.cpu(), cam.fy, cam.cx, cam.cy, *good.values(), 0.5, 6)
    assert tpnp.ransac_pnp.launches == before


# ---- slice 4's batched entries (their one-kernel test with the others) ---- #

# probe -> its parity check on the card and the launches that check makes.
PROBE_CHECKS = {
    "lk_block": dict(level_track_cell=1, level_track_v1=1, level_track_block=1,
                     level_track_v2=1),
    "lk_breakdown": dict(level_track_block_split=len(lk_breakdown.VARIANTS)),
    "roll": dict(roll=2 * len(probe_roll.ROWS) * 5),
}


@pytest.mark.parametrize("probe", list(PROBE_CHECKS))
def test_probe_check_passes_and_launches_exactly_its_kernels(probe):
    """The probes' own parity checks on the card: ``lk_block`` (K5 against
    K3 and K6 against K4 on the probes' pair moved by (3, 2) px: ok agree on
    >= 99% of the points, flows within 0.01 px, median error to the true
    shift < 0.05 px), ``lk_breakdown`` (K8's split variants within 1e-4
    relative of their plain versions) and ``roll`` (the K7 envelope,
    exact); each launching exactly its kernels, every other count 0."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.probes import lk_block as probe_block
    inputs = probe_block.make_inputs("cuda") if probe != "roll" else None
    _reset_counters()
    if probe == "lk_block":
        for new, p in probe_block.parity(inputs).items():
            assert p["ok_agree"] >= 0.99 and p["max_flow_diff"] <= 0.01, (new, p)
            assert p["median_err"] < 0.05, (new, p)
    elif probe == "lk_breakdown":
        for label, r in lk_breakdown.check(inputs).items():
            assert label == "full" or r["rel_err"] <= 1e-4, (label, r["rel_err"])
    else:
        assert all(err == 0.0 for _, _, err in probe_roll.envelope("cuda"))
    torch.cuda.synchronize()
    launches = _launches()
    assert launches == dict(dict.fromkeys(launches, 0), **PROBE_CHECKS[probe])


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
            lk_cell.level_track_cell, lk_v1.level_track_v1, tpnp.ransac_pnp)


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
    assert n_c == [0] * len(COUNTERS)
    assert [m["accept"] for m in s_g.metrics] == [m["accept"] for m in s_c.metrics]
    np.testing.assert_allclose(t_g[:, :3, 3], t_c[:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_g[:, :3, :3], t_c[:, :3, :3], atol=1e-4, rtol=0)
    return n_g


def test_slice_on_cuda_matches_cpu(monkeypatch):
    need_cuda()
    seq = synthetic.render_sequence(n_frames=8, h=192, w=256, fx=300.0)
    vo = VOConfig(height=192, width=256, max_features=256, num_hypotheses=128,
                  min_features_track=8, min_inlier_rate=0.3)
    assert _slice_on_both_devices(monkeypatch, seq, vo, chunk=4) == [1 + 27 * 7, 0, 0, 0,
                                                                     3 * 7]


def test_cell_slice_on_cuda_matches_cpu(monkeypatch):
    """``lk_kernel='cell'``: 6 K3 launches per tracked frame, K1 only for
    the subpixel refine (once per frame), PnP's 3 per tracked frame."""
    need_cuda()
    seq = synthetic.render_sequence(n_frames=8, h=192, w=256, fx=300.0)
    vo = VOConfig(height=192, width=256, max_features=256, num_hypotheses=128,
                  min_features_track=8, min_inlier_rate=0.3, lk_kernel="cell")
    assert _slice_on_both_devices(monkeypatch, seq, vo, chunk=4) == [8, 0, 6 * 7, 0, 3 * 7]


def test_orb_slice_on_cuda_matches_cpu(monkeypatch):
    need_cuda()
    seq = synthetic.render_sequence(n_frames=8, h=128, w=320, fx=300.0)
    rng = np.random.default_rng(1)  # sensor noise: no flat regions (test_torch_system.py)
    for k in ("images_l", "images_r"):
        seq[k] = (seq[k] + rng.normal(0, 1.0, seq[k].shape)).astype(np.float32)
    vo = VOConfig(mode="orb", height=128, width=320, max_features=256, orb_levels=4,
                  num_hypotheses=128, min_features_track=8, min_inlier_rate=0.3)
    # Per frame (the init included): two images x 4 levels, one K1 and one K2
    # each; PnP's 3 per tracked frame.
    assert _slice_on_both_devices(monkeypatch, seq, vo, chunk=4) == [8 * 8, 8 * 8, 0, 0, 3 * 7]


SMALL = dict(height=192, width=256, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)
PNP = {"ransac_pnp": tpnp.STAGES}  # every tracked frame's RANSAC-PnP (csrc/pnp.cu)
GRAPH_PATHS = {  # VOConfig, and the kernels one step launches
    "dense": (SMALL, {"extract_windows_int": 27, **PNP}),
    "cell": (dict(SMALL, lk_kernel="cell"),
             {"extract_windows_int": 1, "level_track_cell": 6, **PNP}),
    "v1": (dict(SMALL, lk_kernel="v1"),
           {"extract_windows_int": 1, "level_track_v1": 6, **PNP}),
    "xla": (dict(SMALL, lk_backend="xla"), {"extract_windows_int": 7, **PNP}),
    "no_sweep": (dict(SMALL, lk_sweep=False), {"extract_windows_int": 45, **PNP}),
    "not_predictive": (dict(SMALL, lk_predictive=False), {"extract_windows_int": 61, **PNP}),
    "orb": (dict(SMALL, mode="orb", height=128, width=320, orb_levels=4),
            {"extract_windows_int": 8, "extract_patches": 8, **PNP}),
    "lk_persistent": (dict(SMALL, persistent_tracks=True), {"extract_windows_int": 27, **PNP}),
    "orb_persistent": (dict(SMALL, mode="orb", height=128, width=320, orb_levels=4,
                            persistent_tracks=True),
                       {"extract_windows_int": 8, "extract_patches": 8, **PNP}),
}
KERNEL_NAMES = {"extract_windows_int": "extract_windows_int_kernel",  # counter -> kernel
                "extract_patches": "extract_patches_kernel",
                "level_track_cell": "lk_level_kernel", "level_track_v1": "lk_level_kernel",
                "ransac_pnp": "pnp_"}  # pnp_{hypotheses,score,polish}_kernel


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
# The bench sequence (``probes/lk_timing.bench_sequence``: 376x1241
# edge-padded to 384x1280, KITTI 00's camera, seed 3) through
# ``System.run_chunked`` on the step graph, on the paths no cell runs.

# path -> (VOConfig fields beside the bench's, frames, chunk, {counter: (launches
# at the first frame, per tracked frame)}, ATE bound (m), the first frame the
# ATE is aligned from, least accept rate). The kernel-free branches run 16
# frames; without the sweep the first step has no prior and is rejected (in
# the JAX package too), so their ATE is aligned from frame 1. Their bounds
# sit above both packages' numbers on the same generator at half this
# resolution (``tests/torch_lk_branch_reference.py``). ``<mode>_flicker`` and
# ``<mode>_yaw`` run the bench's stress variants (``probes/bench.py``'s
# ``STRESS_VARIANTS``) with the shipping config; their bounds are twice the
# JAX reference's TPU ATE on them, never below the clean row's.
PNP_FRAMES = {"ransac_pnp": (0, tpnp.STAGES)}  # none at the first frame
LK_FRAMES = {"extract_windows_int": (1, 27), **PNP_FRAMES}
ORB_FRAMES = {"extract_windows_int": (16, 16), "extract_patches": (16, 16), **PNP_FRAMES}
BENCH_PATHS = {
    "cell": (dict(lk_kernel="cell"), 49, 16,
             {"extract_windows_int": (1, 1), "level_track_cell": (0, 6), **PNP_FRAMES}, 0.05,
             0, 0.95),
    "v1": (dict(lk_kernel="v1"), 49, 16,
           {"extract_windows_int": (1, 1), "level_track_v1": (0, 6), **PNP_FRAMES}, 0.05, 0,
           0.95),
    "xla": (dict(lk_backend="xla"), 16, 8, {"extract_windows_int": (1, 7), **PNP_FRAMES}, 0.15,
            1, 0.9),
    "no_sweep": (dict(lk_sweep=False), 16, 8, {"extract_windows_int": (1, 45), **PNP_FRAMES},
                 0.15, 1, 0.9),
    "not_predictive": (dict(lk_predictive=False), 16, 8,
                       {"extract_windows_int": (1, 61), **PNP_FRAMES}, 0.15, 1, 0.9),
    "lk_persistent": (dict(persistent_tracks=True), 49, 16, LK_FRAMES, 0.05, 0, 0.95),
    "orb_persistent": (dict(mode="orb", max_features=2048, persistent_tracks=True), 49, 16,
                       ORB_FRAMES, 0.07, 0, 0.95),
    "lk_flicker": (dict(), 49, 16, LK_FRAMES, 0.097, 0, 0.95),
    "lk_yaw": (dict(), 49, 16, LK_FRAMES, 0.05, 0, 0.95),
    "orb_flicker": (dict(mode="orb", max_features=2048), 49, 16, ORB_FRAMES, 0.132, 0, 0.95),
    "orb_yaw": (dict(mode="orb", max_features=2048), 49, 16, ORB_FRAMES, 0.144, 0, 0.95),
}


@pytest.fixture(scope="module")
def bench():
    """The first 49 bench pairs (numpy, padded), their true poses, the
    camera."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.probes import lk_timing
    il, ir, poses_gt, cam = lk_timing.bench_sequence(49)
    return list(zip(il, ir)), poses_gt, cam


@pytest.fixture(scope="module")
def stress_frames():
    """variant -> the bench's 49 pairs rendered with that stress variant
    (``probes/bench.py``'s ``make_frames``) and their true poses, each
    rendered on first use."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.probes import bench as probe_bench
    made = {}

    def get(variant):
        if variant not in made:
            il, ir, poses_gt = probe_bench.make_frames(**probe_bench.STRESS_VARIANTS[variant])
            made[variant] = list(zip(il, ir)), poses_gt
        return made[variant]
    return get


def _reset_counters():
    for fn in KERNELS:
        fn.launches = 0


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


@pytest.mark.parametrize("path", list(BENCH_PATHS))
def test_path_on_the_bench_sequence(path, bench, stress_frames):
    """A path through ``System.run_chunked`` on the step graph at the bench's
    full size: the trajectory finite, the ATE and the accept rate inside the
    path's bounds, each kernel it uses launched, and the launch counts
    exactly the path's (every other kernel 0): on the stress variants
    always, elsewhere without a reinit."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.probes.bench import STRESS_VARIANTS
    from stereo_visual_odometry_tpu_torch.utils import trajectory
    fields, n, chunk, per_frame, max_ate, ate_from, min_accept = BENCH_PATHS[path]
    frames, poses_gt, cam = bench
    variant = path.partition("_")[2]
    if variant in STRESS_VARIANTS:
        frames, poses_gt = stress_frames(variant)
    frames, poses_gt = frames[:n], poses_gt[:n]
    vo = VOConfig(**{**dict(height=384, width=1280, max_features=1024), **fields})
    sys_ = System(RunConfig(camera=cam, vo=vo), device="cuda")
    _reset_counters()
    traj = sys_.run_chunked(frames, chunk=chunk)
    launches = _launches()
    assert sys_.graph is not None and traj.shape == (n, 4, 4) and np.isfinite(traj).all()
    ate = trajectory.ate_rmse(traj[ate_from:], poses_gt[ate_from:])
    accept = float(np.mean([m["accept"] for m in sys_.metrics if not m["init"]]))
    assert ate < max_ate and accept >= min_accept, (ate, accept)
    want = {name: 0 for name in launches}
    want.update({name: first + per * (n - 1) for name, (first, per) in per_frame.items()})
    assert all(launches[name] > 0 for name in per_frame), launches
    if variant in STRESS_VARIANTS or all(m["n_detected"] >= vo.min_features_detect
                                         for m in sys_.metrics):  # no reinit
        assert launches == want


# The JAX package's ATE (aligned) of ORB with the backend on the 49 bench
# frames, on the CPU (``tests/torch_ba_reference.py orb_bench jax``): its
# marginalization prior degrades ORB (frontend-only 0.0455 m, drop-oldest
# 0.0654). The port is held to 1.5 times that.
ORB_BA_JAX_ATE = 0.4603


@pytest.mark.parametrize("leg", ["lk", "orb"])
def test_ba_leg_on_the_card(leg, bench):
    """``lk``: the JAX bench's BA leg (``probes/ba_leg.py``: 120 frames of a
    yaw-heavy drift scene, LK with persistent tracks, ``System.run``)
    frontend-only, with ``BackendConfig(window=6, kf_every=4)`` and with
    ``marginalize=False``. ATE not aligned, as the JAX leg: frontend-only
    and marginalized below 0.30 m, drop-oldest below 0.45 m, and
    marginalization at most 0.8 x drop-oldest (it carries the slid
    keyframes' information; "marg <= 1.05 x frontend-only", the reference's
    ``improved``, does not hold on the port, whose frontend is the more
    accurate: ROADMAP Queue E); 20-40 solves; K1 launched 1 + 27 per tracked
    frame in each pass. ``orb``: ORB with persistent tracks and the backend
    on the 49 bench frames: >= 2 solves, ATE aligned below 1.5 x the JAX
    package's. In both, no solve ends above 1.001 x its initial cost."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    from stereo_visual_odometry_tpu_torch.probes import ba_leg
    if leg == "orb":
        frames, poses_gt, cam = bench
        vo = VOConfig(mode="orb", height=384, width=1280, max_features=2048,
                      persistent_tracks=True)
        r = ba_leg.run_pass(RunConfig(camera=cam, vo=vo), frames, poses_gt,
                            BackendConfig(window=6, kf_every=4), "cuda", align=True)
        passes = {"orb_ba": r}
        assert len(r["solves"]) >= 2 and r["ate"] < 1.5 * ORB_BA_JAX_ATE, (
            r["ate"], len(r["solves"]))
    else:
        frames, poses_gt, cam = ba_leg.leg_frames()
        cfg = ba_leg.leg_run_config(cam)
        passes = {}
        for label, bcfg in ba_leg.leg_configs():
            _reset_counters()
            passes[label] = r = ba_leg.run_pass(cfg, frames, poses_gt, bcfg, "cuda")
            assert r["traj"].shape == (len(frames), 4, 4) and np.isfinite(r["traj"]).all()
            assert _launches()["extract_windows_int"] == 1 + 27 * (len(frames) - 1), label
            r.pop("system")
            torch.cuda.empty_cache()
        fe, mg, dr = (passes[k]["ate"] for k in ("frontend_only", "ba_marg", "ba_drop_oldest"))
        assert fe < 0.30 and mg < 0.30 and dr < 0.45 and mg <= 0.8 * dr, (fe, mg, dr)
        assert 20 <= len(passes["ba_marg"]["solves"]) <= 40
    for label, r in passes.items():
        for solve in r["solves"]:
            assert float(solve["cost_final"]) <= 1.001 * float(solve["cost_initial"]), label


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
    got = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in fn(**kw).items()}
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


def _assert_solves_close(got, want):
    """``test_bundle_adjust_on_cuda_matches_cpu``'s bounds."""
    got = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    want = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in want.items()}
    np.testing.assert_allclose(got["poses"].numpy(), want["poses"].numpy(), atol=5e-3, rtol=0)
    np.testing.assert_allclose(got["points"].numpy(), want["points"].numpy(),
                               atol=3e-3, rtol=3e-3)
    for k in ("cost_initial", "cost_final"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)
    assert torch.equal(got["obs_w"] > 0, want["obs_w"] > 0)
    assert got["lm_iters"] == want["lm_iters"] and isinstance(got["lm_iters"], int)


@pytest.mark.parametrize("prior", [False, True], ids=["plain", "prior"])
def test_solve_graph_matches_eager(prior):
    """The graphed solve (``models/ba_graph.py``) against ``bundle_adjust``
    eagerly on the card, within ``test_bundle_adjust_on_cuda_matches_cpu``'s
    bounds (``index_add_``'s atomics sum in another order each run): at the
    capturing call and at a replay, one capture, two replays."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models import ba_graph
    fn, kw = _ba_call("cuda", prior)
    want = fn(**kw)
    solve = ba_graph.SolveGraph()
    for _ in range(2):
        _assert_solves_close(solve(**kw), want)
    assert (solve.captures, solve.replays) == (1, 2)


def test_solve_graph_outputs_are_the_callers_own():
    """Two calls with other inputs return other tensors, and the first
    call's outputs stay as they were after the second (a log keeps solves
    by reference); the caller's inputs are left alone."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models import ba_graph
    fn, kw = _ba_call("cuda", prior=True)
    solve = ba_graph.SolveGraph()
    first = solve(**kw)
    kept = {k: v.clone() for k, v in first.items() if isinstance(v, torch.Tensor)}
    moved = dict(kw, points=kw["points"] * 1.02, poses=kw["poses"].clone())
    moved["poses"][1:, :3, 3] += 0.05
    inputs = {k: v.clone() for k, v in moved.items() if isinstance(v, torch.Tensor)}
    second = solve(**moved)
    assert solve.captures == 1
    for k, v in kept.items():
        assert first[k].data_ptr() != second[k].data_ptr(), k
        assert torch.equal(first[k], v), k
    assert not torch.equal(first["points"], second["points"])
    for k, v in inputs.items():
        assert torch.equal(moved[k], v), k
    _assert_solves_close(second, fn(**moved))


def test_solve_graph_replay_needs_no_host_sync():
    """A replay (the copies in, the launch, the clones out) under
    ``set_sync_debug_mode('error')``: any synchronizing call would raise."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models import ba_graph
    _, kw = _ba_call("cuda", prior=True)
    solve = ba_graph.SolveGraph()
    solve(**kw)                          # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = solve(**kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert solve.replays == 2 and bool(torch.isfinite(out["poses"]).all())


def test_system_backend_captures_each_key_once():
    """A ``System`` with a backend on the card (the setup of
    ``test_system_backend_composes_onto_the_corrected_pose``): the backend's
    solve is its ``SolveGraph``, which captures once per key (no prior,
    then a prior), every solve replays and reports ``graphed``, and the
    spans put each capture and replay inside a solve's ``backend.lm``, so
    ``ba_graph_share.ba`` reads 100."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    from vobench import run
    cfg, _, frames = _graph_sequence(dict(SMALL, persistent_tracks=True), n_frames=10)
    sys_ = System(cfg, device="cuda",
                  backend_cfg=BackendConfig(window=3, kf_every=1, max_landmarks=256,
                                            max_obs=2048, ba_iters=6))
    be = sys_.backend
    assert be.solve is be.solve_graph
    rec = profiling.record()
    try:
        sys_.run(frames)
    finally:
        spans = rec.take()
    solves = [m["ba"] for m in sys_.metrics if "ba" in m]
    assert len(solves) >= 5 and all(r["graphed"] for r in solves)
    assert be.solve_graph.captures == 2 and be.solve_graph.replays == len(solves)
    assert sorted(dict(k)["prior"] is None for k in be.solve_graph._graphs) == [False, True]
    names = {s["id"]: s["name"] for s in spans}
    for s in spans:
        if s["name"] in ("backend.capture", "backend.replay"):
            assert names[s["parent"]] == "backend.lm", s
    assert sum(s["name"] == "backend.capture" for s in spans) == 2
    assert all(s["device_ms"] > 0 for s in spans if s["name"] == "backend.replay")
    assert run.reader("ba_graph_share.ba")({"spans": spans}) == 100.0


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
    """K1 and PnP per batched replay at S = 4 equal S = 1's (27 and 3 on the
    dense path): the batch rules launch once for all sequences."""
    need_cuda()
    counts = {}
    for S in (1, 4):
        _, _, graph = _batched_run({}, S, n_frames=3)
        counts[S] = graph.per_replay
    assert counts[1] == counts[4] == {"extract_windows_int": 27, **PNP}, counts


def test_prior_solve_with_spans_matches_the_plain_reference():
    """A window solve carrying a marginalization prior, on the card inside
    the backend's spans (``backend.solve`` timed, ``backend.lm``) and under
    ``set_sync_debug_mode("error")`` (no host sync inside the solve), against
    the plain float64 reference (``vobench/reference_ba.py``) on the card, within
    ``tests/test_torch_plain_ba.py``'s tolerances; its accepted steps come
    back as a device tensor and the timed span reads a device time."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models import ba
    from vobench import reference_ba as plain
    from torch_ba_windows import on, window
    kw = dict(on(window(7, outliers=10, prior=True)["kw"], device="cuda"), n_iters=8,
              n_fixed=1, huber_px=2.0, prune_px=8.0)
    ba.bundle_adjust(**kw)               # the first call loads the solver libraries
    torch.cuda.synchronize()
    rec = profiling.record()
    try:
        with profiling.span("backend.solve", timed=True), profiling.span("backend.lm"):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = ba.bundle_adjust(**kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        spans = rec.take()
    want = plain.bundle_adjust(**kw)
    assert want["poses"].is_cuda and want["poses"].dtype == torch.float64
    assert float((got["poses"].double() - want["poses"]).abs().max()) <= 5e-3
    gap = (got["points"].double() - want["points"]).abs()
    assert bool((gap <= 3e-3 * (1.0 + want["points"].abs())).all())
    for k in ("cost_initial", "cost_final"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(float(want[k])), k
    assert torch.equal(got["obs_w"] > 0, want["obs_w"] > 0)
    assert got["lm_accepted"].is_cuda and int(got["lm_iters"]) == want["lm_iters"] == 20
    assert 0 < int(got["lm_accepted"]) <= 20
    assert [s["name"] for s in spans] == ["backend.lm", "backend.solve"]
    assert spans[1]["device_ms"] > 0


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


def _mesh_inputs(n_frames=4, S=4):
    """S synthetic sequences at 192x256 as host arrays, the small LK config
    and its rig on cuda:0."""
    from stereo_visual_odometry_tpu_torch.utils.config import rig_from_config
    seqs = [synthetic.render_sequence(n_frames=n_frames, h=192, w=256, fx=300.0, seed=s)
            for s in range(S)]
    rp = seqs[0]["rig"]
    cam = CameraConfig(fx=300.0, fy=300.0, cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    vo = VOConfig(height=192, width=256, max_features=256, num_hypotheses=128,
                  min_features_track=8, min_inlier_rate=0.3)
    il = np.stack([s["images_l"] for s in seqs]).astype(np.float32)
    ir = np.stack([s["images_r"] for s in seqs]).astype(np.float32)
    return il, ir, vo, rig_from_config(cam, device="cuda:0")


def test_mesh_shards_capture_their_own_graphs_on_one_card():
    """A ``seq`` mesh naming cuda:0 twice: two shards, each with its own
    batched step graph captured on cuda:0 (27 K1 and 3 PnP launches per
    replay, as unsplit),
    its replays bit for bit the eager sharded step on the same draws."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.parallel import sequences
    from stereo_visual_odometry_tpu_torch.parallel.mesh import Mesh
    il, ir, vo, rig = _mesh_inputs()
    two = Mesh((torch.device("cuda", 0),) * 2, "seq")
    init, step, place = sequences.make_batched_frontend(vo, rig, two)
    u = torch.rand(4, il.shape[1] - 1, vo.num_hypotheses, 6, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    runs = {}
    for graph in (True, False):
        state = init(place(il[:, 0]), place(ir[:, 0]))
        runs[graph] = sequences.run_chunk_scan(step, state, place(il[:, 1:]), place(ir[:, 1:]),
                                               u, graph=graph)
    graphs = [s.graph(2) for s in step.shards]
    assert graphs[0] is not graphs[1]
    assert all(g.device == torch.device("cuda", 0) for g in graphs)
    assert [g.per_replay for g in graphs] == [{"extract_windows_int": 27, **PNP}] * 2
    assert graphs[0].count_nodes() == graphs[1].count_nodes() > 0
    for (sg, mg), (se, me) in zip(zip(*runs[True]), zip(*runs[False]), strict=True):
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
        assert torch.equal(sg["T_wc"], se["T_wc"])
    got = sequences.gather(runs[True][0], ("T_wc",))["T_wc"]
    assert got.shape == (4, 4, 4) and np.isfinite(got).all()


def test_mesh_shard_equals_single_device_run(monkeypatch):
    """``evaluate_batch`` over (cuda:0, cuda:0) with S = 4: each shard's
    trajectories and accept rates equal a single-device S = 2 run's on its
    sequences with its draws, bit for bit."""
    need_cuda()
    import types
    from stereo_visual_odometry_tpu_torch.parallel import evaluate, sequences
    from stereo_visual_odometry_tpu_torch.parallel.mesh import Mesh
    il, ir, vo, rig = _mesh_inputs(n_frames=5)
    lengths = np.array([5, 4, 5, 3])
    draws = torch.rand(il.shape[1] - 1, 4, vo.num_hypotheses, 6, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(9))

    def feed(rows):
        frames = iter(draws[:, rows])
        monkeypatch.setattr(evaluate, "pnp", types.SimpleNamespace(
            draw_uniforms=lambda *a, **k: next(frames)))

    sequences.clear()
    feed(slice(0, 4))
    got = evaluate.evaluate_batch(il, ir, lengths, vo, rig, chunk=2,
                                  mesh=Mesh((torch.device("cuda", 0),) * 2, "seq"))
    for half in (slice(0, 2), slice(2, 4)):
        sequences.clear()
        feed(half)
        want = evaluate.evaluate_batch(il[half], ir[half], lengths[half], vo, rig, chunk=2)
        for a, b in zip(got["trajectories"][half], want["trajectories"], strict=True):
            np.testing.assert_array_equal(a, b)
        assert got["accept_rate"][half] == want["accept_rate"]
    assert min(got["accept_rate"]) >= 0.5
    sequences.clear()



# path -> (VOConfig fields beside the bench's, ATE bound (m), {counter:
# (launches at the first frame, per tracked frame)} of one unbatched sequence).
BATCHED_BENCH_PATHS = {
    "cell": (dict(lk_kernel="cell"), 0.05,
             {"extract_windows_int": (1, 1), "level_track_cell": (0, 6), **PNP_FRAMES}),
    "v1": (dict(lk_kernel="v1"), 0.05,
           {"extract_windows_int": (1, 1), "level_track_v1": (0, 6), **PNP_FRAMES}),
    "orb": (dict(mode="orb", max_features=2048), 0.07, ORB_FRAMES),
}


@pytest.mark.parametrize("shards", [1, 2], ids=["one_device", "two_shards"])
@pytest.mark.parametrize("path", list(BATCHED_BENCH_PATHS))
def test_batched_path_on_the_bench_sequence(path, shards, bench):
    """S = 2 copies of the first 16 bench frames through ``evaluate_batch`` on
    the batched step graph (captured first by a 2-frame evaluation), on one
    device or over a ``seq`` mesh of two shards (two cards where there are
    two, else cuda:0 twice), each sequence with draws of its own: every
    trajectory finite, each sequence's ATE and accept rate inside the path's
    bounds, and each shard launching exactly what one unbatched sequence
    launches."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.parallel import evaluate, sequences
    from stereo_visual_odometry_tpu_torch.parallel.mesh import Mesh
    from stereo_visual_odometry_tpu_torch.utils import trajectory
    from stereo_visual_odometry_tpu_torch.utils.config import rig_from_config
    fields, max_ate, per_frame = BATCHED_BENCH_PATHS[path]
    frames, poses_gt, cam = bench
    n, S = 16, 2
    il, ir = (np.stack([f[i] for f in frames[:n]]) for i in (0, 1))
    copies = lambda a, t: np.broadcast_to(a[None, :t], (S, t) + a.shape[1:])
    mesh = None
    if shards == 2:
        cards = torch.cuda.device_count()
        mesh = Mesh(tuple(torch.device("cuda", i if cards >= 2 else 0) for i in range(2)), "seq")
    vo = VOConfig(**{**dict(height=384, width=1280, max_features=1024), **fields})
    rig = rig_from_config(cam, device="cuda:0")
    sequences.clear()
    try:
        evaluate.evaluate_batch(copies(il, 2), copies(ir, 2), np.full(S, 2), vo, rig, mesh=mesh)
        _reset_counters()
        out = evaluate.evaluate_batch(copies(il, n), copies(ir, n), np.full(S, n), vo, rig,
                                      mesh=mesh)
        launches = _launches()
    finally:
        sequences.clear()
        torch.cuda.empty_cache()
    assert all(t.shape == (n, 4, 4) and np.isfinite(t).all() for t in out["trajectories"])
    ates = [trajectory.ate_rmse(t, poses_gt[:n]) for t in out["trajectories"]]
    assert max(ates) < max_ate and min(out["accept_rate"]) >= 0.95, (ates, out["accept_rate"])
    want = {name: 0 for name in launches}
    want.update({name: shards * (first + per * (n - 1))
                 for name, (first, per) in per_frame.items()})
    assert launches == want


@pytest.mark.parametrize("two_shards", [False, True])
def test_evaluate_prefetch_equals_one_chunk(two_shards):
    """``evaluate_batch`` on the card with ``chunk = 2`` (the first chunk
    staged, each later one uploaded on the copy stream while the replays
    before it run, a short last chunk) against ``chunk = T - 1`` (one chunk,
    nothing prefetched): trajectories and accept rates bit for bit, alone
    and over two shards on cuda:0; the two shards against the unsplit run as
    the CPU mesh test holds them (within 1e-5 m)."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.parallel import evaluate, sequences
    from stereo_visual_odometry_tpu_torch.parallel.mesh import Mesh
    il, ir, vo, rig = _mesh_inputs(n_frames=6)
    lengths = np.array([6, 5, 6, 4])
    mesh = Mesh((torch.device("cuda", 0),) * 2, "seq") if two_shards else None
    sequences.clear()
    whole = evaluate.evaluate_batch(il, ir, lengths, vo, rig, chunk=5, mesh=mesh, seed=3)
    got = evaluate.evaluate_batch(il, ir, lengths, vo, rig, chunk=2, mesh=mesh, seed=3)
    for s, (a, b) in enumerate(zip(got["trajectories"], whole["trajectories"], strict=True)):
        assert a.shape == (lengths[s], 4, 4)
        np.testing.assert_array_equal(a, b)
    assert got["accept_rate"] == whole["accept_rate"]
    assert min(got["accept_rate"]) >= 0.5
    if two_shards:
        unsplit = evaluate.evaluate_batch(il, ir, lengths, vo, rig, chunk=2, seed=3)
        assert unsplit["accept_rate"] == got["accept_rate"]
        for a, b in zip(got["trajectories"], unsplit["trajectories"], strict=True):
            np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=1e-5, rtol=0)
    sequences.clear()


def test_evaluate_staging_is_reused_and_cleared():
    """Two passes on the card stage through the same pinned and device
    buffers (one ``Staging``: one pinned host buffer, two device slots, the
    same ``data_ptr``s); ``sequences.clear()`` drops them."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.parallel import evaluate, sequences
    il, ir, vo, rig = _mesh_inputs(n_frames=6, S=2)
    sequences.clear()
    ptrs = []
    for seed in range(2):
        out = evaluate.evaluate_batch(il, ir, np.full(2, 6), vo, rig, chunk=2, seed=seed)
        assert min(out["accept_rate"]) >= 0.5
        (st,) = sequences._staging.values()
        assert st.shape == (2, 2, 192, 256) and st.host.is_pinned()
        assert [b.device for b in st.dev] == [torch.device("cuda", 0)] * 2
        ptrs.append([st.host.data_ptr()] + [b.data_ptr() for b in st.dev])
    assert ptrs[0] == ptrs[1]
    sequences.clear()
    assert not sequences._staging



def test_cleared_batched_step_frees_its_graph_at_once():
    """Three evaluations in turn, each after ``sequences.clear()``, each
    capturing its own graph; ``clear()`` frees each captured graph at once,
    the collector off (a graph the collector frees while another captures
    breaks that capture)."""
    need_cuda()
    import gc
    import weakref
    from stereo_visual_odometry_tpu_torch.parallel import evaluate, sequences
    il, ir, vo, rig = _mesh_inputs(n_frames=6, S=2)
    sequences.clear()
    for seed in range(3):
        out = evaluate.evaluate_batch(il, ir, np.full(2, 6), vo, rig, chunk=2, seed=seed)
        assert min(out["accept_rate"]) >= 0.5
        graph = sequences.batched_frontend(vo, rig, 2)[1].graph(2)
        assert graph.per_replay
        ref = weakref.ref(graph)
        del graph
        gc.disable()
        try:
            sequences.clear()
            assert ref() is None
        finally:
            gc.enable()

# ---- slice 5: the command line, the online feed, checkpoint/resume ------------ #

def _kitti_dir(root, n_frames, mode="lk"):
    """The bench scene's first frames at KITTI's 376x1241 as 8-bit PNGs, its
    pose file and a reference-format YAML with its camera (``VOConfig``'s
    defaults otherwise; ORB at 2048 features); returns (the YAML's path, the
    frames edge-padded to the command line's 384x1248, the true poses)."""
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
    track = "LK_stereof2f_pnp" if mode == "lk" else "ORB_stereof2f_pnp\nnFeatures: 2048"
    (root / "cfg.yaml").write_text(
        "%YAML:1.0\ncamera1.fx: 718.856\ncamera1.fy: 718.856\ncamera1.cx: 620.5\n"
        f"camera1.cy: 188.0\nt_lr0: -0.537\ntrack_mode: {track}\n"
        "iterationsCount: 256\n")
    frames = [(pad_to(l, 384, 1248), pad_to(r, 384, 1248))
              for l, r in zip(seq["images_l"].astype(np.uint8), seq["images_r"].astype(np.uint8))]
    return str(root / "cfg.yaml"), frames, seq["poses_gt"]


# The JAX package's ATE (aligned) on what ``--ba --window 6 --kf-every 4``
# runs on the 49 bench frames, on the CPU (``tests/torch_ba_reference.py
# cli_ba jax``: 11 solves; frontend-only 0.0243 m). The port is held to 1.5
# times that.
CLI_BA_JAX_ATE = 0.14498387788178257
# variant -> (frames, the arguments beside the YAML, --dataset and --gt)
CLI_VARIANTS = {
    "plain": (8, []),
    "overlays": (8, ["--dump-overlays", "{tmp}/ovl", "--every", "2"]),
    "chunked": (49, ["--chunked", "16"]),
    "orb": (49, ["--mode", "orb"]),
    "ba": (49, ["--ba", "--window", "6", "--kf-every", "4"]),
}


@pytest.mark.parametrize("variant", list(CLI_VARIANTS))
def test_cli_at_kitti_shape_counts_k1(tmp_path, monkeypatch, variant):
    """``cli.main`` on a KITTI directory of the bench scene runs on the card at
    384x1248 (the images' static shape), replaying the step graph with K1
    counted 1 + 27 per tracked frame (ORB: K1 and K2 16 per frame) and no
    other kernel, and gives ``System.run``'s (``--chunked 16``:
    ``run_chunked``'s) trajectory on the decoded frames bit for bit, with the
    overlay dump on or off; ``--chunked 16`` on 49 frames: ATE < 0.05 m,
    accept >= 0.95. ``--mode orb`` (2048 features): ATE < 0.07 m, accept >=
    0.95. ``--ba``: >= 2 solves, ATE below 1.5 x the JAX package's."""
    need_cuda()
    import dataclasses
    from stereo_visual_odometry_tpu_torch import cli
    from stereo_visual_odometry_tpu_torch.models import system as system_mod
    from stereo_visual_odometry_tpu_torch.utils import trajectory
    n, extra = CLI_VARIANTS[variant]
    seq = tmp_path / "seq"
    yaml, frames, poses_gt = _kitti_dir(seq, n, mode="orb" if variant == "orb" else "lk")
    want = dict.fromkeys(_launches(), 0)
    want.update(ransac_pnp=tpnp.STAGES * (n - 1))
    if variant == "orb":
        want.update(extract_windows_int=16 * n, extract_patches=16 * n)
    else:
        want.update(extract_windows_int=1 + 27 * (n - 1))
    made = []
    method = "run_chunked" if variant == "chunked" else "run"
    real = getattr(system_mod.System, method)

    def spy(self, *a, **kw):
        made.append((self, real(self, *a, **kw)))
        return made[-1][1]
    monkeypatch.setattr(system_mod.System, method, spy)
    args = [yaml, "--dataset", str(seq), "--gt", str(seq / "poses.txt")]
    args += [a.format(tmp=tmp_path) for a in extra]
    _reset_counters()
    assert cli.main(args) == 0
    assert _launches() == want
    (sys_, traj), = made
    monkeypatch.setattr(system_mod.System, method, real)
    assert (sys_.vo_cfg.height, sys_.vo_cfg.width) == (384, 1248)
    per_replay = ({"extract_windows_int": 16, "extract_patches": 16, **PNP} if variant == "orb"
                  else {"extract_windows_int": 27, **PNP})
    assert sys_.graph is not None and sys_.graph.per_replay == per_replay
    ate, accept = trajectory.ate_rmse(traj, poses_gt), sys_.summary()["accept_rate"]
    if variant == "orb":
        assert (sys_.vo_cfg.mode, sys_.vo_cfg.max_features) == ("orb", 2048)
        assert ate < 0.07 and accept >= 0.95, (ate, accept)
    elif variant == "ba":
        solves = sum("ba" in m for m in sys_.metrics)
        assert solves >= 2 and ate < 1.5 * CLI_BA_JAX_ATE, (solves, ate)
    else:
        assert ("tracked_prev" in sys_.metrics[2]) == (variant == "overlays")
        cfg = dataclasses.replace(sys_.config, overlay_dir="")
        if variant == "chunked":
            assert ate < 0.05 and accept >= 0.95, (ate, accept)
            assert np.array_equal(traj, System(cfg, device="cuda").run_chunked(frames, chunk=16))
        else:
            assert np.array_equal(traj, System(cfg, device="cuda").run(frames))


def test_cli_batch_over_two_directories(tmp_path, capsys):
    """``cli.main --batch`` over two KITTI directories of the bench scene's
    49 frames (S = 2 through the batch evaluator): an ATE line per sequence,
    each written trajectory's ATE < 0.05 m, and K1 launched 1 + 27 per
    tracked frame for the batch, no other kernel."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch import cli
    from stereo_visual_odometry_tpu_torch.parallel import sequences
    from stereo_visual_odometry_tpu_torch.utils import trajectory
    n, seq = 49, tmp_path / "seq"
    yaml, _, poses_gt = _kitti_dir(seq, n)
    shutil.copytree(seq, tmp_path / "seq2")
    gt, out = str(seq / "poses.txt"), tmp_path / "btraj"
    _reset_counters()
    try:
        assert cli.main([yaml, "--batch", str(seq), str(tmp_path / "seq2"), "--batch-gt", gt,
                         gt, "--out", str(out)]) == 0
        assert _launches() == dict(dict.fromkeys(_launches(), 0),
                                   extract_windows_int=1 + 27 * (n - 1),
                                   ransac_pnp=tpnp.STAGES * (n - 1))
    finally:
        sequences.clear()
    assert capsys.readouterr().out.count("ATE=") == 2
    ates = [trajectory.ate_rmse(trajectory.load_kitti(f"{out}.{s:02d}"), poses_gt)
            for s in range(2)]
    assert max(ates) < 0.05, ates


def test_cli_runs_as_a_process(tmp_path):
    """``python -m stereo_visual_odometry_tpu_torch.cli`` on a KITTI directory
    of 8 bench frames: exit 0 and an ATE line."""
    need_cuda()
    seq = tmp_path / "seq"
    yaml, _, _ = _kitti_dir(seq, 8)
    done = subprocess.run([sys.executable, "-m", "stereo_visual_odometry_tpu_torch.cli", yaml,
                           "--dataset", str(seq), "--gt", str(seq / "poses.txt"),
                           "--max-frames", "8"],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0 and "ATE=" in done.stdout, done.stderr[-2000:]


@pytest.mark.parametrize("mode", ["lk", "orb"])
def test_k1_k2_match_reference_on_the_cli_calls(mode, bench, monkeypatch):
    """Every K1 and K2 call of an eager two-frame run at the command line's
    384x1248 (the bench frames as 8-bit KITTI images; LK at 1024 features,
    ORB at 2048), recorded and replayed against the plain versions: exact
    (K2 against both the edge-padded and the clamped plain version)."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.utils.kitti import pad_to
    frames, _, cam = bench
    frames = [(pad_to(l[:376, :1241].astype(np.uint8), 384, 1248),
               pad_to(r[:376, :1241].astype(np.uint8), 384, 1248)) for l, r in frames[:2]]
    vo = VOConfig(mode=mode, height=384, width=1248, max_features=2048 if mode == "orb" else 1024)
    calls = {"extract_windows_int": [], "extract_patches": []}
    for name in calls:
        real = getattr(patch, name)

        def record(*args, name=name, real=real):
            calls[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return real(*args)
        record.launches = 0  # the wrapper counts on the module's name, here this one
        monkeypatch.setattr(patch, name, record)
    System(RunConfig(camera=cam, vo=vo), device="cuda", graph=False).run(frames)
    monkeypatch.undo()
    assert calls["extract_windows_int"] and (mode == "lk") != bool(calls["extract_patches"])
    for img, corners, S in calls["extract_windows_int"]:
        assert torch.equal(patch.extract_windows_int(img, corners, S),
                           patch.extract_windows_int_reference(img, corners, S))
    for img, xy, P in calls["extract_patches"]:
        got, p_pad = patch.extract_patches(img, xy, P), P // 2 + 2
        padded = patch.pad_edge(img, p_pad, p_pad, p_pad, p_pad)
        assert torch.equal(got, patch.extract_patches_reference(padded, xy, P, p_pad))
        assert torch.equal(got, patch.extract_patches_clamped(img, xy, P))


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


@pytest.mark.parametrize("backend", [False, True], ids=["frontend_only", "ba"])
def test_checkpoint_resume_on_cuda_continues_the_run(tmp_path, bench, backend):
    """Persistent LK on 14 bench frames as the command line reads them
    (8-bit, 384x1248), saved after 9 (with ``BackendConfig(window=3,
    kf_every=2)`` after the first window slide, the prior present), loaded
    into a fresh ``System`` on the step graph that runs the other 5:
    frontend-only its poses bit for bit the straight run's; with the backend
    within 5e-3 (the solve sums with atomics) and the same keyframes."""
    need_cuda()
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    from stereo_visual_odometry_tpu_torch.utils import checkpoint
    from stereo_visual_odometry_tpu_torch.utils.kitti import pad_to
    frames, _, cam = bench
    frames = [(pad_to(l[:376, :1241].astype(np.uint8), 384, 1248),
               pad_to(r[:376, :1241].astype(np.uint8), 384, 1248)) for l, r in frames[:14]]
    vo = VOConfig(height=384, width=1248, max_features=1024, persistent_tracks=True)
    bcfg = BackendConfig(window=3, kf_every=2) if backend else None
    make = lambda: System(RunConfig(camera=cam, vo=vo), device="cuda", backend_cfg=bcfg)
    straight, ckpt = make(), str(tmp_path / "state.npz")
    for i, (l, r) in enumerate(frames):
        straight.step(l, r)
        if i == 8:
            checkpoint.save(ckpt, straight)
            assert not backend or straight.backend.prior is not None
    resumed = make()
    resumed.step(*frames[0])
    checkpoint.load(ckpt, resumed)
    for l, r in frames[9:]:
        resumed.step(l, r)
    gap = float(np.abs(np.stack(resumed.poses) - np.stack(straight.poses)).max())
    if backend:
        assert gap <= 5e-3 and resumed.backend.frame_of_kf == straight.backend.frame_of_kf
    else:
        assert gap == 0.0


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
