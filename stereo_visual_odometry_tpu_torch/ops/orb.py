"""ORB: oriented FAST keypoints + rotated-BRIEF binary descriptors, batched.

Port of ``stereo_visual_odometry_tpu/ops/orb.py``: scale pyramid, dense
two-threshold FAST per level, grid top-K and subpixel refinement (K1 at
S=3), one K2 launch per (image, level) for the (N, 39, 39) blurred patches,
intensity-centroid angle, and BRIEF as a matrix product against the
pair-difference sampling matrix, packed to 8 words per descriptor.

Descriptor words are held as int64 tensors with values in [0, 2**32) — the
bit patterns of the JAX package's uint32 words (torch has thin uint32
support); ``ops/match.py`` popcounts them in int64.

Upright BRIEF (``upright=True``, the shipping default) describes every
keypoint at angle 0, so only rotation bin 0's (256, 1521) difference matrix
is computed: one (N, 1521) @ (1521, 256) float32 product. The 32-bin
matrices are built lazily, only when ``upright=False``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fast, orb_pattern, patch, pyramid, select

PATCH = 31
HALF_PATCH = 15
DESC_PATCH = 39  # descriptor sampling patch (learned-pattern radius 18.4
                 # under rotation + bilinear support)
EDGE = 19  # keep-out border for description (``ORBextractor.cpp:19``)
N_BITS = 256
N_WORDS = N_BITS // 32
N_ANGLE_BINS = 32


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """Seeded-Gaussian BRIEF pattern: (256, 2, 2) offsets (pairs of (x, y)),
    sigma PATCH/5 clamped to radius 13. Kept for A/B against the learned
    table (``set_pattern``)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(N_BITS, 2, 2))
    r = 13.0
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(norm > r, pts * (r / norm), pts)
    return np.round(pts).astype(np.float32)


BRIEF_PATTERN = orb_pattern.pattern_pairs()  # (256, 2, 2) [pair, pt, (x, y)]
_CONST: dict[tuple[str, torch.device], torch.Tensor] = {}


def set_pattern(kind: str = "learned") -> None:
    """Select the BRIEF pattern ('learned' | 'gaussian'); drops the cached
    sampling matrices."""
    global BRIEF_PATTERN
    BRIEF_PATTERN = (orb_pattern.pattern_pairs() if kind == "learned"
                     else _make_pattern())
    _CONST.clear()


# Circular-patch mask and coordinate grids for IC_Angle (radius HALF_PATCH).
_yy, _xx = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
_circle = (_xx ** 2 + _yy ** 2) <= HALF_PATCH ** 2
IC_MASK = _circle.astype(np.float32)
IC_X = (_xx * _circle).astype(np.float32)
IC_Y = (_yy * _circle).astype(np.float32)


def _const(name: str, device: torch.device) -> torch.Tensor:
    """A constant array as a tensor on ``device``, made and copied once:
    'ic_x', 'ic_y', 'diff_upright' (bin 0) or 'diff_bins' (all bins)."""
    key = (name, device)
    if key not in _CONST:
        make = {"ic_x": lambda: IC_X, "ic_y": lambda: IC_Y,
                "diff_upright": lambda: _bin_diff_np(True),
                "diff_bins": lambda: _bin_diff_np(False)}[name]
        _CONST[key] = torch.from_numpy(make()).to(device)
    return _CONST[key]


def ic_angle_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation from (N, 31, 31) patches -> (N,) rad:
    atan2(m01, m10) over the circular patch (``IC_Angle``)."""
    m10 = torch.sum(patches * _const("ic_x", patches.device), dim=(1, 2))
    m01 = torch.sum(patches * _const("ic_y", patches.device), dim=(1, 2))
    return torch.atan2(m01, m10)


def ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    return ic_angle_from_patches(patch.extract_patches(img, xy, PATCH))


def _ic_crop(patches: torch.Tensor) -> torch.Tensor:
    """Central (31, 31) view of (N, DESC_PATCH, DESC_PATCH) patches."""
    off = (DESC_PATCH - PATCH) // 2
    return patches[:, off:off + PATCH, off:off + PATCH]


def _make_bin_weights(bins: int = N_ANGLE_BINS) -> np.ndarray:
    """(bins, 512, DESC_PATCH^2) bilinear sampling matrices for the first
    ``bins`` rotation bins (bin b = angle 2*pi*b/N_ANGLE_BINS)."""
    pts = np.asarray(BRIEF_PATTERN).reshape(N_BITS * 2, 2)  # (512, [x, y])
    P = DESC_PATCH
    r = (P - 1) // 2
    out = np.zeros((bins, N_BITS * 2, P * P), np.float32)
    for b in range(bins):
        th = 2 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        rx = c * pts[:, 0] - s * pts[:, 1]
        ry = s * pts[:, 0] + c * pts[:, 1]
        x = np.clip(rx + r, 0, P - 1 - 1e-4)
        y = np.clip(ry + r, 0, P - 1 - 1e-4)
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        fx = x - x0
        fy = y - y0
        for k in range(N_BITS * 2):
            for (dy, dx, w) in ((0, 0, (1 - fy[k]) * (1 - fx[k])),
                                (0, 1, (1 - fy[k]) * fx[k]),
                                (1, 0, fy[k] * (1 - fx[k])),
                                (1, 1, fy[k] * fx[k])):
                out[b, k, (y0[k] + dy) * P + (x0[k] + dx)] += w
    return out


def _bin_diff_np(upright: bool) -> np.ndarray:
    """(B, 256, DESC_PATCH^2) pair-difference matrices: B = 1 (bin 0 alone)
    when upright, else N_ANGLE_BINS.

    Bit k = (s_{2k} < s_{2k+1}) = (flat . (W_{2k+1} - W_{2k}) > 0)."""
    w = _make_bin_weights(1 if upright else N_ANGLE_BINS)
    return w[:, 1::2, :] - w[:, 0::2, :]


def brief_bits_from_patches(patches_blur: torch.Tensor, angle: torch.Tensor | None,
                            ) -> torch.Tensor:
    """(N, DESC_PATCH, DESC_PATCH) blurred patches + (N,) angles -> (N, 256)
    0/1 int32 bits. ``angle=None`` is upright BRIEF: bin 0 alone.

    Each bin's differences are one float32 product ``flat @ D[b].T``; with
    angles, every bin is computed the same way and each point takes its own
    bin's row, so bin 0 of the all-bins result equals the upright result.
    """
    n = patches_blur.shape[0]
    flat = patches_blur.reshape(n, DESC_PATCH * DESC_PATCH)
    if angle is None:
        diffs = flat @ _const("diff_upright", flat.device)[0].T   # (N, 256)
    else:
        D = _const("diff_bins", flat.device)
        two_pi = 2.0 * torch.pi
        bins = torch.round(torch.remainder(angle, two_pi) / two_pi * N_ANGLE_BINS)
        bins = torch.remainder(bins, N_ANGLE_BINS).to(torch.int64)
        diffs_all = torch.stack([flat @ D[b].T for b in range(D.shape[0])], dim=1)
        diffs = torch.take_along_dim(diffs_all, bins[:, None, None], dim=1)[:, 0]
    return (diffs > 0).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) 0/1 -> (N, 8) int64 words in [0, 2**32), little-endian per
    word (the bit patterns of the JAX uint32 words)."""
    n = bits.shape[0]
    words = bits.to(torch.int64).reshape(n, N_WORDS, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return torch.sum(words << shifts, dim=-1)


def brief_from_patches(patches_blur: torch.Tensor,
                       angle: torch.Tensor | None) -> torch.Tensor:
    """(N, DESC_PATCH, DESC_PATCH) blurred patches + (N,) angles (None =
    upright) -> (N, 8) packed words."""
    return pack_bits(brief_bits_from_patches(patches_blur, angle))


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor,
                      angle: torch.Tensor | None) -> torch.Tensor:
    """Rotated BRIEF: (N,) keypoints -> (N, 8) packed descriptors (K2 reads
    the patches)."""
    return brief_from_patches(patch.extract_patches(img_blur, xy, DESC_PATCH), angle)


def _level_budgets(n_features: int, levels: int, scale_factor: float) -> list[int]:
    """Geometric per-level feature budget (``ORBextractor.cpp:383-394``)."""
    inv = 1.0 / scale_factor
    first = n_features * (1 - inv) / (1 - inv ** levels)
    out = []
    acc = 0
    for lvl in range(levels - 1):
        k = int(round(first * inv ** lvl))
        out.append(k)
        acc += k
    out.append(max(n_features - acc, 0))
    return out


def _level_select(level_img: torch.Tensor, budget: int, ph: int, pw: int,
                  ini_th: float, min_th: float, cell: int, k_per_cell: int):
    """Two-threshold FAST on one level, EDGE mask, grid top-K and subpixel
    refinement on the raw score surface -> (xy, score, valid) in level
    coordinates."""
    h, w = level_img.shape
    score_lo = fast.detect(level_img, min_th)
    score = torch.where(score_lo > ini_th, score_lo + 1e4, score_lo)
    score = torch.nn.functional.pad(score, (0, pw - w, 0, ph - h))
    row = torch.arange(ph, device=score.device)[:, None]
    col = torch.arange(pw, device=score.device)[None, :]
    inside = (row >= EDGE) & (row < h - EDGE) & (col >= EDGE) & (col < w - EDGE)
    score = torch.where(inside, score, 0.0)
    xy, sc, valid = select.grid_top_k(score, budget, cell=cell, k_per_cell=k_per_cell)
    sc = torch.where(sc > 1e4, sc - 1e4, sc)  # undo the hi-threshold boost
    raw = torch.nn.functional.pad(score_lo, (0, pw - w, 0, ph - h))
    return select.subpixel_refine(raw, xy, valid), sc, valid


def _describe(blur: torch.Tensor, xy: torch.Tensor, upright: bool):
    """K2 patches of one blurred level -> (angle, descriptors)."""
    patches = patch.extract_patches(blur, xy, DESC_PATCH)
    ang = ic_angle_from_patches(_ic_crop(patches))
    return ang, brief_from_patches(patches, None if upright else ang)


def _detect_and_describe_levels(imgs: list[torch.Tensor], n_features: int,
                                levels: int, scale_factor: float, ini_th: float,
                                min_th: float, cell: int, k_per_cell: int,
                                dedup_radius: float, upright: bool) -> list[dict]:
    """ORB on each image of ``imgs`` (same shape): the pyramid and the blur
    run batched over the images, detection and K2 per image and level."""
    stack = torch.stack([im.to(torch.float32) for im in imgs])
    pyr = pyramid.scale_pyramid(stack, levels, scale_factor)
    budgets = _level_budgets(n_features, levels, scale_factor)
    outs = [[] for _ in imgs]
    for lvl, (level_imgs, budget) in enumerate(zip(pyr, budgets)):
        if budget <= 0:
            continue
        h, w = level_imgs.shape[-2:]
        ph = (h + cell - 1) // cell * cell
        pw = (w + cell - 1) // cell * cell
        blur = pyramid.gaussian_blur(level_imgs)
        lvl_scale = scale_factor ** lvl
        for side, level_img in enumerate(level_imgs):
            xy, sc, valid = _level_select(level_img, budget, ph, pw, ini_th, min_th,
                                          cell, k_per_cell)
            ang, desc = _describe(blur[side], xy, upright)
            outs[side].append({
                "xy": xy * lvl_scale,  # back to level-0 coordinates
                "desc": desc, "angle": ang, "score": sc,
                "level": torch.full((budget,), lvl, dtype=torch.int32,
                                    device=xy.device),
                "valid": valid,
            })
    h0, w0 = imgs[0].shape
    feats = []
    for per_level in outs:
        f = {k: torch.cat([o[k] for o in per_level]) for k in per_level[0]}
        if dedup_radius > 0:
            f["valid"] = select.dedup_by_bin(f["xy"], f["score"], f["valid"],
                                             h0, w0, dedup_radius)
        feats.append(f)
    return feats


def detect_and_describe(img: torch.Tensor, n_features: int = 2000, levels: int = 8,
                        scale_factor: float = 1.2, ini_th: float = 20.0,
                        min_th: float = 7.0, cell: int = 32, k_per_cell: int = 8,
                        dedup_radius: float = 0.0, upright: bool = False) -> dict:
    """Full ORB extraction on one image.

    Returns dict(xy (K, 2) level-0 coords, desc (K, 8) words, angle (K,),
    score (K,), level (K,) int32, valid (K,) bool) with K = n_features.
    """
    return _detect_and_describe_levels(
        [img], n_features, levels, scale_factor, ini_th, min_th, cell,
        k_per_cell, dedup_radius, upright)[0]


def detect_and_describe_pair(img_l: torch.Tensor, img_r: torch.Tensor,
                             n_features: int = 2000, levels: int = 8,
                             scale_factor: float = 1.2, ini_th: float = 20.0,
                             min_th: float = 7.0, cell: int = 32,
                             k_per_cell: int = 8, dedup_radius: float = 0.0,
                             upright: bool = False) -> tuple[dict, dict]:
    """ORB on a stereo pair: the same per-image result as
    ``detect_and_describe``, with the pyramid and blur batched over the pair.
    Two K1 and two K2 launches per level. Returns (feat_l, feat_r)."""
    fl, fr = _detect_and_describe_levels(
        [img_l, img_r], n_features, levels, scale_factor, ini_th, min_th, cell,
        k_per_cell, dedup_radius, upright)
    return fl, fr
