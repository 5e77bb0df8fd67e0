"""The patch kernels: K1 (integer-corner windows) and K2 (bilinear patches).

* K1, port of ``patch_pallas.extract_windows_int``
  (``stereo_visual_odometry_tpu/ops/patch_pallas.py:167-183``): the LK
  window reads (square, or (Sh, Sw) for the XLA tracker's search windows)
  and the 3x3 subpixel neighbourhoods. CUDA kernel
  ``csrc/extract_windows.cu``, plain version
  ``extract_windows_int_reference``.
* K2, port of ``patch_pallas.extract_patches``
  (``patch_pallas.py:186-237``): ORB's (N, P, P) bilinear patches at float
  centres, edge-replicated. CUDA kernel ``csrc/extract_patches.cu`` on the
  unpadded image, whose clamped taps read what the edge-padded image holds;
  plain version ``extract_patches_clamped`` (the kernel's index arithmetic),
  held bit for bit to ``extract_patches_reference`` on the padded image.

Each wrapper routes by the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the hand-written kernel and adds one to the
wrapper's ``launches``. There is no other route: a CUDA input that the kernel
cannot take, or a failed build or launch, raises. The checks are one
boolean expression; the message is built only when it fails. The launch
takes the lean path (``native.entry``, resolved once, and
``cuda_stream.current_stream``, the raw current stream): the wrappers run
inside a CUDA graph capture unchanged.

The JAX wrappers' BLK=8 point padding and Mosaic alignment pads are not
needed here; any N works.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_stream, native

_F32, _I32 = torch.float32, torch.int32
MAX_PATCH = 127  # the JAX kernel's limit: a (P+1)-wide window in 256 lanes


def _window_shape(S) -> tuple[int, int]:
    """``S`` or ``(Sh, Sw)`` -> (Sh, Sw)."""
    return (S, S) if isinstance(S, int) else (int(S[0]), int(S[1]))


def extract_windows_int_reference(img_pad: torch.Tensor, corner_rc: torch.Tensor,
                                  S) -> torch.Tensor:
    """Plain version: ``img_pad[r:r+Sh, c:c+Sw]`` per corner by advanced
    indexing, corners clamped to [0, Hp-Sh] x [0, Wp-Sw] as the kernel does.
    ``S`` is the side of a square window or ``(Sh, Sw)``."""
    hp, wp = img_pad.shape
    sh, sw = _window_shape(S)
    r = torch.clamp(corner_rc[:, 0].long(), 0, hp - sh)
    c = torch.clamp(corner_rc[:, 1].long(), 0, wp - sw)
    rows = (r[:, None] + torch.arange(sh, device=img_pad.device))[:, :, None]
    cols = (c[:, None] + torch.arange(sw, device=img_pad.device))[:, None, :]
    return img_pad[rows, cols]


def _reject(img_pad: torch.Tensor, corner_rc: torch.Tensor, S) -> None:
    """Raise the error that K1's fast check found."""
    if img_pad.dtype != _F32 or img_pad.dim() != 2:
        raise ValueError(f"img_pad must be 2-D float32, got {img_pad.dtype} "
                         f"{tuple(img_pad.shape)}")
    if corner_rc.dtype != _I32 or corner_rc.dim() != 2 or corner_rc.shape[1] != 2:
        raise ValueError(f"corner_rc must be (N, 2) int32, got {corner_rc.dtype} "
                         f"{tuple(corner_rc.shape)}")
    if corner_rc.device != img_pad.device:
        raise ValueError(f"img_pad on {img_pad.device}, corner_rc on "
                         f"{corner_rc.device}")
    if not (img_pad.is_contiguous() and corner_rc.is_contiguous()):
        raise ValueError("img_pad and corner_rc must be contiguous")
    raise ValueError(f"window S={S} does not fit the image {tuple(img_pad.shape)}")


def extract_windows_int(img_pad: torch.Tensor, corner_rc: torch.Tensor,
                        S) -> torch.Tensor:
    """(Hp, Wp) float32 image + (N, 2) int32 [row, col] corners -> (N, Sh, Sw)
    for ``S`` = ``(Sh, Sw)``, or (N, S, S) for an int ``S``.

    Corners follow the JAX contract (pre-clipped to [0, Hp-Sh] x [0, Wp-Sw]).
    ``extract_windows_int.launches`` counts the CUDA kernel's launches.
    """
    sh, sw = _window_shape(S)
    if not (img_pad.dtype == _F32 and corner_rc.dtype == _I32 and img_pad.dim() == 2
            and corner_rc.dim() == 2 and corner_rc.shape[1] == 2
            and corner_rc.device == img_pad.device and img_pad.is_contiguous()
            and corner_rc.is_contiguous() and 0 < sh <= img_pad.shape[0]
            and 0 < sw <= img_pad.shape[1]):
        _reject(img_pad, corner_rc, S)
    if not img_pad.is_cuda:
        if img_pad.device.type != "cpu":
            raise ValueError(f"unsupported device {img_pad.device}")
        return extract_windows_int_reference(img_pad, corner_rc, S)
    hp, wp = img_pad.shape
    n = corner_rc.shape[0]
    out = img_pad.new_empty((n, sh, sw))
    if n == 0:
        return out
    index = img_pad.get_device()
    err = native.entry("svo_extract_windows_int")(
        img_pad.data_ptr(), hp, wp, corner_rc.data_ptr(), n, sh, sw, out.data_ptr(),
        index, cuda_stream.current_stream(index))
    if err != 0:
        raise RuntimeError(f"extract_windows_int launch failed: cudaError {err}")
    extract_windows_int.launches += 1
    return out


extract_windows_int.launches = 0


def pad_edge(img: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """(H, W) -> (top + H + bottom, left + W + right), edge-replicated."""
    if not (top or bottom or left or right):
        return img
    return F.pad(img[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def fma_f32(p: torch.Tensor, q: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add ``p*q + acc`` with one rounding (CUDA's
    ``__fmaf_rn``), for float32 inputs.

    The product is exact in float64 (24 + 24 significant bits). The sum is
    rounded to odd in float64 (rounded to nearest, then, where TwoSum finds
    it inexact, truncated and its last bit set), so the final rounding to
    float32 rounds the exact value once: 53 >= 24 + 2 bits.
    """
    prod = p.double() * q.double()
    acc = acc.double()
    s = prod + acc
    bb = s - prod
    err = (prod - (s - bb)) + (acc - bb)  # TwoSum: s + err == prod + acc
    away = ((err < 0) & (s > 0)) | ((err > 0) & (s < 0))  # |s| > |exact|
    bits = s.view(torch.int64)
    bits = torch.where(err != 0, (bits - away.to(torch.int64)) | 1, bits)
    return bits.view(torch.float64).to(torch.float32)


def _patch_corners(centers_xy: torch.Tensor, P: int, pad: int, hp: int, wp: int):
    """K2's corner arithmetic in float32: corner = centre + pad - (P-1)/2, its
    integer part clipped to [0, Hp-P-1] x [0, Wp-P-1] (padded extents), and
    one (fy, fx) per patch. Returns (iy, ix, fy, fx)."""
    r = (P - 1) / 2.0
    ty = (centers_xy[:, 1] + pad) - r
    tx = (centers_xy[:, 0] + pad) - r
    iy = torch.clamp(torch.floor(ty).to(torch.int64), 0, hp - P - 1)
    ix = torch.clamp(torch.floor(tx).to(torch.int64), 0, wp - P - 1)
    return iy, ix, ty - iy.to(torch.float32), tx - ix.to(torch.float32)


def _blend(win: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """The 4-tap blend of (N, P+1, P+1) windows with one (fy, fx) per patch,
    in the kernel's order: ``a(1-fy)(1-fx) + b(1-fy)fx + c fy(1-fx) + d fy fx``
    with the last three products fused into the running sum, as XLA
    contracts the JAX kernel in interpret mode:
    ``fma(d fy, fx, fma(c fy, 1-fx, fma(a (1-fy), 1-fx, b (1-fy) fx)))``."""
    fy, fx = fy[:, None, None], fx[:, None, None]
    gy, gx = 1 - fy, 1 - fx
    a, b = win[:, :-1, :-1], win[:, :-1, 1:]
    c, d = win[:, 1:, :-1], win[:, 1:, 1:]
    acc = fma_f32(a * gy, gx.expand_as(a), (b * gy) * fx)
    acc = fma_f32(c * fy, gx.expand_as(c), acc)
    return fma_f32(d * fy, fx.expand_as(d), acc)


def extract_patches_reference(img_pad: torch.Tensor, centers_xy: torch.Tensor,
                              P: int, pad: int) -> torch.Tensor:
    """K2 on an edge-padded image: the (P+1)^2 window at the clipped integer
    corner, read from ``img_pad``, blended with the patch's (fy, fx)."""
    hp, wp = img_pad.shape
    iy, ix, fy, fx = _patch_corners(centers_xy, P, pad, hp, wp)
    off = torch.arange(P + 1, device=img_pad.device)
    win = img_pad[(iy[:, None] + off)[:, :, None], (ix[:, None] + off)[:, None, :]]
    return _blend(win, fy, fx)


def extract_patches_clamped(img: torch.Tensor, centers_xy: torch.Tensor,
                            P: int) -> torch.Tensor:
    """Plain version of K2 in the kernel's index arithmetic: no padded copy;
    window tap (u, v) of a patch reads ``img[clamp(iy+u-pad, 0, H-1),
    clamp(ix+v-pad, 0, W-1)]``, which is the edge-padded image's pixel (iy+u,
    ix+v), so it equals ``extract_patches_reference`` on the padded image."""
    pad = P // 2 + 2
    h, w = img.shape
    iy, ix, fy, fx = _patch_corners(centers_xy, P, pad, h + 2 * pad, w + 2 * pad)
    off = torch.arange(P + 1, device=img.device) - pad
    rows = torch.clamp(iy[:, None] + off, 0, h - 1)
    cols = torch.clamp(ix[:, None] + off, 0, w - 1)
    return _blend(img[rows[:, :, None], cols[:, None, :]], fy, fx)


def _reject_patches(img: torch.Tensor, centers_xy: torch.Tensor, P: int) -> None:
    """Raise the error that K2's fast check found."""
    if img.dtype != _F32 or img.dim() != 2:
        raise ValueError(f"img must be 2-D float32, got {img.dtype} {tuple(img.shape)}")
    if centers_xy.dtype != _F32 or centers_xy.dim() != 2 or centers_xy.shape[1] != 2:
        raise ValueError(f"centers_xy must be (N, 2) float32, got {centers_xy.dtype} "
                         f"{tuple(centers_xy.shape)}")
    if centers_xy.device != img.device:
        raise ValueError(f"img on {img.device}, centers_xy on {centers_xy.device}")
    if P > MAX_PATCH:
        raise ValueError(f"patch P={P} is above the limit P <= {MAX_PATCH}")
    pad = P // 2 + 2
    raise ValueError(f"patch P={P} does not fit the padded image "
                     f"{(img.shape[0] + 2 * pad, img.shape[1] + 2 * pad)}")


def extract_patches(img: torch.Tensor, centers_xy: torch.Tensor, P: int) -> torch.Tensor:
    """Batched (N, P, P) subpixel patches around (N, 2) [x, y] centres of the
    (H, W) float32 ``img``, edge-replicated (pad P//2 + 2, as JAX), for
    1 <= P <= ``MAX_PATCH`` and P below the padded extents.

    ``extract_patches.launches`` counts the CUDA kernel's launches.
    """
    pad = P // 2 + 2
    if not (img.dtype == _F32 and centers_xy.dtype == _F32 and img.dim() == 2
            and centers_xy.dim() == 2 and centers_xy.shape[1] == 2
            and centers_xy.device == img.device and 1 <= P <= MAX_PATCH
            and P < min(img.shape) + 2 * pad):
        _reject_patches(img, centers_xy, P)
    if not img.is_cuda:
        if img.device.type != "cpu":
            raise ValueError(f"unsupported device {img.device}")
        return extract_patches_clamped(img, centers_xy, P)
    img, centers_xy = img.contiguous(), centers_xy.contiguous()
    h, w = img.shape
    n = centers_xy.shape[0]
    out = img.new_empty((n, P, P))
    if n == 0:
        return out
    index = img.get_device()
    err = native.entry("svo_extract_patches")(
        img.data_ptr(), h, w, centers_xy.data_ptr(), n, P, pad, out.data_ptr(), index,
        cuda_stream.current_stream(index))
    if err != 0:
        raise RuntimeError(f"extract_patches launch failed: cudaError {err}")
    extract_patches.launches += 1
    return out


extract_patches.launches = 0
