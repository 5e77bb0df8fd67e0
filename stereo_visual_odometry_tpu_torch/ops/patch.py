"""The patch kernels: K1 (integer-corner windows) and K2 (bilinear patches).

* K1, port of ``patch_pallas.extract_windows_int``
  (``stereo_visual_odometry_tpu/ops/patch_pallas.py:167-183``): the LK
  window reads (square, or (Sh, Sw) for the XLA tracker's search windows)
  and the 3x3 subpixel neighbourhoods. CUDA kernel
  ``csrc/extract_windows.cu``, plain version
  ``extract_windows_int_reference``.
* K2, port of ``patch_pallas.extract_patches``
  (``patch_pallas.py:186-237``): ORB's (N, P, P) bilinear patches at float
  centres of an edge-padded image. CUDA kernel ``csrc/extract_patches.cu``,
  plain version ``extract_patches_reference``.

Each wrapper routes by the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the hand-written kernel and adds one to the
wrapper's ``launches``. There is no other route: a CUDA input that the kernel
cannot take, or a failed build or launch, raises.

The JAX wrappers' BLK=8 point padding and Mosaic alignment pads are not
needed here; any N works.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import native


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


def _check(img_pad: torch.Tensor, corner_rc: torch.Tensor, S) -> None:
    if img_pad.dtype != torch.float32 or img_pad.dim() != 2:
        raise ValueError(f"img_pad must be 2-D float32, got {img_pad.dtype} "
                         f"{tuple(img_pad.shape)}")
    if corner_rc.dtype != torch.int32 or corner_rc.dim() != 2 \
            or corner_rc.shape[1] != 2:
        raise ValueError(f"corner_rc must be (N, 2) int32, got {corner_rc.dtype} "
                         f"{tuple(corner_rc.shape)}")
    if corner_rc.device != img_pad.device:
        raise ValueError(f"img_pad on {img_pad.device}, corner_rc on "
                         f"{corner_rc.device}")
    if not (img_pad.is_contiguous() and corner_rc.is_contiguous()):
        raise ValueError("img_pad and corner_rc must be contiguous")
    hp, wp = img_pad.shape
    sh, sw = _window_shape(S)
    if not (1 <= sh <= hp and 1 <= sw <= wp):
        raise ValueError(f"window S={S} does not fit the image {(hp, wp)}")


def extract_windows_int(img_pad: torch.Tensor, corner_rc: torch.Tensor,
                        S) -> torch.Tensor:
    """(Hp, Wp) float32 image + (N, 2) int32 [row, col] corners -> (N, Sh, Sw)
    for ``S`` = ``(Sh, Sw)``, or (N, S, S) for an int ``S``.

    Corners follow the JAX contract (pre-clipped to [0, Hp-Sh] x [0, Wp-Sw]).
    ``extract_windows_int.launches`` counts the CUDA kernel's launches.
    """
    _check(img_pad, corner_rc, S)
    if img_pad.device.type == "cpu":
        return extract_windows_int_reference(img_pad, corner_rc, S)
    if img_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {img_pad.device}")
    hp, wp = img_pad.shape
    sh, sw = _window_shape(S)
    n = corner_rc.shape[0]
    out = torch.empty((n, sh, sw), dtype=torch.float32, device=img_pad.device)
    stream = torch.cuda.current_stream(img_pad.device).cuda_stream
    err = native.lib().svo_extract_windows_int(
        img_pad.data_ptr(), hp, wp, corner_rc.data_ptr(), n, sh, sw, out.data_ptr(),
        img_pad.device.index, stream)
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


def extract_patches_reference(img_pad: torch.Tensor, centers_xy: torch.Tensor,
                              P: int, pad: int) -> torch.Tensor:
    """Plain version of K2 on a padded image, in the kernel's arithmetic.

    Corner = centre + pad - (P-1)/2 in float32; its integer part is clipped
    to [0, Hp-P-1] x [0, Wp-P-1]; one (fy, fx) per patch drives the 4-tap
    blend of the (P+1)^2 window. The blend is the JAX kernel's
    ``a(1-fy)(1-fx) + b(1-fy)fx + c fy(1-fx) + d fy fx`` with the last
    three products fused into the running sum, as XLA contracts it when
    the JAX package runs the kernel in interpret mode:
    ``fma(d fy, fx, fma(c fy, 1-fx, fma(a (1-fy), 1-fx, b (1-fy) fx)))``.
    """
    hp, wp = img_pad.shape
    r = (P - 1) / 2.0
    ty = (centers_xy[:, 1] + pad) - r
    tx = (centers_xy[:, 0] + pad) - r
    iy = torch.clamp(torch.floor(ty).to(torch.int64), 0, hp - P - 1)
    ix = torch.clamp(torch.floor(tx).to(torch.int64), 0, wp - P - 1)
    fy = (ty - iy.to(torch.float32))[:, None, None]
    fx = (tx - ix.to(torch.float32))[:, None, None]
    gy, gx = 1 - fy, 1 - fx
    off = torch.arange(P + 1, device=img_pad.device)
    win = img_pad[(iy[:, None] + off)[:, :, None], (ix[:, None] + off)[:, None, :]]
    a, b = win[:, :-1, :-1], win[:, :-1, 1:]
    c, d = win[:, 1:, :-1], win[:, 1:, 1:]
    acc = fma_f32(a * gy, gx.expand_as(a), (b * gy) * fx)
    acc = fma_f32(c * fy, gx.expand_as(c), acc)
    return fma_f32(d * fy, fx.expand_as(d), acc)


def _check_patches(img_pad: torch.Tensor, centers_xy: torch.Tensor, P: int) -> None:
    if img_pad.dtype != torch.float32 or img_pad.dim() != 2:
        raise ValueError(f"img_pad must be 2-D float32, got {img_pad.dtype} "
                         f"{tuple(img_pad.shape)}")
    if centers_xy.dtype != torch.float32 or centers_xy.dim() != 2 \
            or centers_xy.shape[1] != 2:
        raise ValueError(f"centers_xy must be (N, 2) float32, got {centers_xy.dtype} "
                         f"{tuple(centers_xy.shape)}")
    if centers_xy.device != img_pad.device:
        raise ValueError(f"img on {img_pad.device}, centers_xy on {centers_xy.device}")
    hp, wp = img_pad.shape
    if not 1 <= P <= min(hp, wp) - 1:
        raise ValueError(f"patch P={P} does not fit the padded image {(hp, wp)}")


def extract_patches(img: torch.Tensor, centers_xy: torch.Tensor, P: int) -> torch.Tensor:
    """Batched (N, P, P) subpixel patches around (N, 2) [x, y] centres of the
    (H, W) float32 ``img``, edge-replicated (pad P//2 + 2, as JAX).

    ``extract_patches.launches`` counts the CUDA kernel's launches.
    """
    pad = P // 2 + 2
    if img.dim() != 2:
        raise ValueError(f"img must be 2-D, got {tuple(img.shape)}")
    img_pad = pad_edge(img, pad, pad, pad, pad)
    _check_patches(img_pad, centers_xy, P)
    if img_pad.device.type == "cpu":
        return extract_patches_reference(img_pad, centers_xy, P, pad)
    if img_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {img_pad.device}")
    centers_xy = centers_xy.contiguous()
    hp, wp = img_pad.shape
    n = centers_xy.shape[0]
    out = torch.empty((n, P, P), dtype=torch.float32, device=img_pad.device)
    stream = torch.cuda.current_stream(img_pad.device).cuda_stream
    err = native.lib().svo_extract_patches(
        img_pad.data_ptr(), hp, wp, centers_xy.data_ptr(), n, P, pad,
        out.data_ptr(), img_pad.device.index, stream)
    if err != 0:
        raise RuntimeError(f"extract_patches launch failed: cudaError {err}")
    extract_patches.launches += 1
    return out


extract_patches.launches = 0
