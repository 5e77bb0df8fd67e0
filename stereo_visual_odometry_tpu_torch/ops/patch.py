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

Under ``torch.func.vmap`` (``transformed()``) a wrapper calls its
``torch.library`` custom op instead (``ops/library.py``:
``svo::extract_windows_int``, ``svo::extract_patches``), whose
implementations are the two routes above and whose batch rule calls the
batched entry (``extract_windows_int_batched``, ``extract_patches_batched``):
S sequences are one launch of the kernel with a sequence axis (one launch
counted), and on the CPU the plain version once per sequence. Every CUDA
route goes through one launcher per kernel (``launch_windows``,
``launch_patches``), which calls the batched C entry, with B = 1 for one
image; the B = 1 C entries stay for the probes' bare timing. Outside a
transform the wrapper takes its route directly: through the op, every
eager call paid the dispatcher's host time too (K1 back to back 20.8 ->
41.4 us on the H100's host; PERF.md section 6).

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
    if transformed():
        return torch.ops.svo.extract_windows_int(img_pad, corner_rc, sh, sw)
    if not img_pad.is_cuda:
        if img_pad.device.type != "cpu":
            raise ValueError(f"unsupported device {img_pad.device}")
        return extract_windows_int_reference(img_pad, corner_rc, (sh, sw))
    return launch_windows(img_pad, corner_rc, sh, sw)


def transformed() -> bool:
    """Whether a functorch transform (``torch.func.vmap``) is active: the
    wrappers then go through their custom ops, whose batch rules see the
    real (S, ...) tensors. ``torch.autograd.Function`` asks the same."""
    return torch._C._are_functorch_transforms_active()


def launch_windows(imgs: torch.Tensor, corners: torch.Tensor, sh: int,
                   sw: int) -> torch.Tensor:
    """K1's launch, the one CUDA route of the wrapper, of its op and of the
    op's batch rule: contiguous (Hp, Wp) or (B, Hp, Wp) images and (N, 2) or
    (B, N, 2) corners -> (N, Sh, Sw) or (B, N, Sh, Sw), one launch of the
    batched entry (B = 1 for one image), counted once. Nothing launches for
    N = 0 or B = 0."""
    if imgs.dim() == 2:  # unpacked shapes: torch.Size arithmetic costs host time
        (hp, wp), b, n = imgs.shape, 1, corners.shape[0]
        out = imgs.new_empty((n, sh, sw))
    else:
        (b, hp, wp), n = imgs.shape, corners.shape[1]
        out = imgs.new_empty((b, n, sh, sw))
    if n == 0 or b == 0:
        return out
    index = imgs.get_device()
    err = native.entry("svo_extract_windows_int_batched")(
        imgs.data_ptr(), hp, wp, corners.data_ptr(), n, b, sh, sw, out.data_ptr(), index,
        cuda_stream.current_stream(index))
    if err != 0:
        raise RuntimeError(f"extract_windows_int launch failed: cudaError {err}")
    extract_windows_int.launches += 1
    return out


def extract_windows_int_batched(imgs: torch.Tensor, corners: torch.Tensor,
                                S) -> torch.Tensor:
    """K1 on a sequence axis: (B, Hp, Wp) float32 images + (B, N, 2) int32
    corners -> (B, N, Sh, Sw), window n of sequence b read from image b. A
    CUDA input is one launch of the batched entry (counted once); a CPU input
    runs the plain version once per sequence."""
    sh, sw = _window_shape(S)
    if not (imgs.dtype == _F32 and corners.dtype == _I32 and imgs.dim() == 3
            and corners.dim() == 3 and corners.shape[0] == imgs.shape[0]
            and corners.shape[2] == 2 and corners.device == imgs.device
            and 0 < sh <= imgs.shape[1] and 0 < sw <= imgs.shape[2]):
        raise ValueError(f"want (B, Hp, Wp) float32 images and (B, N, 2) int32 corners "
                         f"on one device for S={S}, got {imgs.dtype} {tuple(imgs.shape)} "
                         f"and {corners.dtype} {tuple(corners.shape)}")
    if imgs.device.type == "cpu":
        return _stack([extract_windows_int_reference(i, c, (sh, sw))
                       for i, c in zip(imgs, corners)], (0, corners.shape[1], sh, sw), imgs)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    return launch_windows(imgs.contiguous(), corners.contiguous(), sh, sw)


def _stack(parts: list, empty_shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """``torch.stack(parts)``, or an empty (0, ...) tensor for no parts."""
    return torch.stack(parts) if parts else like.new_empty(empty_shape)


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
    if transformed():
        return torch.ops.svo.extract_patches(img, centers_xy, P)
    if not img.is_cuda:
        if img.device.type != "cpu":
            raise ValueError(f"unsupported device {img.device}")
        return extract_patches_clamped(img, centers_xy, P)
    return launch_patches(img, centers_xy, P)


def launch_patches(imgs: torch.Tensor, centers: torch.Tensor, P: int) -> torch.Tensor:
    """K2's launch, the one CUDA route of the wrapper, of its op and of the
    op's batch rule: (H, W) or (B, H, W) images and (N, 2) or (B, N, 2)
    centres -> (N, P, P) or (B, N, P, P), one launch of the batched entry
    (B = 1 for one image), counted once. Nothing launches for N = 0 or
    B = 0."""
    imgs, centers = imgs.contiguous(), centers.contiguous()
    if imgs.dim() == 2:
        (h, w), b, n = imgs.shape, 1, centers.shape[0]
        out = imgs.new_empty((n, P, P))
    else:
        (b, h, w), n = imgs.shape, centers.shape[1]
        out = imgs.new_empty((b, n, P, P))
    if n == 0 or b == 0:
        return out
    index = imgs.get_device()
    err = native.entry("svo_extract_patches_batched")(
        imgs.data_ptr(), h, w, centers.data_ptr(), n, b, P, P // 2 + 2, out.data_ptr(), index,
        cuda_stream.current_stream(index))
    if err != 0:
        raise RuntimeError(f"extract_patches launch failed: cudaError {err}")
    extract_patches.launches += 1
    return out


def extract_patches_batched(imgs: torch.Tensor, centers: torch.Tensor, P: int) -> torch.Tensor:
    """K2 on a sequence axis: (B, H, W) float32 images + (B, N, 2) float32
    [x, y] centres -> (B, N, P, P), patch n of sequence b from image b. A CUDA
    input is one launch of the batched entry (counted once); a CPU input runs
    the plain version once per sequence."""
    pad = P // 2 + 2
    if not (imgs.dtype == _F32 and centers.dtype == _F32 and imgs.dim() == 3
            and centers.dim() == 3 and centers.shape[0] == imgs.shape[0]
            and centers.shape[2] == 2 and centers.device == imgs.device
            and 1 <= P <= MAX_PATCH and P < min(imgs.shape[1:]) + 2 * pad):
        raise ValueError(f"want (B, H, W) float32 images and (B, N, 2) float32 centres "
                         f"on one device for P={P}, got {imgs.dtype} {tuple(imgs.shape)} "
                         f"and {centers.dtype} {tuple(centers.shape)}")
    if imgs.device.type == "cpu":
        return _stack([extract_patches_clamped(i, c, P) for i, c in zip(imgs, centers)],
                      (0, centers.shape[1], P, P), imgs)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    return launch_patches(imgs, centers, P)


extract_patches.launches = 0
