"""K1: integer-corner window extraction, the one kernel on the LK main path.

Port of ``patch_pallas.extract_windows_int``
(``stereo_visual_odometry_tpu/ops/patch_pallas.py:167-183``). On a CUDA
tensor the wrapper launches the hand-written kernel
``csrc/extract_windows.cu``; on a CPU tensor it runs the plain version,
``extract_windows_int_reference``. There is no other route: a CUDA input
that the kernel cannot take, or a failed build or launch, raises.

The JAX wrapper's BLK=8 point padding and Mosaic alignment are not needed
here; any N works.
"""
from __future__ import annotations

import torch

from . import native


def extract_windows_int_reference(img_pad: torch.Tensor, corner_rc: torch.Tensor,
                                  S: int) -> torch.Tensor:
    """Plain version: ``img_pad[r:r+S, c:c+S]`` per corner by advanced
    indexing, corners clamped to [0, Hp-S] x [0, Wp-S] as the kernel does."""
    hp, wp = img_pad.shape
    r = torch.clamp(corner_rc[:, 0].long(), 0, hp - S)
    c = torch.clamp(corner_rc[:, 1].long(), 0, wp - S)
    off = torch.arange(S, device=img_pad.device)
    rows = (r[:, None] + off)[:, :, None]
    cols = (c[:, None] + off)[:, None, :]
    return img_pad[rows, cols]


def _check(img_pad: torch.Tensor, corner_rc: torch.Tensor, S: int) -> None:
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
    if not 1 <= S <= min(hp, wp):
        raise ValueError(f"window S={S} does not fit the image {(hp, wp)}")


def extract_windows_int(img_pad: torch.Tensor, corner_rc: torch.Tensor,
                        S: int) -> torch.Tensor:
    """(Hp, Wp) float32 image + (N, 2) int32 [row, col] corners -> (N, S, S).

    Corners follow the JAX contract (pre-clipped to [0, Hp-S] x [0, Wp-S]).
    ``extract_windows_int.launches`` counts the CUDA kernel's launches.
    """
    _check(img_pad, corner_rc, S)
    if img_pad.device.type == "cpu":
        return extract_windows_int_reference(img_pad, corner_rc, S)
    if img_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {img_pad.device}")
    hp, wp = img_pad.shape
    n = corner_rc.shape[0]
    out = torch.empty((n, S, S), dtype=torch.float32, device=img_pad.device)
    stream = torch.cuda.current_stream(img_pad.device).cuda_stream
    err = native.lib().svo_extract_windows_int(
        img_pad.data_ptr(), hp, wp, corner_rc.data_ptr(), n, S, out.data_ptr(),
        img_pad.device.index, stream)
    if err != 0:
        raise RuntimeError(f"extract_windows_int launch failed: cudaError {err}")
    extract_windows_int.launches += 1
    return out


extract_windows_int.launches = 0
