"""K7: a roll of a 2-D float32 array by an amount held in device memory.

Port of ``probe_roll.make`` (``scripts/probe_roll.py:12-25``): the Pallas
probe of Mosaic's dynamic rotate, ``pltpu.roll(x, -amt[0, 0], axis)`` with
the amount in scalar memory. So ``roll(x, amt, axis)`` is
``np.roll(x, -amt, axis)``: ``out[i] = x[(i + amt) mod n]`` along ``axis``,
for any amount (negative, or beyond the axis length).

CUDA kernel ``csrc/roll.cu`` (four elements per thread with 16-byte
accesses where the width and alignment allow, else one; the amount read
from the (1, 1) int32 tensor on the card, so the host never waits for it);
plain version ``roll_reference``. The wrapper routes by device as
``patch.py`` does: a CUDA tensor launches the C entry ``svo_roll`` through
the lean path (``native.entry``, the raw current stream), so it captures in
a CUDA graph unchanged; a CPU tensor takes the plain version; any other
device raises. Bad inputs raise a ValueError before anything launches.
Launches are counted in ``roll.launches``.
"""
from __future__ import annotations

import torch

from . import cuda_stream, native

_INT_MAX = 2 ** 31 - 1


def _check(x: torch.Tensor, amt: torch.Tensor, axis: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty 2-D float32 array, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if max(x.shape) > _INT_MAX:  # the C entry takes int rows and cols
        raise ValueError(f"x has more than {_INT_MAX} rows or columns: {tuple(x.shape)}")
    if amt.dtype != torch.int32 or amt.shape != (1, 1):
        raise ValueError(f"amt must be a (1, 1) int32 tensor, got {amt.dtype} "
                         f"{tuple(amt.shape)}")
    if amt.device != x.device:
        raise ValueError(f"x on {x.device}, amt on {amt.device}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")


def roll_reference(x: torch.Tensor, amt: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain version: ``torch.roll(x, -amt, axis)`` (reads the amount on the
    host)."""
    return torch.roll(x, -int(amt.reshape(())), axis)


def roll(x: torch.Tensor, amt: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.roll(x, -amt, axis)`` for a (rows, cols) float32 ``x`` and a
    (1, 1) int32 ``amt`` on the same device."""
    _check(x, amt, axis)
    if x.device.type == "cpu":
        return roll_reference(x, amt, axis)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows, cols = x.shape
    index = x.get_device()
    err = native.entry("svo_roll")(x.data_ptr(), rows, cols, amt.data_ptr(), axis,
                                   out.data_ptr(), index, cuda_stream.current_stream(index))
    if err != 0:
        raise RuntimeError(f"svo_roll launch failed: cudaError {err}")
    roll.launches += 1
    return out


roll.launches = 0
