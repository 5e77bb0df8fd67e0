"""K7: a roll of a 2-D float32 array by an amount held in device memory.

Port of ``probe_roll.make`` (``scripts/probe_roll.py:12-25``): the Pallas
probe of Mosaic's dynamic rotate, ``pltpu.roll(x, -amt[0, 0], axis)`` with
the amount in scalar memory. So ``roll(x, amt, axis)`` is
``np.roll(x, -amt, axis)``: ``out[i] = x[(i + amt) mod n]`` along ``axis``,
for any amount (negative, or beyond the axis length).

CUDA kernel ``csrc/roll.cu`` (four elements per thread with 16-byte
accesses where the width and alignment allow, else one; the amount read
from the (1, 1) int32 tensor on the card, so the host never waits for it);
plain version ``roll_reference``. A CUDA tensor goes through the binding
``csrc/roll_binding.cpp`` (PyTorch's C++ API; built by ``native.extension``
at the first CUDA call, never at import): one call checks the inputs,
allocates the output, takes the current stream and launches the kernel, so
it captures in a CUDA graph unchanged. A CPU tensor takes the plain version;
any other device raises, and so does a binding that does not build: there
is no fallback. Launches are counted in ``roll.launches``.
"""
from __future__ import annotations

import torch

from . import native

_launch = None  # the binding's roll, once built and loaded


def _check(x: torch.Tensor, amt: torch.Tensor, axis: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty 2-D float32 array, got {x.dtype} "
                         f"{tuple(x.shape)}")
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


def launcher():
    """The binding's ``roll(x, amt, axis)`` (built and loaded on the first
    call): checks as ``_check`` does, with ``x`` on the card."""
    global _launch
    if _launch is None:
        _launch = native.extension("roll_binding", ("svo_roll",)).roll
    return _launch


def roll(x: torch.Tensor, amt: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.roll(x, -amt, axis)`` for a (rows, cols) float32 ``x`` and a
    (1, 1) int32 ``amt`` on the same device."""
    if x.is_cuda:
        out = (_launch or launcher())(x, amt, axis)
        roll.launches += 1
        return out
    _check(x, amt, axis)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return roll_reference(x, amt, axis)


roll.launches = 0
