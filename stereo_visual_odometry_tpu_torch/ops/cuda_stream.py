"""The raw CUDA stream that every kernel wrapper hands its C entry point.

Part of the lean launch path (with ``native.entry``): the wrappers of K1-K8
launch on PyTorch's current stream, and so run inside a CUDA graph capture
unchanged.
"""
from __future__ import annotations

import torch


def current_stream(index: int) -> int:
    """PyTorch's current CUDA stream on device ``index`` as a raw
    ``cudaStream_t``: inside ``torch.cuda.graph`` the capturing stream.

    ``torch._C._cuda_getCurrentRawStream`` is private; it is the call
    Triton's launcher makes, and it skips the ``torch.cuda.Stream`` object
    that ``torch.cuda.current_stream(device).cuda_stream`` builds."""
    return torch._C._cuda_getCurrentRawStream(index)
