"""Batched device->host transfers.

Port of ``stereo_visual_odometry_tpu/utils/hostcopy.py``. Converting a
metrics tree leaf by leaf (``.cpu()`` on each) waits for the device once per
leaf. ``device_get_tree`` starts every copy asynchronously into pinned host
memory first, then waits once per device, on an event recorded after the
copies (not on the whole device).
"""
from __future__ import annotations

import numpy as np
import torch

from .tree import tree_leaves, tree_map


def device_get_tree(tree):
    """Fetch a tree of tensors as numpy arrays (other leaves through
    ``np.asarray``), overlapping the copies: one wait per device."""
    copies, devices = {}, []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda and id(leaf) not in copies:
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            copies[id(leaf)] = host.copy_(leaf.detach(), non_blocking=True)
            if leaf.device not in devices:
                devices.append(leaf.device)
    for dev in devices:  # every copy is issued: wait for each device's last
        with torch.cuda.device(dev):
            event = torch.cuda.Event()
            event.record()
        event.synchronize()

    def get(leaf):
        if isinstance(leaf, torch.Tensor):
            return copies[id(leaf)].numpy() if leaf.is_cuda else leaf.detach().numpy()
        return np.asarray(leaf)

    return tree_map(get, tree)
