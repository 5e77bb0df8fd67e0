"""Carry a rig and a frontend state from numpy into the port.

The system has no learned weights; what moves between the two packages is
the stereo rig and the LK frontend state. Both come in as numpy arrays (a
caller holding JAX arrays converts them with ``np.asarray``), so this module
never imports ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import Pinhole, StereoRig

# LK frontend state entries the port carries (the JAX PRNG ``key`` is not:
# the port draws from a torch.Generator).
_FLOAT = ("kp", "T_wc", "T_21_prev", "dmap")


def rig_from_numpy(left, right, T_rl, device=None) -> StereoRig:
    """(fx, fy, cx, cy) of each camera + the (4, 4) left->right transform."""
    f32 = dict(dtype=torch.float32, device=device)
    cams = [Pinhole.create(*(float(v) for v in c), **f32) for c in (left, right)]
    return StereoRig(cams[0], cams[1],
                     torch.tensor(np.asarray(T_rl), **f32))


def state_from_jax(state_np: dict, device=None) -> dict:
    """A JAX LK frontend state (every leaf as numpy) -> the port's state dict."""
    to_f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    state = {
        "pyr_l": tuple(to_f32(a) for a in state_np["pyr_l"]),
        "pyr_r": tuple(to_f32(a) for a in state_np["pyr_r"]),
        "kp_valid": torch.tensor(np.asarray(state_np["kp_valid"]), dtype=torch.bool,
                                 device=device),
        "status": torch.tensor(int(state_np["status"]), dtype=torch.int32,
                               device=device),
        "n_detected": torch.tensor(int(state_np["n_detected"]), dtype=torch.int64,
                                   device=device),
    }
    state.update({k: to_f32(state_np[k]) for k in _FLOAT})
    return state
