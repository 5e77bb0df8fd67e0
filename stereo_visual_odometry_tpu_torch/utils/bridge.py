"""Carry a rig and a frontend state from numpy into the port.

The system has no learned weights; what moves between the two packages is
the stereo rig and the frontend state (LK or ORB). Both come in as numpy
arrays (a caller holding JAX arrays converts them with ``np.asarray``), so
this module never imports ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import Pinhole, StereoRig

# ORB feature dict entries -> the port's dtype. Descriptor words are uint32
# in JAX and int64 holding the same 32-bit patterns in the port.
_FEAT_DTYPE = {"xy": torch.float32, "desc": torch.int64, "angle": torch.float32,
               "score": torch.float32, "level": torch.int32, "valid": torch.bool}


def rig_from_numpy(left, right, T_rl, device=None) -> StereoRig:
    """(fx, fy, cx, cy) of each camera + the (4, 4) left->right transform."""
    f32 = dict(dtype=torch.float32, device=device)
    cams = [Pinhole.create(*(float(v) for v in c), **f32) for c in (left, right)]
    return StereoRig(cams[0], cams[1],
                     torch.tensor(np.asarray(T_rl), **f32))


def feat_from_jax(feat_np: dict, device=None) -> dict:
    """A JAX ORB feature dict (numpy leaves) -> the port's feature dict."""
    return {k: torch.tensor(np.asarray(feat_np[k]).astype(np.int64)
                            if k == "desc" else np.asarray(feat_np[k]),
                            dtype=dt, device=device)
            for k, dt in _FEAT_DTYPE.items()}


def state_from_jax(state_np: dict, device=None) -> dict:
    """A JAX LK or ORB frontend state (every leaf as numpy) -> the port's
    state dict. The JAX PRNG ``key`` is not carried: the port draws from a
    torch.Generator. An LK state carries its prior as the JAX one holds it:
    ``dmap`` (sweep), ``disp_grid`` (disparity grid) or neither
    (``lk_predictive=False``)."""
    to_f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    state = {
        "status": torch.tensor(int(state_np["status"]), dtype=torch.int32,
                               device=device),
        "n_detected": torch.tensor(int(state_np["n_detected"]), dtype=torch.int64,
                                   device=device),
    }
    if "feat_l" in state_np:  # ORB
        state.update({k: feat_from_jax(state_np[k], device) for k in ("feat_l", "feat_r")})
    else:
        state.update({
            "pyr_l": tuple(to_f32(a) for a in state_np["pyr_l"]),
            "pyr_r": tuple(to_f32(a) for a in state_np["pyr_r"]),
            "kp_valid": torch.tensor(np.asarray(state_np["kp_valid"]),
                                     dtype=torch.bool, device=device),
            "kp": to_f32(state_np["kp"]),
        })
        state.update({k: to_f32(state_np[k]) for k in ("dmap", "disp_grid")
                      if k in state_np})
    state.update({k: to_f32(state_np[k]) for k in ("T_wc", "T_21_prev")})
    return state
