"""Carry a rig, a frontend state and a BA backend's state from numpy into
the port.

The system has no learned weights; what moves between the two packages is
the stereo rig, the frontend state (LK or ORB, with its persistent tracks)
and the sliding-window backend's host state. All come in as numpy arrays (a
caller holding JAX arrays converts them with ``np.asarray``), so this
module never imports ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.backend import BackendConfig, SlidingWindowBA
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
    (``lk_predictive=False``); a state with persistent tracks its
    ``track_id``, ``track_age`` and ``next_id`` (int32). A vmapped JAX
    state (every leaf with a leading sequence axis S) gives the batched
    state of ``parallel/sequences.py``, S-leading too."""
    to_f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    state = {
        "status": torch.tensor(np.asarray(state_np["status"]), dtype=torch.int32,
                               device=device),
        "n_detected": torch.tensor(np.asarray(state_np["n_detected"]), dtype=torch.int64,
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
    state.update({k: torch.tensor(np.asarray(state_np[k]), dtype=torch.int32, device=device)
                  for k in ("track_id", "track_age", "next_id") if k in state_np})
    return state


# The host state of a ``SlidingWindowBA``, in both packages.
BACKEND_STATE = ("kf_poses", "kf_obs", "landmarks", "frame_of_kf", "prior",
                 "_frames_since_kf", "_last_kf_n_tracked")


def backend_from_jax(state_np: dict, cam: Pinhole, cfg: BackendConfig,
                     T_rl) -> SlidingWindowBA:
    """A JAX ``SlidingWindowBA``'s host state (``BACKEND_STATE`` of its
    attributes, numpy) -> the port's backend on ``cam``'s device, holding
    copies of it: keyframe poses (float64), per-keyframe observations
    track_id -> (uv, uv_r or None), landmarks, keyframe frames, the prior
    (or None) and the keyframe gate's counters."""
    be = SlidingWindowBA(cam, cfg, T_rl=T_rl, device=cam.fx.device)
    copy = lambda a: None if a is None else np.array(a)
    be.kf_poses = [np.array(T, np.float64) for T in state_np["kf_poses"]]
    be.kf_obs = [{int(t): (copy(uv), copy(uv_r)) for t, (uv, uv_r) in o.items()}
                 for o in state_np["kf_obs"]]
    be.landmarks = {int(t): np.array(x) for t, x in state_np["landmarks"].items()}
    be.frame_of_kf = [int(f) for f in state_np["frame_of_kf"]]
    prior = state_np["prior"]
    be.prior = None if prior is None else {k: np.array(v) for k, v in prior.items()}
    be._frames_since_kf = int(state_np["_frames_since_kf"])
    be._last_kf_n_tracked = int(state_np["_last_kf_n_tracked"])
    return be
