"""Checkpoint / resume for long VO runs.

Port of ``stereo_visual_odometry_tpu/utils/checkpoint.py``: the full
runtime state — trajectory, frame index, status, the frontend state's
leaves, the keyframe window and its landmarks — serializes to one ``.npz``
with the JAX package's keys, so an interrupted sequence resumes exactly
where it stopped. Where the port differs:

* the RANSAC draws come from ``System.generator``, whose state is saved
  under JAX's ``key``; it is restored into a generator of the same device
  type (the CPU's and CUDA's are different algorithms, so a run moved
  between them draws anew);
* ``load`` writes the state through ``System._set_state``: under the step
  graph the graph's buffers are the live state, and the next replay reads
  them. The leaves are saved as numpy, so a state saved on the card loads
  on the CPU and back;
* the backend's marginalization prior and ``_last_kf_n_tracked`` are saved
  too. The JAX checkpoint drops both, so a JAX run resumed after its first
  window slide goes on without its prior.
"""
from __future__ import annotations

import json

import numpy as np
import torch


def _leaves(tree) -> list:
    """The leaves in JAX's pytree order (dict keys sorted), so the numbering
    does not hang on the order a step built its dicts in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with the next leaves of the iterator ``leaves``,
    taken in ``_leaves``' order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def save(path: str, system) -> None:
    """Snapshot a ``models.system.System`` to ``path`` (.npz)."""
    arrays = {
        "poses": np.stack(system.poses) if system.poses else np.zeros((0, 4, 4)),
        "frame_idx": np.asarray(system.frame_idx),
        "status": np.asarray(system.status),
        "key": system.generator.get_state().numpy(),
    }
    meta = {"has_state": system.state is not None,
            "has_backend": system.backend is not None,
            "lost_count": system.lost_count,
            "generator_device": system.generator.device.type}
    if system.state is not None:
        leaves = _leaves(system.state)
        arrays.update({f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)})
        meta["n_leaves"] = len(leaves)
    if system.backend is not None:
        b = system.backend
        arrays["kf_poses"] = (np.stack(b.kf_poses) if b.kf_poses
                              else np.zeros((0, 4, 4)))
        arrays["frame_of_kf"] = np.asarray(b.frame_of_kf, np.int64)
        lm_ids = np.asarray(list(b.landmarks.keys()), np.int64)
        arrays["lm_ids"] = lm_ids
        arrays["lm_xyz"] = (np.stack([b.landmarks[i] for i in lm_ids])
                            if len(lm_ids) else np.zeros((0, 3)))
        meta["frames_since_kf"] = int(min(b._frames_since_kf, 10 ** 9))
        meta["last_kf_n_tracked"] = int(b._last_kf_n_tracked)
        # kf observations as ragged json (small).
        meta["kf_obs"] = [
            {str(t): [uv.tolist(), None if uv_r is None else uv_r.tolist()]
             for t, (uv, uv_r) in o.items()}
            for o in b.kf_obs]
        meta["prior"] = None if b.prior is None else sorted(b.prior)
        if b.prior is not None:
            arrays.update({f"prior_{k}": np.asarray(v) for k, v in b.prior.items()})
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(path: str, system) -> None:
    """Restore a snapshot produced by ``save`` into ``system`` (built with
    the same config; with a frontend state, step it one frame first, as in
    JAX, so the state's structure exists)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta_json"]).decode())
    if meta["has_state"] and system.state is None:
        raise ValueError("step one frame before load(): the frontend state's structure "
                         "comes from a live state")
    system.poses = list(z["poses"])
    system.frame_idx = int(z["frame_idx"])
    system.status = int(z["status"])
    if meta["generator_device"] == system.generator.device.type:
        system.generator.set_state(torch.from_numpy(z["key"]))
    else:
        system.log.warning("checkpoint drew on %s, this System on %s: the RANSAC draws "
                           "start from the seed", meta["generator_device"],
                           system.generator.device.type)
    system.lost_count = int(meta.get("lost_count", 0))
    if meta["has_state"]:
        leaves = iter(torch.as_tensor(z[f"leaf_{i}"], device=system.device)
                      for i in range(meta["n_leaves"]))
        system._set_state(_rebuild(system.state, leaves))
    if meta["has_backend"] and system.backend is not None:
        b = system.backend
        b.kf_poses = list(z["kf_poses"])
        b.frame_of_kf = list(z["frame_of_kf"])
        b.landmarks = {int(i): x for i, x in zip(z["lm_ids"], z["lm_xyz"])}
        b.kf_obs = [
            {int(t): (np.asarray(v[0]), None if v[1] is None else np.asarray(v[1]))
             for t, v in o.items()}
            for o in meta["kf_obs"]]
        b._frames_since_kf = meta.get("frames_since_kf", 10 ** 9)
        b._last_kf_n_tracked = meta["last_kf_n_tracked"]
        b.prior = (None if meta["prior"] is None
                   else {k: z[f"prior_{k}"] for k in meta["prior"]})
