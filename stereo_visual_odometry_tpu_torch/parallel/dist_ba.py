"""Distributed bundle adjustment: landmark-coherent shards and all-reduces of
the reduced camera system over ``torch.distributed``.

Port of ``stereo_visual_odometry_tpu/parallel/dist_ba.py`` (BASELINE.json
config 5). The observation table, the only O(M) object, is split over the
ranks of a process group BY LANDMARK (``partition_obs_by_landmark``): every
observation of a landmark lives on its owner rank, so each rank eliminates
its own landmarks and the only state crossing ranks is the reduced camera
system. Per LM iteration the all-reduces carry S_part (K, K, 6, 6),
b_part, Hpp, bp, the landmark update (L, 3) and the cost scalars: about
65 KB at K = 16, L = 2048, never the dense (K, L, 6, 3) coupling (2.36 MB).
The (6K, 6K) solve runs on every rank.

Each rank runs ``ba._solve_phases``, the code ``ba.bundle_adjust`` runs,
with an all-reduce plugged in as its ``reduce_tree``: stereo residuals,
graduated non-convexity and prune-and-repolish behave as on one device.
``reduce_tree`` sums a tree's leaves with ``all_reduce(SUM)``, one flat
buffer per dtype: the bytes JAX's per-leaf ``psum`` moves, in fewer calls.
gloo on the CPU, NCCL on the card; the group is ``multihost.initialize``'s
or one the caller made.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models import ba
from ..models.frontend import resolve_device
from ..ops.camera import Pinhole
from ..utils.tree import tree_leaves, tree_map


def partition_obs_by_landmark(obs_kf, obs_lm, obs_uv, obs_w, n_shards: int,
                              obs_right=None, cap: int | None = None,
                              return_index: bool = False):
    """Reorder an observation table into landmark-coherent equal shards.

    Owner of landmark ``l`` is ``l % n_shards``; shard ``s`` occupies rows
    ``[s*cap, (s+1)*cap)`` of the returned arrays, padded with zero-weight
    rows. ``cap`` defaults to the largest owner group (every live
    observation is kept). Host-side numpy, once per solve.

    Returns (obs_kf, obs_lm, obs_uv, obs_w[, obs_right][, src]) with leading
    dim ``n_shards * cap``; ``src`` maps each output row to its input row
    (-1 for padding).
    """
    obs_kf = np.asarray(obs_kf)
    obs_lm = np.asarray(obs_lm)
    obs_uv = np.asarray(obs_uv)
    obs_w = np.asarray(obs_w)
    live = obs_w > 0
    owner = obs_lm % n_shards
    counts = np.bincount(owner[live], minlength=n_shards)
    if cap is None:
        cap = max(int(counts.max()), 1)
    out_kf = np.zeros(n_shards * cap, np.int32)
    out_lm = np.zeros(n_shards * cap, np.int32)
    out_uv = np.zeros((n_shards * cap, 2), np.float32)
    out_w = np.zeros(n_shards * cap, np.float32)
    out_r = np.zeros(n_shards * cap, bool)
    right = (np.zeros(obs_kf.shape[0], bool) if obs_right is None
             else np.asarray(obs_right))
    src = np.full(n_shards * cap, -1, np.int64)
    for s in range(n_shards):
        rows = np.nonzero(live & (owner == s))[0][:cap]
        dst = slice(s * cap, s * cap + len(rows))
        out_kf[dst] = obs_kf[rows]
        out_lm[dst] = obs_lm[rows]
        out_uv[dst] = obs_uv[rows]
        out_w[dst] = obs_w[rows]
        out_r[dst] = right[rows]
        src[dst] = rows
    out = [out_kf, out_lm, out_uv, out_w]
    if obs_right is not None:
        out.append(out_r)
    if return_index:
        out.append(src)
    return tuple(out)


def all_reduce_tree(tree, group=None):
    """``tree`` (nested dicts / tuples of tensors) with every leaf summed over
    ``group``'s ranks: one ``all_reduce(SUM)`` per dtype, on a flat buffer
    of that dtype's leaves."""
    leaves = tree_leaves(tree)
    summed = {}
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        part = [t for t in leaves if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, piece in zip(part, flat.split([t.numel() for t in part])):
            summed[id(t)] = piece.view(t.shape)
    return tree_map(lambda t: summed[id(t)], tree)


def make_distributed_ba(cam: Pinhole, group, n_kf: int, n_lm: int, n_iters: int = 10,
                        n_fixed: int = 1, huber_px: float = 2.0, gm_polish: bool = True,
                        prune_px: float | None = None, use_stereo: bool = False,
                        device="cuda"):
    """A distributed BA solve over the ranks of ``group`` (None: the default
    group), on ``device`` (``cam``'s tensors must be there; the default
    ``cuda`` raises without a GPU).

    ``solve(poses, points, obs_kf, obs_lm, obs_uv, obs_w, obs_right=None,
    T_rl=None)`` takes the replicated (K, 4, 4) poses and (L, 3) points and
    THIS rank's shard of a landmark-coherent table
    (``partition_obs_by_landmark``'s rows ``[rank*cap, (rank+1)*cap)``).
    With ``use_stereo`` it reads ``obs_right`` (this rank's) and ``T_rl``.
    Returns dict(poses, points, cost_initial, cost_final: the same on every
    rank; obs_w: this rank's weights after pruning).
    """
    dev = resolve_device(device, (cam.fx,), what="distributed BA", inputs="camera")

    def reduce_tree(tree):
        return all_reduce_tree(tree, group)

    def solve(poses, points, obs_kf, obs_lm, obs_uv, obs_w, obs_right=None, T_rl=None):
        for name, t in (("poses", poses), ("points", points)):
            if t.device != dev:
                raise ValueError(f"{name} on {t.device}, the solve on {dev}")
        if poses.shape[0] != n_kf or points.shape[0] != n_lm:
            raise ValueError(f"built for {n_kf} keyframes and {n_lm} landmarks, got "
                             f"{tuple(poses.shape)} and {tuple(points.shape)}")
        p_f, x_f, _, cost_f, cost0, obs_w_f = ba._solve_phases(
            cam, poses, points, obs_kf, obs_lm, obs_uv, obs_w, n_iters, n_fixed, huber_px,
            1e-3, gm_polish, prune_px, obs_right=obs_right if use_stereo else None,
            T_rl=T_rl if use_stereo else None, reduce_tree=reduce_tree, schur_reduce=True)
        return {"poses": p_f, "points": x_f, "cost_initial": cost0, "cost_final": cost_f,
                "obs_w": obs_w_f}

    return solve
