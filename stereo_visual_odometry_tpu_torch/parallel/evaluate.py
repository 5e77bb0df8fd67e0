"""Batched multi-sequence evaluation: S sequences in one step on one card.

Port of ``stereo_visual_odometry_tpu/parallel/evaluate.py`` (BASELINE.json
config 4 as a user-facing entry point): S sequences advance in lockstep through
the batched step of ``sequences.make_batched_frontend``, replayed from its
CUDA graph frame by frame (``sequences.run_chunk_scan``); the frontend and
its graph are kept per (config, rig, device, S) (``sequences.batched_frontend``,
dropped by ``sequences.clear()``). Sequences of different lengths are padded
with their last frame and masked out of the returned trajectories.

Streaming: only (S, chunk, H, W) frame blocks exist in host memory at a
time, loaded by a worker thread while the previous chunk runs (double
buffering). The pose chain is composed on the host in float64 from each
frame's T_21 and accept, as JAX's is.

RANSAC draws: one ``torch.Generator`` per evaluation, seeded with ``seed``,
draws the (S, num_hypotheses, 6) uniforms of each frame
(``pnp.draw_uniforms``); JAX splits ``PRNGKey(seed)`` into S keys instead,
so the two packages draw other numbers from the same seed.

Entry points run on ``device="cuda"`` (the mesh's device when one is given)
and raise without a GPU; ``device="cpu"`` runs on the CPU, eagerly.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from ..ops import pnp
from ..ops.camera import StereoRig
from ..utils import trajectory as traj_mod
from ..utils.hostcopy import device_get_tree
from . import sequences
from .mesh import Mesh, single_device

def _compose_chunk(cur: np.ndarray, T21: np.ndarray, acc: np.ndarray,
                   poses: list) -> np.ndarray:
    """Advance the (S, 4, 4) pose chain through one chunk, vectorized over S:
    serial in t, each step a batched 4x4 inverse and product (float64)."""
    inv = np.linalg.inv(T21)                      # (T, S, 4, 4)
    for t in range(T21.shape[0]):
        upd = np.einsum("sij,sjk->sik", cur, inv[t])
        cur = np.where(acc[t][:, None, None], upd, cur)
        poses.append(cur.copy())
    return cur


def _resolve(mesh: Mesh | None, device) -> torch.device:
    dev = single_device(mesh, device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"evaluating on {str(dev)!r} needs an NVIDIA GPU and "
                               "torch.cuda.is_available() is False; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _run_streaming(load_chunk: Callable[[int, int], tuple[np.ndarray, np.ndarray]],
                   S: int, T: int, lengths: np.ndarray, cfg, rig: StereoRig,
                   mesh: Mesh | None, chunk: int, seed: int, device):
    """The evaluation loop: double-buffered chunk loads feeding the batched
    step."""
    dev = _resolve(mesh, device)
    init_fn, step_fn, _ = sequences.batched_frontend(cfg, rig, S, device=dev)

    def put(x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):  # a writable copy of a read-only view
            x = torch.from_numpy(np.require(x, requirements=("C", "W")))
        return x.to(dev)

    il0, ir0 = load_chunk(0, 1)
    state = init_fn(put(il0[:, 0]), put(ir0[:, 0]))
    generator = torch.Generator(device=dev).manual_seed(seed)

    starts = list(range(1, T, chunk))
    cur = np.tile(np.eye(4), (S, 1, 1))
    poses = [cur.copy()]
    accepts = []
    if not starts:  # T == 1: init only, nothing to track
        trajs = [np.stack(poses, axis=1)[s, : int(lengths[s])] for s in range(S)]
        return {"trajectories": trajs, "accept_rate": [0.0] * S,
                "frames_per_s": 0.0, "wall_s": 0.0}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(load_chunk, starts[0], min(starts[0] + chunk, T))
        for i, start in enumerate(starts):
            il_c, ir_c = fut.result()
            if i + 1 < len(starts):
                nxt = starts[i + 1]
                fut = pool.submit(load_chunk, nxt, min(nxt + chunk, T))
            n = il_c.shape[1]
            u = torch.stack([pnp.draw_uniforms(cfg.num_hypotheses, generator, device=dev,
                                               batch=S) for _ in range(n)], dim=1)
            state, m = sequences.run_chunk_scan(step_fn, state, put(il_c), put(ir_c), u)
            got = device_get_tree({"T_21": m["T_21"], "accept": m["accept"]})
            T21 = got["T_21"].astype(np.float64)      # (T_chunk, S, 4, 4)
            acc = got["accept"]                       # (T_chunk, S)
            cur = _compose_chunk(cur, T21, acc, poses)
            accepts.append(acc)
    wall = time.perf_counter() - t0

    all_poses = np.stack(poses, axis=1)               # (S, T, 4, 4)
    acc = np.concatenate(accepts, axis=0)             # (T-1, S)
    trajs = [all_poses[s, : int(lengths[s])] for s in range(S)]
    total_frames = int(np.sum(lengths) - S)
    return {
        "trajectories": trajs,
        "accept_rate": [float(acc[: int(lengths[s]) - 1, s].mean()) for s in range(S)],
        "frames_per_s": total_frames / wall if wall > 0 else 0.0,
        "wall_s": wall,
    }


def evaluate_batch(images_l: np.ndarray, images_r: np.ndarray, lengths: np.ndarray, cfg,
                   rig: StereoRig, mesh: Mesh | None = None, chunk: int = 8, seed: int = 0,
                   device="cuda"):
    """Run VO over an in-memory batch of sequences.

    Args:
      images_l / images_r: (S, T_max, H, W) frame batches (short sequences
        padded by repeating their last frame).
      lengths: (S,) true sequence lengths.
      cfg: VOConfig; rig: the shared camera rig, on the device; mesh: an
        optional one-device ``seq`` mesh; device: without a mesh.

    Returns:
      dict(trajectories: list of (length_s, 4, 4) world_from_camera arrays,
           accept_rate per sequence, frames_per_s aggregate over the S
           sequences (tracked frames / wall), wall_s).
    """
    S, T = images_l.shape[:2]

    def load_chunk(start, end):
        return images_l[:, start:end], images_r[:, start:end]

    return _run_streaming(load_chunk, S, T, np.asarray(lengths), cfg, rig, mesh, chunk, seed,
                          device)


def evaluate_kitti_dirs(seq_dirs: list[str], cfg, rig: StereoRig, mesh: Mesh | None = None,
                        chunk: int = 8, gt_files: list[str] | None = None, seed: int = 0,
                        device="cuda"):
    """Stream KITTI sequence directories through the batch evaluator.

    Frames are decoded from disk chunk by chunk on a worker thread
    (sequences shorter than the longest repeat their last frame), so host
    memory holds ~S * chunk * H * W * 4 bytes of frames whatever the
    sequences' lengths. With ``gt_files`` (KITTI pose files) the result also
    holds each sequence's aligned ATE (``ate``).
    """
    from ..utils.kitti import KittiStereoDataset

    datasets = [KittiStereoDataset(d, static_hw=(cfg.height, cfg.width)) for d in seq_dirs]
    lengths = np.array([len(d) for d in datasets])
    T = int(lengths.max())
    S = len(datasets)

    def load_chunk(start, end):
        n = end - start
        il = np.empty((S, n, cfg.height, cfg.width), np.float32)
        ir = np.empty_like(il)
        for s, ds in enumerate(datasets):
            for k, t in enumerate(range(start, end)):
                l, r = ds[min(t, len(ds) - 1)]
                il[s, k] = l
                ir[s, k] = r
        return il, ir

    out = _run_streaming(load_chunk, S, T, lengths, cfg, rig, mesh, chunk, seed, device)
    if gt_files:
        out["ate"] = []
        for traj, gt_file in zip(out["trajectories"], gt_files):
            gt = traj_mod.load_kitti(gt_file)
            n = min(len(gt), len(traj))
            out["ate"].append(traj_mod.ate_rmse(traj[:n], gt[:n]))
    return out
