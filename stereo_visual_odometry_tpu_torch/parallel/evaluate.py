"""Batched multi-sequence evaluation: S sequences in one step per card.

Port of ``stereo_visual_odometry_tpu/parallel/evaluate.py`` (BASELINE.json
config 4 as a user-facing entry point): S sequences advance in lockstep through
the batched step of ``sequences.make_batched_frontend``, replayed from its
CUDA graph frame by frame (``sequences.run_chunk_scan``); the frontend and
its graph are kept per (config, rig, device, S) (``sequences.batched_frontend``,
dropped by ``sequences.clear()``). Sequences of different lengths are padded
with their last frame and masked out of the returned trajectories.

Over a ``seq`` mesh of n (``mesh.make_mesh(n)``) the batch splits into n
shards of S/n sequences, one per mesh device, each with its own graph: a
chunk's frames go to each shard's device (only its sequences), every
shard's chunk is queued before the host reads any result, and then T_21
and accept come back from every shard at once (one wait per device).

Streaming: only (S, chunk, H, W) frame blocks exist in host memory at a
time, loaded by a worker thread. A chunk reaches the card ahead of the
replays that read it: with chunk i's replays queued, the host hands chunk
i + 1 to the card and only then waits for chunk i's results, so chunk
i + 1 uploads while chunk i runs; only a pass's first chunk is uploaded
before any replay. On cuda each shard stages through its
``sequences.Staging``, kept with the frontends until
``sequences.clear()``: the worker copies the chunk's host view straight
into the pinned buffer, the copy into device slot (i + 1) % 2 is queued
without waiting on the shard's copy stream, and the compute stream waits
for it (an event) before the chunk's first replay. The host refills the
pinned buffer only once the uploads queued from it have read it, and the
copy stream overwrites a device slot only after the replays that last
read it. On the CPU a chunk is placed as it is (``sequences.to_device``),
in the same order. The pose chain is composed on the host in float64 from
each frame's T_21 and accept, as JAX's is.

RANSAC draws: one ``torch.Generator`` per evaluation, seeded with ``seed``,
draws the (S, num_hypotheses, 6) uniforms of each frame
(``pnp.draw_uniforms``) on the first shard's device, sliced per shard, so a
split run sees the draws of the unsplit one; JAX splits ``PRNGKey(seed)``
into S keys instead, so the two packages draw other numbers from the same
seed.

A pass, its init and each chunk's stages are spans (``evaluate.*``;
``utils/profiling.span``), recorded while a recorder is on:
``evaluate.upload`` is the serial upload of a pass's first chunk,
``evaluate.prefetch`` chunk i + 1's, made between chunk i's
``evaluate.replays`` and ``evaluate.fetch`` (on cuda timed on the first
shard's copy stream: its device time runs from its opening to the end of
that shard's copy); each holds its ``evaluate.load_wait``.

Entry points run on ``device="cuda"`` (the mesh's devices when one is
given) and raise without a GPU; ``device="cpu"`` runs on the CPU, eagerly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from ..ops import pnp
from ..ops.camera import StereoRig
from ..utils import profiling
from ..utils import trajectory as traj_mod
from . import sequences
from .mesh import Mesh, shard_devices


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


@dataclasses.dataclass
class _Chunk:
    """A chunk of ``n`` frames in staging slot ``slot``; ``il`` and ``ir``
    its frames on the devices once placed (``place``'s form)."""

    n: int
    slot: int
    il: object = None
    ir: object = None


class _Uploads:
    """A pass's chunks on their way to the shards' devices. On cuda each
    shard stages through its ``sequences.Staging`` for chunks of ``shape``
    (S per shard, chunk, H, W): ``stage`` (the loader's thread) fills the
    pinned buffers, ``upload`` queues the copies into the chunk's device
    slot and returns its frames, ``ready`` / ``done`` bracket the replays
    that read them. On the CPU ``stage`` places the chunk and the rest do
    nothing."""

    def __init__(self, devs, place, shape: tuple, dtype):
        self.place = place
        self.parts = ([sequences.staging(dev, i, shape, dtype) for i, dev in enumerate(devs)]
                      if devs[0].type == "cuda" else [])

    def stage(self, j: int, il, ir) -> _Chunk:
        chunk = _Chunk(il.shape[1], j % 2)
        if not self.parts:
            chunk.il, chunk.ir = self.place(il), self.place(ir)
            return chunk
        n = len(self.parts)
        for part, l, r in zip(self.parts, sequences.split(il, n), sequences.split(ir, n)):
            part.fill(l, r)
        return chunk

    def upload(self, chunk: _Chunk) -> _Chunk:
        if self.parts:
            pairs = [part.upload(chunk.slot, chunk.n) for part in self.parts]
            chunk.il, chunk.ir = (pairs[0] if len(pairs) == 1
                                  else (sequences.Shards(x) for x in zip(*pairs)))
        return chunk

    def ready(self, chunk: _Chunk) -> None:
        for part in self.parts:
            part.ready(chunk.slot)

    def done(self, chunk: _Chunk) -> None:
        for part in self.parts:
            part.done(chunk.slot)

    def copy_stream(self):
        """The first shard's copy stream made current (a no-op on the CPU)."""
        return torch.cuda.stream(self.parts[0].stream) if self.parts else contextlib.nullcontext()


def _run_streaming(load_chunk: Callable[[int, int], tuple[np.ndarray, np.ndarray]],
                   S: int, T: int, lengths: np.ndarray, cfg, rig: StereoRig,
                   mesh: Mesh | None, chunk: int, seed: int, device):
    """The evaluation loop: chunks loaded on a worker thread and uploaded
    one ahead of the batched step's replays (one step per shard over a
    mesh)."""
    with profiling.span("evaluate.pass"):
        devs = shard_devices(mesh, device)
        init_fn, step_fn, place = sequences.batched_frontend(cfg, rig, S, mesh=mesh, device=device)

        il0, ir0 = load_chunk(0, 1)
        with profiling.span("evaluate.init"):
            state = init_fn(place(il0[:, 0]), place(ir0[:, 0]))
        generator = torch.Generator(device=devs[0]).manual_seed(seed)

        starts = list(range(1, T, chunk))
        cur = np.tile(np.eye(4), (S, 1, 1))
        poses = [cur.copy()]
        accepts = []
        if not starts:  # T == 1: init only, nothing to track
            trajs = [np.stack(poses, axis=1)[s, : int(lengths[s])] for s in range(S)]
            return {"trajectories": trajs, "accept_rate": [0.0] * S,
                    "frames_per_s": 0.0, "wall_s": 0.0}
        uploads = _Uploads(devs, place, (S // len(devs), min(chunk, T - 1)) + il0.shape[2:],
                           il0.dtype)

        def load(j):
            start = starts[j]
            return uploads.stage(j, *load_chunk(start, min(start + chunk, T)))

        for dev in dict.fromkeys(devs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(load, 0)

            def upload(j):
                """Chunk j's copies queued (its load waited for), then chunk
                j + 1's load begun: it refills the pinned buffers once they
                have been read."""
                nonlocal pending
                with profiling.span("evaluate.load_wait"):
                    staged = pending.result()
                frames = uploads.upload(staged)
                if j + 1 < len(starts):
                    pending = pool.submit(load, j + 1)
                return frames

            for i in range(len(starts)):
                with profiling.span("evaluate.chunk"):
                    if i == 0:
                        with profiling.span("evaluate.upload"):
                            frames = upload(0)
                    with profiling.span("evaluate.draws"):
                        u = torch.stack([pnp.draw_uniforms(cfg.num_hypotheses, generator,
                                                           device=devs[0], batch=S)
                                         for _ in range(frames.n)], dim=1)
                    with profiling.span("evaluate.replays"):
                        uploads.ready(frames)
                        state, m = sequences.run_chunk_scan(step_fn, state, frames.il,
                                                            frames.ir, u)
                        uploads.done(frames)
                    if i + 1 < len(starts):
                        with uploads.copy_stream(), profiling.span(
                                "evaluate.prefetch", timed=bool(uploads.parts)):
                            frames = upload(i + 1)
                    with profiling.span("evaluate.fetch"):
                        got = sequences.gather(m, ("T_21", "accept"), axis=1)
                    with profiling.span("evaluate.compose"):
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
      cfg: VOConfig; rig: the shared camera rig, on the (first) device;
        mesh: an optional ``seq`` mesh of n devices, S a multiple of n
        (else ``ValueError``); device: without a mesh.

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
