"""Driver: S sequences through ``parallel.evaluate.evaluate_batch`` in passes.

Sequence s of a pass runs the lap's frames from ``first + s * (lap_frames //
S)`` on, for ``frames_per_sequence`` frames (a strided view of the rendered
lap: no frame is copied); ``first``, below the stride, comes from the seed.
Every pass runs the same sequences with RANSAC draws of its own, seeded from
``--seed``. A warm pass of one chunk captures the step's graph
(one per shard over a mesh of the cell's cards); the evaluator keeps it per
(config, rig, device, S). The window runs from the first timed pass's start
to the end of the last pass begun before ``--seconds`` ran out. The frames'
``n_tracked`` are taken from each chunk's outputs as the evaluator receives
them (a reference kept, nothing copied) and read once the window has closed.
A traced run profiles, in one more pass of the window's own shape, one
steady period: from the second chunk's replays to the third's, so the
chunk's replays, the gather and pose composition after them and the next
chunk's upload.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import trace
from ..session import derived_seed, sync


def batch_view(frames: np.ndarray, stride: int, S: int, L: int) -> np.ndarray:
    """(S, L, H, W) read-only view of (N, H, W) ``frames``: sequence s is
    frames[s*stride : s*stride + L]."""
    n, h, w = frames.shape
    if (S - 1) * stride + L > n:
        raise ValueError(f"{S} sequences of {L} frames {stride} apart need "
                         f"{(S - 1) * stride + L} frames, the lap holds {n}")
    st = frames.strides
    return np.lib.stride_tricks.as_strided(frames, (S, L, h, w), (stride * st[0], *st),
                                           writeable=False)


@contextlib.contextmanager
def tracked_counts(sequences, kept: list):
    """While open, each chunk's metrics that ``sequences.run_chunk_scan``
    returns ((T, S) leaves, or shards of them) are kept in ``kept``."""
    scan = sequences.run_chunk_scan

    def keeping(*args, **kw):
        state, m = scan(*args, **kw)
        kept.append(m)
        return state, m
    sequences.run_chunk_scan = keeping
    try:
        yield kept
    finally:
        sequences.run_chunk_scan = scan


@contextlib.contextmanager
def steady_period(sequences, span):
    """While open, ``span`` is started as the second chunk of a pass begins
    its replays and stopped as the third begins its own."""
    scan, calls = sequences.run_chunk_scan, []

    def spanning(*args, **kw):
        calls.append(None)
        if len(calls) == 2:
            span.start()
        elif len(calls) == 3:
            span.stop()
        return scan(*args, **kw)
    sequences.run_chunk_scan = spanning
    try:
        yield
    finally:
        sequences.run_chunk_scan = scan


def run(cell) -> dict:
    from stereo_visual_odometry_tpu_torch.parallel import evaluate, sequences
    from stereo_visual_odometry_tpu_torch.parallel.mesh import Mesh
    from stereo_visual_odometry_tpu_torch.utils.config import rig_from_config

    t = cell.traffic
    S, L, chunk = t["sequences"], t["frames_per_sequence"], t["chunk"]
    stride = len(cell.lap["poses"]) // S
    first = cell.start % stride
    il, ir = (batch_view(cell.lap[k][first:], stride, S, L) for k in ("left", "right"))
    devs = cell.devices
    mesh = Mesh(tuple(devs), "seq") if len(devs) > 1 else None
    rig = rig_from_config(cell.cam, device=devs[0])

    def evaluate_pass(left, right, n, seed):
        return evaluate.evaluate_batch(left, right, np.full(S, n), cell.vo, rig, mesh=mesh,
                                       chunk=chunk, seed=seed, device=devs[0])

    evaluate_pass(il[:, :1 + chunk], ir[:, :1 + chunk], 1 + chunk,
                  derived_seed(cell.seed, "warm"))
    sync(devs)

    pieces, frames, rejected, passes, kept = [], 0, 0, 0, []
    with tracked_counts(sequences, kept):
        t0 = time.perf_counter()
        while passes == 0 or time.perf_counter() - t0 < cell.seconds:
            out = evaluate_pass(il, ir, L, derived_seed(cell.seed, passes))
            for s in range(S):
                pieces.append((first + s * stride + np.arange(L), out["trajectories"][s]))
                rejected += int(round((1.0 - out["accept_rate"][s]) * (L - 1)))
            frames += S * L
            passes += 1
        window = time.perf_counter() - t0
    res = {"t_first": t0, "window_s": window, "frames": frames, "failed": rejected,
           "rejected": rejected, "answered": passes * S * (L - 1), "pieces": pieces,
           "passes": passes, "memory_peak_bytes": cell.memory_peak()}
    graphs = []
    if devs[0].type == "cuda":
        step = sequences.batched_frontend(cell.vo, rig, S, mesh=mesh, device=devs[0])[1]
        graphs = [part.graph(S // len(devs)) for part in getattr(step, "shards", (step,))]
    cell.check_kernels(graphs)
    res["kernels"] = cell.kernels
    res["tracked"] = [int(n) for m in kept
                      for n in sequences.gather(m, ("n_tracked",), axis=1)["n_tracked"].ravel()]
    del kept
    if cell.trace:
        if L <= 2 * chunk + 1:
            raise ValueError(f"a traced pass needs three chunks; {L} frames hold "
                             f"{-(-(L - 1) // chunk)}")

        def traced_pass(span):
            with steady_period(sequences, span):
                evaluate_pass(il, ir, L, derived_seed(cell.seed, "trace"))
        res["stretch"] = trace.stretch(traced_pass, devs, spans=True)
        res["graphs"] = graphs
    return res
