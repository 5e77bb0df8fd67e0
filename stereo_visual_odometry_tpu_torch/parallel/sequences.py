"""Multi-sequence VO: S independent sequences advanced by one step.

Port of ``stereo_visual_odometry_tpu/parallel/sequences.py`` (BASELINE.json
config 4). The per-frame step is ``torch.func.vmap``-ed over a leading
sequence axis, so every op of a frame carries S sequences' work: one
launch where S would otherwise take S. The kernels' batch rules
(``ops/library.py``) keep K1-K4 at one launch per call; every other op
has a batching rule in PyTorch (the vmap fallback, a loop over S, is
never taken on the LK and ORB paths: ``tests/test_torch_parallel.py``).

``run_chunk_scan`` advances the batch over a frame chunk with the batched
step of ``make_batched_frontend`` (the step that the JAX-parity tests
check); on cuda it replays that step from its CUDA graph
(``models/step_graph.py``, ``batch=S``), captured at the first frame and
kept with the step: the counterpart of the JAX jit cache keyed on the
step's identity. ``batched_frontend`` keeps one batched frontend, and so one
capture, per (config, rig, device, S) for the process, until ``clear()``.
The pose chain is serial per sequence; the S sequences advance in lockstep.

RANSAC draws: the batched step takes (S, num_hypotheses, 6) uniforms
``u``; without them it draws from ``generator`` (``pnp.draw_uniforms``
with ``batch=S``). The JAX package carries one PRNG key per sequence in
the state instead (``split(PRNGKey(seed), S)``); the parity tests inject
its draws. Persistent tracks vmap as well (the slot refill and the ORB id
inheritance have batching rules).

Over a ``seq`` mesh of n (JAX's ``NamedSharding(mesh, P('seq'))``): shard
i takes sequences ``[i*S/n, (i+1)*S/n)`` on ``mesh.devices[i]``, with a
vmapped frontend of its own (the rig on its device, its own
``BatchedStep`` and so its own graph); S not divisible by n raises
``ValueError``, as JAX's ``device_put`` does. A split batch (images, state,
metrics) is a ``Shards`` tuple, one entry per shard; ``gather`` joins
leaves on the host in S order. No collective is needed: ``run_chunk_scan``
queues every shard's replay of frame t before frame t+1 and syncs nothing,
so the cards run side by side and only the host's launches are serial.
The draws of a split batch come from one generator for all S, sliced per
shard: a split run sees the unsplit run's draws.

``Staging`` is one shard's way onto a card for frame chunks: a pinned host
buffer, two device slots and a copy stream, so that one chunk uploads
while the replays read the other (``parallel/evaluate.py``);
``staging`` keeps one per (device, shard position, chunk shape, dtype)
until ``clear()``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models import frontend as frontend_mod
from ..models.step_graph import StepGraph
from ..ops import pnp
from ..ops.camera import Pinhole, StereoRig
from ..utils.hostcopy import device_get_tree
from ..utils.tree import tree_map
from .mesh import Mesh, shard_devices

# (cfg, rig bytes, device, S per shard, shard position) -> one shard's
# make_batched_frontend (init_fn, step_fn, place), the step holding its CUDA
# graph once replayed (``batched_frontend``). The position keeps two shards on
# one device apart: each has its own graph and state buffers.
_cache: dict = {}
# (device, shard position, chunk shape, dtype) -> that shard's ``Staging``.
_staging: dict = {}


class Shards(tuple):
    """A sequence batch split over a mesh of n: entry i is shard i's value
    (sequences ``[i*S/n, (i+1)*S/n)``, on the mesh's i-th device)."""


def shards_of(batch) -> tuple:
    """The per-shard values of ``batch``: its entries if it is ``Shards``,
    else ``(batch,)``."""
    return batch if isinstance(batch, Shards) else (batch,)


def split(batch, n: int) -> tuple:
    """An S-leading array or tensor cut into n equal shards along S (views);
    ``Shards`` of n entries pass through. Raises ``ValueError`` when S is
    not a multiple of n."""
    if isinstance(batch, Shards):
        if len(batch) != n:
            raise ValueError(f"{len(batch)} shards for a mesh of {n}")
        return batch
    S = batch.shape[0]
    if S % n:
        raise ValueError(f"a batch of {S} sequences does not split over {n} shards: S "
                         f"should be divisible by {n}")
    k = S // n
    return tuple(batch[i * k:(i + 1) * k] for i in range(n))


def gather(batch, keys, axis: int = 0) -> dict:
    """``{key: array}`` on the host for each of ``keys`` of a batched state
    or metrics tree (one tree, or ``Shards`` of them), the shards' pieces
    joined along ``axis`` in S order: 0 for a state's (S, ...) leaves, 1
    for ``run_chunk_scan``'s (T, S, ...) metrics. One wait per device."""
    parts = device_get_tree([{k: p[k] for k in keys} for p in shards_of(batch)])
    return {k: np.concatenate([p[k] for p in parts], axis) for k in keys}


def to_device(x, dev: torch.device) -> torch.Tensor:
    """Host or device images as a tensor on ``dev`` (a writable copy of a
    read-only or strided numpy view first)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x.to(dev)


def rig_on(rig: StereoRig, dev: torch.device) -> StereoRig:
    """``rig`` with every tensor on ``dev``."""
    cam = lambda c: Pinhole(c.fx.to(dev), c.fy.to(dev), c.cx.to(dev), c.cy.to(dev))
    return StereoRig(cam(rig.left), cam(rig.right), rig.T_rl.to(dev))


def clear() -> None:
    """Drop every batched frontend ``batched_frontend`` keeps, and with each
    its step's CUDA graph and the graph's memory pool, and every
    ``Staging`` that ``staging`` keeps."""
    _cache.clear()
    _staging.clear()


class Staging:
    """One shard's frame chunks on their way to a card: a pinned host buffer,
    two device slots and a copy stream of its own, each buffer holding a
    chunk's left and right frames (``shape`` = (S, chunk, H, W) each; a
    chunk of n <= chunk frames is one contiguous prefix).

    ``fill(il, ir)`` (any thread) copies a host chunk into the pinned
    buffer, first waiting for every upload queued so far to have read it;
    ``upload(k, n)`` queues the copy of the pinned buffer into device slot k
    on the copy stream, ordered after the compute stream's last read of
    slot k (``done``), and returns slot k's frames without waiting;
    ``ready(k)`` orders the device's current (compute) stream after that
    copy, ``done(k)`` marks the end of its reads of slot k. One pinned
    buffer is enough: chunk i + 1 is filled while chunk i's replays run,
    long after chunk i's copy has left it."""

    def __init__(self, dev: torch.device, shape: tuple, dtype: torch.dtype):
        self.device, self.shape = dev, tuple(shape)
        size = 2 * math.prod(shape)
        self.stream = torch.cuda.Stream(dev)
        self.host = torch.empty(size, dtype=dtype, pin_memory=True)
        self.dev = [torch.empty(size, dtype=dtype, device=dev) for _ in range(2)]
        for buf in self.dev:  # written on the copy stream: freed only once its copies are done
            buf.record_stream(self.stream)
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.read = [torch.cuda.Event() for _ in range(2)]

    def _pair(self, buf: torch.Tensor, n: int) -> tuple:
        S, _, H, W = self.shape
        m = S * n * H * W
        return buf[:m].view(S, n, H, W), buf[m:2 * m].view(S, n, H, W)

    def fill(self, il, ir) -> None:
        for event in self.copied:
            event.synchronize()
        for dst, src in zip(self._pair(self.host, il.shape[1]), (il, ir)):
            np.copyto(dst.numpy(), src, casting="no")

    def upload(self, k: int, n: int) -> tuple:
        m = 2 * n * math.prod(self.shape) // self.shape[1]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self.read[k])
            self.dev[k][:m].copy_(self.host[:m], non_blocking=True)
            self.copied[k].record(self.stream)
        return self._pair(self.dev[k], n)

    def ready(self, k: int) -> None:
        torch.cuda.current_stream(self.device).wait_event(self.copied[k])

    def done(self, k: int) -> None:
        self.read[k].record(torch.cuda.current_stream(self.device))


def staging(dev: torch.device, position: int, shape: tuple, dtype) -> Staging:
    """Shard ``position``'s ``Staging`` on ``dev`` for chunks of ``shape``
    (S per shard, chunk, H, W) of ``dtype`` (numpy's or torch's), made at
    first use and kept until ``clear()``."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    key = (dev, position, tuple(shape), dtype)
    if key not in _staging:
        _staging[key] = Staging(dev, shape, dtype)
    return _staging[key]


def rig_bytes(rig: StereoRig) -> tuple:
    """The rig's values as bytes: a cache key that two equal rigs share."""
    leaves = [getattr(cam, k) for cam in (rig.left, rig.right) for k in ("fx", "fy", "cx", "cy")]
    return tuple(t.detach().cpu().numpy().tobytes() for t in leaves + [rig.T_rl])


class BatchedStep:
    """The batched step of ``make_batched_frontend``: ``step(state, imgs_l,
    imgs_r, u=None) -> (state, metrics)`` runs the vmapped per-sequence step
    eagerly, ``u`` the (S, num_hypotheses, 6) draws (from ``generator`` if
    None); ``step.graph(S)`` is the CUDA graph of that same call for S
    sequences, made once per S and kept with the step."""

    def __init__(self, cfg: frontend_mod.VOConfig, step_one, device: torch.device,
                 generator: torch.Generator | None):
        self.cfg, self.device = cfg, device
        self._vstep = torch.func.vmap(step_one)
        self._generator = generator
        self._graphs: dict[int, StepGraph] = {}

    def __call__(self, state, imgs_l, imgs_r, u=None):
        imgs_l, imgs_r = to_device(imgs_l, self.device), to_device(imgs_r, self.device)
        if u is None:
            u = pnp.draw_uniforms(self.cfg.num_hypotheses, self._generator, device=self.device,
                                  batch=imgs_l.shape[0])
        return self._vstep(state, imgs_l, imgs_r, u)

    def graph(self, batch: int) -> StepGraph:
        """The step's CUDA graph for ``batch`` sequences (captured at its
        first replay)."""
        graph = self._graphs.get(batch)
        if graph is None:
            # The graph runs the vmapped step itself (its images are on the
            # device, its draws given), not this object: a graph holding its
            # owner would sit in a reference cycle, freed by the collector at
            # any time, even in the middle of another graph's capture, which
            # that capture does not survive.
            graph = self._graphs[batch] = StepGraph(self._vstep, self.cfg, self.device,
                                                    batch=batch)
        return graph


class ShardedStep:
    """The batched step over a mesh: ``step(state, imgs_l, imgs_r, u=None)``
    runs each shard's ``BatchedStep`` (``shards``) on its slice of the
    batch; ``state`` and the results are ``Shards``, the images S-leading
    or ``Shards``. ``u`` (S, num_hypotheses, 6), drawn from ``generator``
    on the first shard's device for all S if None, is sliced per shard."""

    def __init__(self, shards, generator: torch.Generator | None):
        self.shards = tuple(shards)
        self.cfg, self.device = self.shards[0].cfg, self.shards[0].device
        self._generator = generator

    def draws(self, u: torch.Tensor) -> Shards:
        """S-leading draws cut per shard, each on its shard's device."""
        return Shards(p.to(s.device) for p, s in zip(split(u, len(self.shards)), self.shards))

    def __call__(self, state, imgs_l, imgs_r, u=None):
        n = len(self.shards)
        if u is None:
            u = pnp.draw_uniforms(self.cfg.num_hypotheses, self._generator, device=self.device,
                                  batch=sum(p.shape[0] for p in split(imgs_l, n)))
        outs = [step(st, l, r, uu) for step, st, l, r, uu in
                zip(self.shards, split(state, n), split(imgs_l, n), split(imgs_r, n),
                    self.draws(u))]
        return Shards(o[0] for o in outs), Shards(o[1] for o in outs)


def _sharded(parts, generator: torch.Generator | None):
    """(init_fn, step_fn, place) over the per-shard frontends ``parts``
    (each make_batched_frontend's triple on one device)."""
    n = len(parts)

    def place(imgs) -> Shards:
        return Shards(pl(x) for (_, _, pl), x in zip(parts, split(imgs, n)))

    def init_fn(imgs_l, imgs_r) -> Shards:
        return Shards(init(l, r) for (init, _, _), l, r in zip(parts, place(imgs_l),
                                                               place(imgs_r)))

    return init_fn, ShardedStep([step for _, step, _ in parts], generator), place


def _one_device(cfg: frontend_mod.VOConfig, rig: StereoRig, dev: torch.device,
                generator: torch.Generator | None):
    init_one, step_one = frontend_mod.make_frontend(cfg, rig, device=dev)
    vinit = torch.func.vmap(init_one)

    def place(imgs) -> torch.Tensor:
        return to_device(imgs, dev)

    def init_fn(imgs_l, imgs_r):
        return vinit(place(imgs_l), place(imgs_r))

    return init_fn, BatchedStep(cfg, step_one, dev, generator), place


def make_batched_frontend(cfg: frontend_mod.VOConfig, rig: StereoRig, mesh: Mesh | None = None,
                          device="cuda", generator: torch.Generator | None = None):
    """(init_fn, step_fn, place) vmapped over a leading sequence axis, on
    ``mesh``'s devices (or ``device`` without a mesh).

    init_fn: (imgs_l (S, H, W), imgs_r (S, H, W)) -> state (every leaf
      S-leading);
    step_fn: a ``BatchedStep``, (state, imgs_l, imgs_r, u=None) -> (state,
      metrics), eager; ``u`` the (S, num_hypotheses, 6) draws, from
      ``generator`` if None; ``run_chunk_scan`` replays it from its graph;
    place: host or device images -> a tensor on the device.

    A mesh of n > 1 builds one such frontend per shard, the rig copied to
    each shard's device (the first shard takes it as given, on its device):
    ``place`` and ``init_fn`` then return ``Shards`` and ``step_fn`` is a
    ``ShardedStep``.
    """
    devs = shard_devices(mesh, device)
    if len(devs) == 1:
        return _one_device(cfg, rig, devs[0], generator)
    return _sharded([_one_device(cfg, rig if i == 0 else rig_on(rig, dev), dev, None)
                     for i, dev in enumerate(devs)], generator)


def batched_frontend(cfg: frontend_mod.VOConfig, rig: StereoRig, batch: int,
                     mesh: Mesh | None = None, device="cuda"):
    """``make_batched_frontend(cfg, rig, mesh, device)`` for ``batch``
    sequences, each shard's made once per (cfg, rig bytes, device, batch
    per shard, shard position) and kept, with its step's CUDA graph, until
    ``clear()``: a frontend made anew per evaluation would capture anew per
    call. Raises ``ValueError`` when ``batch`` does not split over the
    mesh."""
    devs = shard_devices(mesh, device)
    n = len(devs)
    if batch % n:
        raise ValueError(f"a batch of {batch} sequences does not split over {n} shards: S "
                         f"should be divisible by {n}")
    parts = []
    for i, dev in enumerate(devs):
        key = (cfg, rig_bytes(rig), dev, batch // n, i)
        if key not in _cache:
            _cache[key] = _one_device(cfg, rig if i == 0 else rig_on(rig, dev), dev, None)
        parts.append(_cache[key])
    return parts[0] if n == 1 else _sharded(parts, None)


def run_chunk_scan(step, state, imgs_l, imgs_r, u: torch.Tensor, graph: bool = True):
    """Advance a batch of sequences over a chunk of T frames.

    Args:
      step: the batched step (``make_batched_frontend``'s ``step_fn``: a
        ``BatchedStep``, or a ``ShardedStep`` over a mesh). JAX's takes the
        per-sequence step and vmaps it inside its jit; here the vmap is the
        frontend's, so a chunk runs the step the parity tests check.
      state: batched state (leading S axis; ``Shards`` over a mesh).
      imgs_l / imgs_r: (S, T, H, W) frame chunks on the state's device, or
        over a mesh ``place``'s ``Shards`` of them.
      u: (S, T, num_hypotheses, 6) RANSAC draws for the whole batch (over a
        mesh sliced per shard and copied to its device).
      graph: on cuda, replay the step from its CUDA graph (``step.graph(S)``,
        the default; one graph per shard), False runs it eagerly (the A/B
        switch). The CPU runs eagerly.

    Returns (state, metrics): the ``frontend.FRAME_KEEP`` metrics with
    leading (T, S) axes (both ``Shards`` over a mesh). The state returned
    is the caller's own (under the graph a copy of the graph's buffers,
    which the next chunk overwrites). Over a mesh every shard's frame t is
    queued before any shard's frame t + 1, and nothing waits for a device.
    """
    sharded = isinstance(step, ShardedStep)
    steps = step.shards if sharded else (step,)
    n = len(steps)
    if sharded:
        states, ils, irs = list(split(state, n)), split(imgs_l, n), split(imgs_r, n)
    else:
        states, ils, irs = [state], (imgs_l,), (imgs_r,)
    S, T = sum(x.shape[0] for x in ils), ils[0].shape[1]
    if u.shape[:2] != (S, T):
        raise ValueError(f"u must be (S, T, num_hypotheses, 6) = ({S}, {T}, ...), got "
                         f"{tuple(u.shape)}")
    us = step.draws(u) if sharded else (u,)
    use_graph = graph and ils[0].device.type == "cuda"
    graphs = [st.graph(x.shape[0]) for st, x in zip(steps, ils)] if use_graph else []
    for g, st in zip(graphs, states):
        g.load_state(st)
    outs = [{} for _ in steps]
    for t in range(T):
        for i in range(n):
            if use_graph:
                frame = graphs[i].replay(ils[i][:, t], irs[i][:, t], us[i][:, t])
            else:
                states[i], m = steps[i](states[i], ils[i][:, t], irs[i][:, t], us[i][:, t])
                frame = frontend_mod.frame_outputs(states[i], m)
            out = outs[i]
            if not out:
                out.update({k: v.new_empty((T,) + v.shape) for k, v in frame.items()})
            for k, v in frame.items():
                out[k][t].copy_(v)
    if use_graph:
        states = [tree_map(torch.clone, g.state) for g in graphs]
    if sharded:
        return Shards(states), Shards(outs)
    return states[0], outs[0]
