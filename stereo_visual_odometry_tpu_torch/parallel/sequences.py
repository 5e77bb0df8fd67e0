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

One device: a mesh of more than one raises (``mesh.single_device``).
"""
from __future__ import annotations

import torch

from ..models import frontend as frontend_mod
from ..models.step_graph import StepGraph
from ..ops import pnp
from ..ops.camera import StereoRig
from ..utils.tree import tree_map
from .mesh import Mesh, single_device

# (cfg, rig bytes, device, S) -> make_batched_frontend's (init_fn, step_fn,
# place), the step holding its CUDA graph once replayed (``batched_frontend``).
_cache: dict = {}


def clear() -> None:
    """Drop every batched frontend ``batched_frontend`` keeps, and with each
    its step's CUDA graph and the graph's memory pool."""
    _cache.clear()


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
        imgs_l = torch.as_tensor(imgs_l, device=self.device)
        imgs_r = torch.as_tensor(imgs_r, device=self.device)
        if u is None:
            u = pnp.draw_uniforms(self.cfg.num_hypotheses, self._generator, device=self.device,
                                  batch=imgs_l.shape[0])
        return self._vstep(state, imgs_l, imgs_r, u)

    def graph(self, batch: int) -> StepGraph:
        """The step's CUDA graph for ``batch`` sequences (captured at its
        first replay)."""
        graph = self._graphs.get(batch)
        if graph is None:
            graph = self._graphs[batch] = StepGraph(self, self.cfg, self.device, batch=batch)
        return graph


def make_batched_frontend(cfg: frontend_mod.VOConfig, rig: StereoRig, mesh: Mesh | None = None,
                          device="cuda", generator: torch.Generator | None = None):
    """(init_fn, step_fn, place) vmapped over a leading sequence axis, on
    ``mesh``'s one device (or ``device`` without a mesh).

    init_fn: (imgs_l (S, H, W), imgs_r (S, H, W)) -> state (every leaf
      S-leading);
    step_fn: a ``BatchedStep``, (state, imgs_l, imgs_r, u=None) -> (state,
      metrics), eager; ``u`` the (S, num_hypotheses, 6) draws, from
      ``generator`` if None; ``run_chunk_scan`` replays it from its graph;
    place: host or device images -> a tensor on the device.
    """
    dev = single_device(mesh, device)
    init_one, step_one = frontend_mod.make_frontend(cfg, rig, device=dev)
    vinit = torch.func.vmap(init_one)

    def place(imgs) -> torch.Tensor:
        return torch.as_tensor(imgs, device=dev)

    def init_fn(imgs_l, imgs_r):
        return vinit(place(imgs_l), place(imgs_r))

    return init_fn, BatchedStep(cfg, step_one, dev, generator), place


def batched_frontend(cfg: frontend_mod.VOConfig, rig: StereoRig, batch: int,
                     mesh: Mesh | None = None, device="cuda"):
    """``make_batched_frontend(cfg, rig, mesh, device)`` for ``batch``
    sequences, made once per (cfg, rig bytes, device, batch) and kept, with
    its step's CUDA graph, until ``clear()``: a frontend made anew per
    evaluation would capture anew per call."""
    dev = single_device(mesh, device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (cfg, rig_bytes(rig), dev, batch)
    if key not in _cache:
        _cache[key] = make_batched_frontend(cfg, rig, device=dev)
    return _cache[key]


def run_chunk_scan(step: BatchedStep, state: dict, imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                   u: torch.Tensor, graph: bool = True):
    """Advance a batch of sequences over a chunk of T frames.

    Args:
      step: the batched step (``make_batched_frontend``'s ``step_fn``). JAX's
        takes the per-sequence step and vmaps it inside its jit; here the
        vmap is the frontend's, so a chunk runs the step the parity tests
        check.
      state: batched state (leading S axis).
      imgs_l / imgs_r: (S, T, H, W) frame chunks on the state's device.
      u: (S, T, num_hypotheses, 6) RANSAC draws.
      graph: on cuda, replay the step from its CUDA graph (``step.graph(S)``,
        the default); False runs it eagerly (the A/B switch). The CPU runs
        eagerly.

    Returns (state, metrics): the ``frontend.FRAME_KEEP`` metrics with
    leading (T, S) axes. The state returned is the caller's own (under the
    graph a copy of the graph's buffers, which the next chunk overwrites).
    """
    S, T = imgs_l.shape[:2]
    if u.shape[:2] != (S, T):
        raise ValueError(f"u must be (S, T, num_hypotheses, 6) = ({S}, {T}, ...), got "
                         f"{tuple(u.shape)}")
    use_graph = graph and imgs_l.device.type == "cuda"
    if use_graph:
        g = step.graph(S)
        g.load_state(state)
    out = {}
    for t in range(T):
        if use_graph:
            frame = g.replay(imgs_l[:, t], imgs_r[:, t], u[:, t])
        else:
            state, m = step(state, imgs_l[:, t], imgs_r[:, t], u[:, t])
            frame = frontend_mod.frame_outputs(state, m)
        if not out:
            out = {k: v.new_empty((T,) + v.shape) for k, v in frame.items()}
        for k, v in frame.items():
            out[k][t].copy_(v)
    if use_graph:
        state = tree_map(torch.clone, g.state)
    return state, out
