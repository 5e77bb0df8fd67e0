"""The window solve (``ba.bundle_adjust``) captured in a CUDA graph and replayed.

Eagerly a window solve is ~11,800 small device ops, each issued by the host
in turn, and the card idles between them; replayed from a graph it is one
``cudaGraphLaunch``. ``SolveGraph`` stands in for ``ba.bundle_adjust`` on
the card: it takes the same keyword arguments and returns the same dict
(``lm_iters`` a host int). What it captures is ``ba.bundle_adjust`` itself,
so the LM, the GNC schedule and the prune are one implementation.

One graph per problem key (``problem_key``): the device and dtype and the
shape of every tensor input (the camera's and the prior's too), which of the
optional inputs are given, and the scalars (``n_iters``, ``n_fixed``,
``huber_px``, ``init_damping``, ``prune_px``, ``gm_polish``). The backend
pads its window to fixed capacities, so a backend makes two keys: no prior
(before its first slide) and a prior.

A key's first call puts the problem into static input buffers, solves it
once eagerly on a side stream (the warm-up: the solver libraries load and
their workspaces are allocated), captures the solve on those buffers on the
same stream, then replays as every later call does. A call copies the
caller's tensors into the static inputs, the camera's 0-d tensors too (its
values are inputs of the graph, not constants in it), replays on the current
stream and returns clones of the static outputs: a caller that keeps results
by reference (``SlidingWindowBA.log``) keeps each solve's own. The copies are
device to device and nothing waits on the host. The graph's memory pool goes
with the object.

There is no fallback: a failed capture raises.

Spans (``utils/profiling``): ``backend.capture`` (a key's warm-up and
capture) and ``backend.replay`` (the copies in, the launch, the clones out;
a CUDA event pair), both inside the backend's ``backend.lm``. Counters:
``captures`` and ``replays``.
"""
from __future__ import annotations

import dataclasses
import inspect

import torch

from . import ba
from ..utils import profiling

_SIGNATURE = inspect.signature(ba.bundle_adjust)


def _arguments(problem: dict) -> dict:
    """``bundle_adjust``'s keyword arguments with its defaults filled in
    (a TypeError for one it does not take)."""
    bound = _SIGNATURE.bind(**problem)
    bound.apply_defaults()
    return bound.arguments


def _map(fn, value):
    """``value`` with ``fn`` applied to each tensor in it: tensors, dicts
    (the prior, its keys in sorted order) and dataclasses (the camera) of
    them; scalars and None as they are."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, dict):
        return {k: _map(fn, value[k]) for k in sorted(value)}
    if dataclasses.is_dataclass(value):
        return type(value)(**{f.name: _map(fn, getattr(value, f.name))
                              for f in dataclasses.fields(value)})
    return value


def _leaves(args: dict) -> list[torch.Tensor]:
    out = []
    _map(lambda t: out.append(t) or t, args)
    return out


def _spec(value):
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), value.dtype, value.device)
    if isinstance(value, dict):
        return tuple((k, _spec(value[k])) for k in sorted(value))
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,) + tuple(_spec(getattr(value, f.name))
                                               for f in dataclasses.fields(value))
    return value


def _key(args: dict) -> tuple:
    return tuple((name, _spec(v)) for name, v in args.items())


def problem_key(problem: dict) -> tuple:
    """The key of a solve's graph: each of ``bundle_adjust``'s arguments
    (defaults filled in) by name, a tensor as its shape, dtype and device,
    a dict or the camera as the keys and specs of its tensors, None and
    the scalars as they are."""
    return _key(_arguments(problem))


class _Captured:
    """One key's static inputs, graph and static outputs."""

    def __init__(self, args: dict):
        dev = args["poses"].device
        self.inputs = _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev), args)
        self._static = _leaves(self.inputs)
        self._load(args)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            ba.bundle_adjust(**self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.out = ba.bundle_adjust(**self.inputs)

    def _load(self, args: dict) -> None:
        for dst, src in zip(self._static, _leaves(args), strict=True):
            dst.copy_(src)

    def replay(self, args: dict) -> dict:
        self._load(args)
        self.graph.replay()
        return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in self.out.items()}


class SolveGraph:
    """``ba.bundle_adjust`` on the card, one CUDA graph per problem key
    (``problem_key``), captured at the key's first call. ``captures`` and
    ``replays`` count the graphs captured and the calls replayed (every
    call, the capturing one too)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._graphs: dict[tuple, _Captured] = {}

    def __call__(self, **problem) -> dict:
        args = _arguments(problem)
        dev = args["poses"].device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a cuda device, got {dev}")
        key = _key(args)
        with torch.cuda.device(dev):
            captured = self._graphs.get(key)
            if captured is None:
                with profiling.span("backend.capture"):
                    captured = _Captured(args)
                self._graphs[key] = captured
                self.captures += 1
            with profiling.span("backend.replay", timed=True):
                out = captured.replay(args)
        self.replays += 1
        return out
