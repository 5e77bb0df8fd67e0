"""The frontend step captured once in a CUDA graph and replayed per frame.

The port's counterpart of ``jax.jit`` on the step (JAX
``models/frontend.py:208,246,414,440``) and of the chunk scan
(``make_chunked_frontend``, ``:563-588``): eagerly a frame is ~20k kernel
launches, each paying the host's time; replayed from a graph it is one
``cudaGraphLaunch``.

``StepGraph`` owns static buffers: the pair (``img_l``, ``img_r``), the
RANSAC draws ``u``, the frontend state (``state``) and the frame's
``frontend.frame_outputs`` (``out``; with ``overlays``, fixed when the
graph is built, also the overlay dump's ``OVERLAY_KEEP``). The caller
loads a state with ``load_state`` (the graph's state buffers are the live
state: a reinit copies into them) and advances with ``replay``, handing it
the draws (the caller's generator advances as the eager step's would).
The first replay warms the buffer-form step up on a side stream, on a
clone of the state with throwaway draws, so the kernels build and every
cached constant is on the card before the capture; then it captures once,
keyed by the ``VOConfig``, the outputs kept, the pair's shape and its
dtype. The graph's memory pool goes with the object.

Launch counts: the kernel wrappers count in Python, so a replay counts
nothing itself. Each counter's increase during the capture is the graph's
launches per replay (``per_replay``); the warm-up's and the capture's own
increases are taken out, and every replay adds ``per_replay``, so the
counters read as they do eagerly. ``count_nodes`` reads a replay's node
count from a throwaway capture of the same step (a graph that keeps its
node list is not kept: destroying one while another stream captures
invalidates that capture).

Spans (``utils/profiling``): ``graph.capture`` (the warm-up and capture,
whose host seconds are ``capture_s``), ``graph.replay`` and, inside it,
``graph.launch`` with a CUDA event pair around the replay (its device ms).

There is no fallback: a failed capture or replay raises, and so does a
replay with a pair of another shape or dtype than the captured one.

S sequences (``parallel/sequences.py``): ``batch=S`` with the step vmapped
over a leading sequence axis (``torch.func.vmap``). The pair is then
(S, H, W), the draws (S, num_hypotheses, 6), every state and output leaf
S-leading, and the capture is keyed by S with the pair's shape. The
buffer form's copies stay outside the vmap: they copy whole (S, ...)
tensors. The kernels' batch rules (``ops/library.py``) make each kernel
call of the vmapped step one launch, so a replay counts as many launches
per frame as at S = 1.
"""
from __future__ import annotations

import torch

from . import frontend as frontend_mod
from ..ops import lk_block, lk_cell, lk_v1, lk_v2, patch, pnp, roll
from ..utils import profiling
from ..utils.tree import tree_map

# The wrappers of K1-K8 and of RANSAC-PnP's kernels (three a call), each
# counting its launches in ``.launches``.
KERNELS = (patch.extract_windows_int, patch.extract_patches, lk_cell.level_track_cell,
           lk_v1.level_track_v1, lk_block.level_track_block, lk_v2.level_track_v2,
           lk_block.level_track_block_split, roll.roll, pnp.ransac_pnp)


def _counts() -> list[int]:
    return [fn.launches for fn in KERNELS]


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a graph captured with ``keep_graph=True``
    (``cuGraphGetNodes``)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t))
    cu.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


class StepGraph:
    """One frontend's step (``step_fn`` of ``frontend.make_frontend(cfg,
    ...)`` on ``device``) as a CUDA graph."""

    def __init__(self, step_fn, cfg: frontend_mod.VOConfig, device, batch: int | None = None,
                 overlays: bool = False):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a cuda device, got {self.device}")
        self.cfg = cfg
        self.overlays = overlays
        self._step_fn = step_fn
        self._buffer_step = frontend_mod.make_buffer_step(step_fn, overlays)
        self.state = None
        self.key = None  # (cfg, overlays, pair shape, pair dtype) once captured
        self.per_replay: dict[str, int] = {}  # wrapper name -> launches per replay
        self.capture_s = 0.0  # warm-up and capture, host seconds (the graph.capture span)
        self._graph = None
        # The draws of one replay: (num_hypotheses, 6), S-leading with a batch.
        self.u_shape = ((() if batch is None else (batch,))
                        + (cfg.num_hypotheses, pnp.MIN_SAMPLE))

    def load_state(self, state: dict) -> dict:
        """Copy ``state`` into the state buffers (made on the first call, one
        tensor per leaf); returns them."""
        if self.state is None:
            self.state = tree_map(torch.clone, state)
        else:
            frontend_mod.write_back(self.state, state)
        return self.state

    def _pair_key(self, img_l, img_r):
        img_l, img_r = torch.as_tensor(img_l), torch.as_tensor(img_r)
        if img_l.shape != img_r.shape or img_l.dtype != img_r.dtype:
            raise ValueError(f"the pair differs: {img_l.dtype} {tuple(img_l.shape)} against "
                             f"{img_r.dtype} {tuple(img_r.shape)}")
        return (self.cfg, self.overlays, tuple(img_l.shape), img_l.dtype), img_l, img_r

    def _capture(self, key, img_l, img_r) -> None:
        if self.state is None:
            raise RuntimeError("load a state (load_state) before the first replay")
        with profiling.measure("graph.capture") as took:
            self._warm_and_capture(key, img_l, img_r)
        self.capture_s = took.seconds

    def _warm_and_capture(self, key, img_l, img_r) -> None:
        dev = self.device
        self.img_l = torch.empty(img_l.shape, dtype=img_l.dtype, device=dev).copy_(img_l)
        self.img_r = torch.empty(img_r.shape, dtype=img_r.dtype, device=dev).copy_(img_r)
        self.u = torch.zeros(self.u_shape, device=dev)
        before = _counts()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # Throwaway draws from a generator of its own: the caller's
                # does not move, and the clone keeps the live state as it is.
                u = torch.rand(self.u.shape, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev)
                scratch = tree_map(torch.clone, self.state)
                new_state, metrics = self._step_fn(scratch, self.img_l, self.img_r, u)
                self.out = {k: torch.empty_like(v) for k, v in
                            frontend_mod.frame_outputs(new_state, metrics,
                                                       self.overlays).items()}
                self._buffer_step(scratch, self.img_l, self.img_r, u, self.out)
                del scratch, new_state, metrics
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = _counts()
            graph = torch.cuda.CUDAGraph()
            # On the side stream of this device: ``torch.cuda.graph``'s
            # default capture stream is made once per process, on whichever
            # device was current then.
            with torch.cuda.graph(graph, stream=side):
                self._buffer_step(self.state, self.img_l, self.img_r, self.u, self.out)
            per_replay = {fn.__name__: c - w for fn, c, w in zip(KERNELS, _counts(), warm)
                          if c != w}
        finally:
            for fn, n in zip(KERNELS, before):
                fn.launches = n
        self.per_replay = per_replay
        self._graph, self.key = graph, key

    def count_nodes(self) -> int:
        """The nodes of one replay: the captured step captured once more on
        the same buffers into a throwaway graph that keeps its node list
        (``cuGraphGetNodes``), destroyed before this returns. The device
        work of a replay, whatever a profiler records."""
        if self._graph is None:
            raise RuntimeError("nothing captured yet: call replay with a frame first")
        before = _counts()
        try:
            with torch.cuda.device(self.device):
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(graph, stream=side):
                    self._buffer_step(self.state, self.img_l, self.img_r, self.u, self.out)
                return graph_nodes(graph)
        finally:
            for fn, n in zip(KERNELS, before):
                fn.launches = n

    def replay(self, img_l, img_r, u: torch.Tensor) -> dict:
        """One frame: copy the pair (numpy or tensors) and the draws ``u``
        into the static inputs, replay the graph (capturing it on the first
        call), and return the ``out`` buffers (valid until the next
        replay). The capture and the replay run with the graph's device
        current, whichever device the caller's is (a shard of a mesh on
        another card)."""
        key, img_l, img_r = self._pair_key(img_l, img_r)
        if u.shape != self.u_shape or u.dtype != torch.float32:
            raise ValueError(f"u must be float32 {self.u_shape}, got {u.dtype} "
                             f"{tuple(u.shape)}")
        with torch.cuda.device(self.device), profiling.span("graph.replay"):
            if self._graph is None:
                self._capture(key, img_l, img_r)
            elif key != self.key:
                raise ValueError(f"this graph was captured for a {self.key[3]} pair of shape "
                                 f"{self.key[2]}, got {key[3]} {key[2]}")
            else:
                self.img_l.copy_(img_l)
                self.img_r.copy_(img_r)
            self.u.copy_(u)
            return self.launch()

    def launch(self) -> dict:
        """Replay the captured graph on the inputs it holds (``replay``
        copies a frame in first); returns the ``out`` buffers."""
        if self._graph is None:
            raise RuntimeError("nothing captured yet: call replay with a frame first")
        with torch.cuda.device(self.device), profiling.span("graph.launch", timed=True):
            self._graph.replay()
        for fn in KERNELS:
            fn.launches += self.per_replay.get(fn.__name__, 0)
        return self.out
