"""Probe: the LK level kernels K3 (``lk_kernel='cell'``), K4 (``'v1'``), K5
(``lk_block``, K3's function, a warp per point) and K6 (``lk_v2``, K4's
function, a warp per point) timed on the card, with their iteration
statistics.

At two operating points, ``smoke`` (a smooth texture moved by (2.3, -1.4)
px on LK level 0 padded to (408, 1408), 1024 points, guesses within 1.5 px,
a quarter of them inactive) and ``probe``
(``probes.lk_block``'s: smoothed noise moved by (3, 2) px, zero guesses,
every point tracked), both at win 21, 30 iterations, eps 0.01, radius 6,
it times per kernel:

* ``kernel_graph_ms``: the kernel alone, the bare C entry with preallocated
  outputs, in a CUDA graph of 30 calls; ``template_graph_ms`` and
  ``one_iter_graph_ms`` the same with ``iters`` = 0 (the template phase)
  and 1;
* ``graph_ms`` and ``ms``: the wrapper call in a CUDA graph of 30 calls
  (every node it launches) and back to back (CUDA events, 200 calls);
* ``host_us``: the wrapper's host time per call (no sync);
* the iterations and reloads per tracked point (mean, p99, max), from the
  kernel's statistics (the bare C entry's);
* for a kernel that stages a region (one with the finished contract, 19 C
  arguments: K3-K6 on this tree) also ``staged_share``: the share of
  reloads that fall inside the region of the next image the kernel stages,
  by margin, from the plain versions' reloads.

K6's wrapper takes no mask (the JAX signature has none), so its wrapper
times track every point; its kernel alone and its statistics take the
operating point's mask through the bare C entry, which has K4's contract,
so that they count K4's work.

A third point, ``bench``, is the slice itself: every level call that
``System.run_chunked`` makes with ``lk_kernel='cell'`` (``'v1'``) on the
first 8 frames of the bench sequence (``bench_sequence``), recorded as it runs
(K5 and K6, on no ``System`` path, are timed on K3's and K4's calls, with
their masks: the same functions); for each, the kernel alone in a CUDA
graph (mean and largest over the calls),
the iterations per tracked point over all the calls, the staged share
over all their reloads and the reloads off the region per point (and those
of each call's most iterating point).

    python3 stereo_visual_odometry_tpu_torch/probes/lk_timing.py
    python3 stereo_visual_odometry_tpu_torch/probes/lk_timing.py --root DIR

``--root`` times the package of another checkout (an unpacked commit, for an
A/B on one machine in one run, in turns) through the calls the wrappers,
``probes/timing.py``, ``probes/lk_block.make_inputs`` and
``probes/patch_timing.host_us`` have had since they were written. The bare C
entry is called with that checkout's contract, told by its argument count:
18 (the float32 mask, the raw delta and gate, the statistics always
written: older K3-K6) or 19 (the bool mask, the search radius, the
finished flow and ok, the statistics only when asked). Prints one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

WIN, ITERS, EPS, RADIUS, PAD, N = 21, 30, 0.01, 6, 12, 1024
LEVEL0 = (408, 1408)          # LK level 0 at 384x1280, padded
SHIFT = (2.3, -1.4)           # the smoke pair's motion, (x, y) px
GRAPH_CALLS, B2B_CALLS = 30, 200
MARGINS = (0, 2, 4, 7, 10, 14)  # staged-region margins whose share is reported
ENTRIES = {"cell": "svo_lk_level_cell", "v1": "svo_lk_level_v1",
           "block": "svo_lk_level_block", "v2": "svo_lk_level_v2"}
BENCH_CALLS = {"cell": "cell", "v1": "v1", "block": "cell", "v2": "v1"}  # whose calls
# The bench sequence (the JAX bench's, bench.py:31-49): 376x1241 frames,
# edge-padded to 384x1280; the bench point takes its first BENCH_FRAMES.
H_RAW, W_RAW, H, W = 376, 1241, 384, 1280
FX, BASELINE, BENCH_FRAMES = 718.856, 0.537, 8


def textured_pair(hp, wp, shift_xy, seed, periods=(6.0, 40.0), mean=128.0):
    """A smooth random texture (40 sinusoids, periods in ``periods`` px, about
    ``mean``) and the same texture moved by ``shift_xy`` px: an exact
    subpixel shift."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = 40
    lo, hi = periods
    period = lo + (hi - lo) * torch.rand(k, generator=g, device="cuda")
    theta = 2 * torch.pi * torch.rand(k, generator=g, device="cuda")
    phase = 2 * torch.pi * torch.rand(k, generator=g, device="cuda")
    amp = 10.0 + 20.0 * torch.rand(k, generator=g, device="cuda")
    wx, wy = 2 * torch.pi * torch.cos(theta) / period, 2 * torch.pi * torch.sin(theta) / period
    y = torch.arange(hp, device="cuda", dtype=torch.float64)[:, None, None]
    x = torch.arange(wp, device="cuda", dtype=torch.float64)[None, :, None]

    def img(dx, dy):
        arg = (wx.double() * (x - dx) + wy.double() * (y - dy) + phase.double())
        return (mean + (amp.double() * torch.sin(arg)).sum(-1) / 4).float().contiguous()

    return img(0.0, 0.0), img(*shift_xy)


def lk_level_inputs(hp, wp, seed, n=N, pad=PAD):
    """Points inside a padded level, guesses within 1.5 px, ~25% inactive."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    span = torch.tensor([wp - 2 * pad - 1.0, hp - 2 * pad - 1.0], device="cuda")
    pts = torch.rand((n, 2), generator=g, device="cuda") * span
    guess = (torch.rand((n, 2), generator=g, device="cuda") - 0.5) * 3.0
    active = torch.rand(n, generator=g, device="cuda") > 0.25
    return pts.contiguous(), guess.contiguous(), active


def bench_sequence(n_frames):
    """The first ``n_frames`` stereo pairs of the bench sequence (numpy,
    edge-padded), their true poses and the camera. The frames do not depend
    on ``n_frames``."""
    import numpy as np
    from stereo_visual_odometry_tpu_torch.utils import synthetic
    from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig
    seq = synthetic.render_sequence(n_frames=n_frames, h=H_RAW, w=W_RAW, fx=FX,
                                    baseline=BASELINE, n_points=9000, speed=1.1, seed=3)
    pad = lambda a: np.pad(a, ((0, 0), (0, H - H_RAW), (0, W - W_RAW)), mode="edge")
    cam = CameraConfig(fx=FX, fy=FX, cx=W_RAW / 2, cy=H_RAW / 2, baseline=BASELINE)
    return pad(seq["images_l"]), pad(seq["images_r"]), seq["poses_gt"], cam


def bench_level_calls(name, frames, cam) -> list:
    """Every level call of K3 (``name='cell'``) or K4 (``'v1'``) that
    ``System.run_chunked`` makes on ``frames`` on cuda, eagerly, as (args, kw):
    ``ops/lk.py`` is handed a stand-in module that records each call and
    passes it on."""
    import types
    from stereo_visual_odometry_tpu_torch.models import system
    from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
    from stereo_visual_odometry_tpu_torch.ops import lk, lk_cell, lk_v1
    from stereo_visual_odometry_tpu_torch.utils.config import RunConfig
    module, fn = (("lk_cell", lk_cell.level_track_cell) if name == "cell"
                  else ("lk_v1", lk_v1.level_track_v1))
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    saved = getattr(lk, module)
    setattr(lk, module, types.SimpleNamespace(**{fn.__name__: record}))
    try:
        vo = VOConfig(lk_kernel=name, height=H, width=W, max_features=1024)
        # Eager (graph=False): a graph's replays make no Python calls to record.
        system.System(RunConfig(camera=cam, vo=vo), device="cuda", graph=False).run_chunked(
            frames, chunk=len(frames))
    finally:
        setattr(lk, module, saved)
    return calls


def operating_points(make_probe_inputs) -> dict:
    """name -> (prev, next, pts, guess, active or None) on cuda."""
    prev, nxt = textured_pair(*LEVEL0, SHIFT, seed=200)
    pts, guess, active = lk_level_inputs(*LEVEL0, seed=300)
    probe = make_probe_inputs("cuda")
    return {"smoke": (prev, nxt, pts, guess, active),
            "probe": (probe["prev"], probe["next"], probe["pts"], probe["guess"], None)}


def bare_entry(native, stream, name, args, kw, iters=None, stats=False):
    """The C entry of K3-K6 on preallocated outputs, as a no-argument call
    that raises on a launch error and returns the buffers it writes (the
    per-point iterations and reloads last, with ``stats``): ``args`` (prev,
    next, pts, guess) and ``kw`` as K4's wrapper takes them, ``iters`` in
    place of ``kw``'s if given. The raw stream is read at each call (in a
    capture, the capturing stream)."""
    prev, nxt, pts, guess = (t.contiguous() for t in args)
    active = kw.get("active")
    iters = kw["iters"] if iters is None else iters
    eps2, min_eig = kw["eps"] * kw["eps"], kw.get("min_eig", 1e-4)
    fn = native.entry(name)
    n, (hp, wp), index = len(pts), prev.shape, prev.get_device()
    flow = torch.empty((n, 2), dtype=torch.float32, device="cuda")
    head = (prev.data_ptr(), nxt.data_ptr(), hp, wp, pts.data_ptr(), guess.data_ptr())
    if len(fn.argtypes) == 19:
        ok = torch.empty(n, dtype=torch.bool, device="cuda")
        act = None if active is None else active.contiguous()
        counts = torch.empty((n, 2), dtype=torch.int32, device="cuda") if stats else None
        held = (prev, nxt, pts, guess, act, flow, ok) + ((counts,) if stats else ())
        args = head + (None if act is None else act.data_ptr(), n, kw["win"], iters, eps2,
                       min_eig, kw["pad"], float(kw["search_radius"]), flow.data_ptr(),
                       ok.data_ptr(), counts.data_ptr() if stats else None, index)
    else:
        ok = torch.empty(n, dtype=torch.float32, device="cuda")
        counts = torch.empty((n, 2), dtype=torch.int32, device="cuda")
        act = torch.ones(n, device="cuda") if active is None else active.float()
        held = (prev, nxt, pts, guess, act, flow, ok, counts)
        args = head + (act.data_ptr(), n, kw["win"], iters, eps2, min_eig, kw["pad"],
                       flow.data_ptr(), ok.data_ptr(), counts.data_ptr(), index)

    def call():
        if fn(*args, stream(index)) != 0:
            raise RuntimeError(f"{name} launch failed")
        return held  # the buffers the pointers name stay alive with the call

    return call


def distribution(x: torch.Tensor) -> dict:
    x = x.float()
    return {"mean": float(x.mean()), "p99": float(torch.quantile(x, 0.99)),
            "max": float(x.max())}


def shares(share, calls, plain) -> dict:
    """The staged share by margin over the reloads of the level ``calls``
    ((args, kw) each), from ``plain``'s record of them."""
    inside, total = dict.fromkeys(MARGINS, 0.0), 0
    for args, kw in calls:
        st = {}
        plain(*args, stats=st, **kw)
        total += len(st["corners"])
        for m in MARGINS:
            inside[m] += len(st["corners"]) * share(args[2], args[3], st, *args[0].shape,
                                                    win=kw["win"], pad=kw["pad"], margin=m)
    return {m: v / max(total, 1) for m, v in inside.items()}


def off_region(staged, calls, plain) -> dict:
    """Reloads off the staged region (the shipped margin) per tracked point
    over the level ``calls``, by ``plain``'s record: their distribution over
    points, and per call those of the point that iterates most (the chain
    that sets a call's time), averaged over the calls."""
    per_point, slowest = [], []
    for args, kw in calls:
        st = {}
        plain(*args, stats=st, **kw)
        inside = staged(args[2], args[3], st, *args[0].shape, win=kw["win"], pad=kw["pad"])
        off = torch.bincount(st["points"][~inside], minlength=len(args[2]))
        tracked = kw.get("active")
        per_point.append(off if tracked is None else off[tracked])
        slowest.append(float(off[torch.argmax(st["iters"])]))
    return {"per_point": distribution(torch.cat(per_point)),
            "slowest_point": sum(slowest) / max(len(slowest), 1)}


def counts(native, stream, name, args, kw) -> torch.Tensor:
    """Each point's (iterations, reloads) of one bare C entry call."""
    out = bare_entry(native, stream, name, args, kw, stats=True)()[-1]
    torch.cuda.synchronize()
    return out


def measure(ops: dict, timing, host_us, stream, bench=None) -> dict:
    """Everything in the module note, per operating point and kernel, for
    the modules in ``ops`` (``lk_cell``, ``lk_v1``, ``lk_block``, ``lk_v2``,
    ``native``, and ``make_inputs`` of ``probes/lk_block``). ``bench``: the
    bench frames and camera (``bench_sequence``'s) for the bench point,
    which is skipped without them."""
    native = ops["native"]
    fns = {"cell": ops["lk_cell"].level_track_cell, "v1": ops["lk_v1"].level_track_v1,
           "block": ops["lk_block"].level_track_block, "v2": ops["lk_v2"].level_track_v2}
    # K6's plain version takes no mask; with one, its function is K4's.
    plain = {"cell": ops["lk_cell"].level_track_cell_reference,
             "v1": ops["lk_v1"].level_track_v1_reference,
             "block": ops["lk_block"].level_track_block_reference,
             "v2": ops["lk_v1"].level_track_v1_reference}
    share = getattr(ops["lk_v1"], "staged_share", None)
    stages = {name: share is not None and len(native.entry(entry).argtypes) == 19
              for name, entry in ENTRIES.items()}
    out = {}
    for point, inputs in operating_points(ops["make_inputs"]).items():
        prev, nxt, pts, guess, active = inputs
        kw = dict(win=WIN, iters=ITERS, eps=EPS, search_radius=RADIUS, pad=PAD)
        if active is not None:
            kw["active"] = active
        tracked = torch.ones(len(pts), dtype=torch.bool, device="cuda") if active is None \
            else active
        for name, fn in fns.items():
            wkw = {k: v for k, v in kw.items() if k != "active"} if name == "v2" else kw
            wrapper = lambda fn=fn, wkw=wkw: fn(prev, nxt, pts, guess, **wkw)
            entry = lambda iters, name=name: timing.graph_ms(
                bare_entry(native, stream, ENTRIES[name], inputs[:4], kw, iters),
                calls=GRAPH_CALLS)
            st = counts(native, stream, ENTRIES[name], inputs[:4], kw)
            res = {"kernel_graph_ms": entry(None),
                   "template_graph_ms": entry(0),
                   "one_iter_graph_ms": entry(1),
                   "graph_ms": timing.graph_ms(wrapper, calls=GRAPH_CALLS),
                   "ms": timing.events_ms(wrapper, iters=B2B_CALLS),
                   "host_us": host_us(wrapper),
                   "iters": distribution(st[:, 0][tracked]),
                   "reloads": distribution(st[:, 1][tracked])}
            if stages[name]:
                res["staged_share"] = shares(share, [(inputs[:4], kw)], plain[name])
            out.setdefault(point, {})[name] = res
    recorded = {}
    for name in fns if bench is not None else ():
        source = BENCH_CALLS[name]
        if source not in recorded:
            recorded[source] = bench_level_calls(source, *bench)
        calls = recorded[source]
        ms = [timing.graph_ms(bare_entry(native, stream, ENTRIES[name], args, kw),
                              calls=GRAPH_CALLS) for args, kw in calls]
        its = []
        for args, kw in calls:
            it = counts(native, stream, ENTRIES[name], args, kw)[:, 0]
            its.append(it if kw.get("active") is None else it[kw["active"]])
        res = {"calls": len(calls), "recorded_on": source,
               "kernel_graph_ms": sum(ms) / len(ms),
               "kernel_graph_ms_max": max(ms), "iters": distribution(torch.cat(its))}
        if stages[name]:
            res["staged_share"] = shares(share, calls, plain[name])
            if hasattr(ops["lk_v1"], "staged"):
                res["off_region"] = off_region(ops["lk_v1"].staged, calls, plain[name])
        out.setdefault("bench", {})[name] = res
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose stereo_visual_odometry_tpu_torch to time "
                         "(default: this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe times the kernels on an NVIDIA GPU")
    sys.path[0] = str(Path(args.root).resolve())  # not this file's directory
    from stereo_visual_odometry_tpu_torch.ops import lk_block as lk_block_op
    from stereo_visual_odometry_tpu_torch.ops import lk_cell, lk_v1, lk_v2, native, patch
    from stereo_visual_odometry_tpu_torch.probes import lk_block, patch_timing, timing
    try:
        from stereo_visual_odometry_tpu_torch.ops.cuda_stream import current_stream
    except ImportError:  # a checkout from before the shared module
        current_stream = patch.current_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    ops = {"lk_cell": lk_cell, "lk_v1": lk_v1, "lk_block": lk_block_op, "lk_v2": lk_v2,
           "native": native, "make_inputs": lk_block.make_inputs}
    il, ir, _, cam = bench_sequence(BENCH_FRAMES)
    res = {"root": args.root, "card": smi,
           **measure(ops, timing, patch_timing.host_us, current_stream,
                     bench=(list(zip(il, ir)), cam))}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
