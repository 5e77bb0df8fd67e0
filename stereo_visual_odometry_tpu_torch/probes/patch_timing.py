"""Probe: the patch kernels K1 and K2, with K7 beside them, timed on the card
against the PyTorch call that computes the same function.

Each kernel and its library call (``F.grid_sample`` nearest for K1,
bilinear with border padding for K2, ``torch.roll`` for K7) is timed back to
back with CUDA events (the larger of host and device time per call) and
inside a CUDA graph of 30 calls (the device time alone), in the order
kernel, library, library, kernel, keeping each one's faster run; and each
wrapper's host time per call (``time.perf_counter`` over many calls, no
sync). The shapes are the main paths': K1 S = 24, N = 1024 on LK level 0
padded, (408, 1408); K2 P = 39, N = 445 on ORB level 0, (384, 1280); K7
(128, 256), axis 0, amount 9 (the roll probe's largest block), and in a
graph also K7 on one row of 256, the least a K7 node takes
(``k7.one_row_graph_ms``), timed in turns with the (128, 256) call.

    python3 stereo_visual_odometry_tpu_torch/probes/patch_timing.py
    python3 stereo_visual_odometry_tpu_torch/probes/patch_timing.py --root DIR

``--root`` times the package of another checkout (an unpacked commit, for
an A/B on one machine in one run) through the calls that K1's, K2's and
K7's wrappers and ``probes/timing.py`` have had since they were written:
``extract_windows_int(img, corners, S)``, ``extract_patches(img, xy, P)``,
``roll(x, amt, axis)``, ``events_ms`` and ``graph_ms``. Prints one JSON
object; on a tree with the lean launch path (``native.entry``) also K1's
and K7's host split (``host_split``, ``k7_host_split``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

K1_SHAPE, K1_N = (408, 1408, 24), 1024
K2_SHAPE, K2_N, K2_P = (384, 1280), 445, 39
K7_SHAPE, K7_AMOUNT = (128, 256), 9
GRAPH_CALLS, B2B_CALLS, HOST_CALLS, HOST_REPEATS = 30, 200, 1000, 5


def k1_inputs(hp, wp, S, seed, n=K1_N):
    """A random (hp, wp) image and n corners for (Sh, Sw) = S (or (S, S)):
    uniform over the pre-clipped range, with its extremes and a few corners
    outside it (the kernel clamps them)."""
    sh, sw = (S, S) if isinstance(S, int) else S
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((hp, wp), generator=g, device="cuda") * 255
    rows = torch.randint(0, hp - sh + 1, (n,), generator=g, device="cuda")
    cols = torch.randint(0, wp - sw + 1, (n,), generator=g, device="cuda")
    corners = torch.stack([rows, cols], -1).to(torch.int32)
    edge = torch.tensor([[0, 0], [hp - sh, wp - sw], [-3, wp + 5], [hp + 2, -1],
                         [0, wp - sw], [hp - sh, 0]], dtype=torch.int32, device="cuda")
    corners[:6] = edge[:n]
    return img.contiguous(), corners.contiguous()


def k2_inputs(h, w, n, seed, outside=0.0):
    """A random level image and n centres where ORB puts them (inside the
    EDGE = 19 border), plus the image corners; ``outside`` > 0 moves every
    other centre up to that many px outside the image, on all four sides."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((h, w), generator=g, device="cuda") * 255
    lo = torch.tensor([19.0, 19.0], device="cuda")
    span = torch.tensor([w - 39.0, h - 39.0], device="cuda")
    xy = lo + torch.rand((n, 2), generator=g, device="cuda") * span
    if outside:
        far = torch.tensor([w - 1.0, h - 1.0], device="cuda")
        d = torch.rand((n, 2), generator=g, device="cuda") * outside
        side = torch.arange(n, device="cuda") % 4
        xy[side == 1] = -d[side == 1]          # above and left of the image
        xy[side == 3] = far + d[side == 3]     # below and right
        xy[1::8, 1] = 0.5 * far[1]             # left only
        xy[5::8, 0] = 0.5 * far[0]             # above only
        xy[3::8, 0] = 0.5 * far[0]             # below only
        xy[7::8, 1] = 0.5 * far[1]             # right only
    xy[:4] = torch.tensor([[0.0, 0.0], [w - 1.0, h - 1.0], [w - 1.0, 0.0],
                           [0.0, h - 1.0]], device="cuda")[:n]
    return img, xy


def k1_library(img, corners, S):
    """``F.grid_sample`` (nearest) reading the same windows, at the clamped
    corners, and the corners it reads."""
    hp, wp = img.shape
    c = corners.long().clamp(min=0)
    c = torch.stack([c[:, 0].clamp(max=hp - S), c[:, 1].clamp(max=wp - S)], -1)
    off = torch.arange(S, device="cuda", dtype=torch.float32)
    gx = (c[:, 1, None, None] + off[None, None, :]).expand(-1, S, S) * (2.0 / (wp - 1)) - 1
    gy = (c[:, 0, None, None] + off[None, :, None]).expand(-1, S, S) * (2.0 / (hp - 1)) - 1
    grid = torch.stack([gx, gy], -1).reshape(1, -1, S, 2)
    call = lambda: F.grid_sample(img[None, None], grid, mode="nearest", align_corners=True)
    return call, c


def k2_library(img, xy, P):
    """``F.grid_sample`` (bilinear, border) on the unpadded level image at the
    patch's pixel positions (the padded corner shifted by -pad): the same
    work as K2, with per-tap fractions."""
    h, w = img.shape
    r = (P - 1) / 2.0
    off = torch.arange(P, device="cuda", dtype=torch.float32)
    gx = ((xy[:, 0] - r)[:, None, None] + off[None, None, :]).expand(-1, P, P)
    gy = ((xy[:, 1] - r)[:, None, None] + off[None, :, None]).expand(-1, P, P)
    grid = torch.stack([gx * (2.0 / (w - 1)) - 1, gy * (2.0 / (h - 1)) - 1],
                       -1).reshape(1, -1, P, 2)
    return lambda: F.grid_sample(img[None, None], grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)


def host_us(fn, calls=HOST_CALLS, repeats=HOST_REPEATS, warmup=20) -> float:
    """Host time per call (us): ``time.perf_counter`` over ``calls`` calls
    with no sync in between (each through one Python call), the least of
    ``repeats`` runs (the host's cores are shared, so its clock is noisy)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / calls


def _pair(timing, kernel, library):
    """(kernel ms, library ms) back to back and in a graph, each the faster of
    two runs in the order kernel, library, library, kernel."""
    out = {}
    for key, timer in (("ms", lambda f: timing.events_ms(f, iters=B2B_CALLS)),
                       ("graph_ms", lambda f: timing.graph_ms(f, calls=GRAPH_CALLS))):
        runs = [timer(f) for f in (kernel, library, library, kernel)]
        out[key], out["library_" + key] = min(runs[0], runs[3]), min(runs[1], runs[2])
    return out


def measure(patch, roll, timing) -> dict:
    """Times K1, K2 and K7 of the given modules (see the module note)."""
    hp, wp, S = K1_SHAPE
    img, corners = k1_inputs(hp, wp, S, seed=S)
    lib1, _ = k1_library(img, corners, S)
    k1 = lambda: patch.extract_windows_int(img, corners, S)
    res = {"k1": {"shape": [hp, wp, S], "n": K1_N, **_pair(timing, k1, lib1),
                  "library_max_diff": float((lib1().reshape(-1, S, S) - k1()).abs().max()),
                  "host_us": host_us(k1)}}

    (h, w), P = K2_SHAPE, K2_P
    img2, xy = k2_inputs(h, w, K2_N, seed=7)
    lib2 = k2_library(img2, xy, P)
    k2 = lambda: patch.extract_patches(img2, xy, P)
    res["k2"] = {"shape": [h, w, P], "n": K2_N, **_pair(timing, k2, lib2),
                 "library_max_diff": float((lib2().reshape(-1, P, P) - k2()).abs().max()),
                 "host_us": host_us(k2)}

    x = torch.rand(K7_SHAPE, device="cuda")
    a = torch.tensor([[K7_AMOUNT]], dtype=torch.int32, device="cuda")
    k7 = lambda: roll.roll(x, a, 0)
    lib7 = lambda: torch.roll(x, -K7_AMOUNT, 0)
    res["k7"] = {"shape": list(K7_SHAPE), "amount": K7_AMOUNT, **_pair(timing, k7, lib7),
                 "library_max_diff": float((lib7() - k7()).abs().max()),
                 "host_us": host_us(k7)}
    row = x[:1].clone()
    one_row = lambda: roll.roll(row, a, 0)
    runs = [timing.graph_ms(f, calls=GRAPH_CALLS) for f in (one_row, k7, k7, one_row)]
    res["k7"]["one_row_graph_ms"] = min(runs[0], runs[3])
    res["k7"]["graph_ms_beside_one_row"] = min(runs[1], runs[2])
    torch.cuda.synchronize()
    return res


def host_split(patch, native, current_stream) -> dict:
    """K1's wrapper on the host, piece by piece (us per call, each through
    one Python call): the pieces of the lean launch path beside the ones
    they replace (``torch.empty`` with a device, the ``torch.cuda.Stream``
    getter, ``native.lib`` and its lock), the C entry through ctypes with
    no points (it returns before the launch) and with K1_N points (the
    launch), and the whole wrapper with no points (the checks and the empty
    output; it returns before the C entry) and with K1_N points.
    ``current_stream`` is the raw-stream getter of the checkout timed."""
    hp, wp, S = K1_SHAPE
    img, corners = k1_inputs(hp, wp, S, seed=S)
    dev, index, name = img.device, img.get_device(), "svo_extract_windows_int"
    fn, out = native.entry(name), patch.extract_windows_int(img, corners, S)
    none = corners[:0]
    stream = current_stream(index)
    c_entry = lambda n: fn(img.data_ptr(), hp, wp, corners.data_ptr(), n, S, S,
                           out.data_ptr(), index, stream)
    pieces = {
        "new_empty": lambda: img.new_empty((K1_N, S, S)),
        "torch_empty_device": lambda: torch.empty((K1_N, S, S), dtype=torch.float32,
                                                  device=dev),
        "current_stream": lambda: current_stream(index),
        "current_stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "entry": lambda: native.entry(name),
        "lib_locked": native.lib,
        "c_entry_n0": lambda: c_entry(0),
        "c_entry_launch": lambda: c_entry(K1_N),
        "wrapper_n0": lambda: patch.extract_windows_int(img, none, S),
        "wrapper": lambda: patch.extract_windows_int(img, corners, S),
    }
    return {k: host_us(f) for k, f in pieces.items()}


def k7_host_split(roll, native, current_stream) -> dict:
    """K7's call on the host, piece by piece (us per call, each through one
    Python call, no sync): the wrapper, its C entry through ctypes (the
    launch), ``torch.empty_like`` and ``torch.roll`` from Python, at the
    timed shape."""
    x = torch.rand(K7_SHAPE, device="cuda")
    a = torch.tensor([[K7_AMOUNT]], dtype=torch.int32, device="cuda")
    out, index, fn = torch.empty_like(x), x.get_device(), native.entry("svo_roll")
    stream = current_stream(index)
    pieces = {"wrapper": lambda: roll.roll(x, a, 0),
              "c_entry_launch": lambda: fn(x.data_ptr(), K7_SHAPE[0], K7_SHAPE[1], a.data_ptr(),
                                           0, out.data_ptr(), index, stream),
              "torch_empty_like": lambda: torch.empty_like(x),
              "torch_roll": lambda: torch.roll(x, -K7_AMOUNT, 0)}
    return {k: host_us(f) for k, f in pieces.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose stereo_visual_odometry_tpu_torch to time "
                         "(default: this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe times the kernels on an NVIDIA GPU")
    sys.path[0] = str(Path(args.root).resolve())  # not this file's directory
    from stereo_visual_odometry_tpu_torch.ops import native, patch, roll
    from stereo_visual_odometry_tpu_torch.probes import timing
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    res = {"root": args.root, "card": smi, **measure(patch, roll, timing)}
    if hasattr(native, "entry"):
        try:
            from stereo_visual_odometry_tpu_torch.ops.cuda_stream import current_stream
        except ImportError:  # a checkout from before the shared module
            current_stream = patch.current_stream
        res["k1_host_split_us"] = host_split(patch, native, current_stream)
        res["k7_host_split_us"] = k7_host_split(roll, native, current_stream)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
