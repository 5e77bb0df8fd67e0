"""Probe: RANSAC-PnP's three kernels (``csrc/pnp.cu``) timed on the card
against the plain version, at the cells' shapes.

Shapes (``SHAPES``): LK (N = 1024 points, 256 hypotheses, ``T_init``, the
0.5 px gate, 6 polish steps) at S = 1 and at S = 11 under
``torch.func.vmap`` (the offline batch), ORB (N = 2048, ORB's weights, the
2 px gate) at S = 1. For each shape:

* ``kernels_graph_ms``: the kernels' call (``pnp.ransac_pnp``) captured 30
  times in one CUDA graph and replayed, device ms per call;
* ``stage_us``: each kernel's mean device time, from the profiler's
  records of 5 replays of that graph;
* ``plain_nodes`` and ``plain_graph_ms``: the plain version
  (``pnp.ransac_pnp_reference``; vmapped at S = 11, the route the step took
  before the kernels) captured in a CUDA graph: its nodes per call
  (``cuGraphGetNodes``) and device ms per call; ``kernel_nodes`` the same
  count for the kernels' call.

Prints one JSON line with the card's name and power limit. Without a GPU it
raises.

    python -m stereo_visual_odometry_tpu_torch.probes.pnp_timing
"""
from __future__ import annotations

import json
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

from ..models.step_graph import graph_nodes
from ..ops import pnp, se3
from ..ops.camera import Pinhole
from .timing import graph_ms

CAM = (718.856, 718.856, 607.19, 185.22)  # fx, fy, cx, cy: KITTI 00's focal length
# name -> (S, N, H, T_init given, ORB's weights and gate)
SHAPES = {"lk_s1": (1, 1024, 256, True, False), "lk_s11": (11, 1024, 256, True, False),
          "orb_s1": (1, 2048, 256, True, True)}
ARGS = ("pts", "px", "valid", "u", "T_init", "weights")


def problem(S: int, n: int, H: int, seed: int = 0, n_valid: int | None = None,
            dup: bool = False, device="cuda") -> dict:
    """S PnP problems of n points, stacked S-leading on ``device``: points
    5-40 m ahead, a motion of ~0.3 m / 0.02 rad (``T_gt``), pixels with 0.05
    px of noise (far inside LK's 0.5 px gate) and 20% outliers 5-50 px off
    (far outside ORB's 2 px), 10% invalid, ``T_init`` near the motion, ORB's
    weights (1.2^-2l at octave l in 0-7), (H, 6) draws ``u``. ``n_valid``
    keeps that many valid points; ``dup`` makes each hypothesis's six draws
    equal (every sample a repeat)."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAM
    rows = []
    for _ in range(S):
        pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                        rng.uniform(5, 40, n)], -1)
        xi = rng.normal(size=6) * [0.1, 0.1, 0.3, 0.02, 0.02, 0.02]
        T = se3.se3_exp(torch.tensor(xi)).numpy()
        pc = pts @ T[:3, :3].T + T[:3, 3]
        px = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
        px += rng.normal(0, 0.05, px.shape)
        out = rng.random(n) < 0.2
        px[out] += rng.uniform(5, 50, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
        valid = rng.random(n) > 0.1
        if n_valid is not None:
            valid[:] = False
            valid[rng.choice(n, n_valid, replace=False)] = True
        u = rng.random((H, 6))
        if dup:
            u[:] = u[:, :1]
        dxi = rng.normal(size=6) * [0.02, 0.02, 0.05, 0.003, 0.003, 0.003]
        T_init = se3.se3_exp(torch.tensor(dxi)).numpy() @ T
        weights = 1.2 ** (-2.0 * rng.integers(0, 8, n))
        rows.append(dict(pts=pts, px=px, valid=valid, u=u, T_init=T_init, weights=weights,
                         T_gt=T))
    return {k: torch.from_numpy(np.stack([r[k] for r in rows])).to(
        torch.bool if k == "valid" else torch.float32).to(device) for k in rows[0]}


def camera(device="cuda") -> Pinhole:
    return Pinhole.create(*CAM, device=device)


def call(cam: Pinhole, H: int, init: bool, orb: bool, plain: bool = False,
         refine_iters: int = 6):
    """``ransac_pnp`` (or, with ``plain``, its plain version) on one
    sequence's (pts, px, valid, u, T_init, weights)."""
    gate = 2.0 if orb else 0.5

    def fn(p, q, v, u, ti, w):
        ti, w = ti if init else None, w if orb else None
        if plain:
            out = pnp.ransac_pnp_reference(cam, p, q, v, u, gate, refine_iters, ti, w)
        else:
            out = pnp.ransac_pnp(cam, p, q, v, num_hypotheses=H, inlier_px=gate,
                                 refine_iters=refine_iters, T_init=ti, weights=w, u=u)
        return tuple(out[k] for k in pnp.OUTPUTS)
    return fn


def _nodes(fn) -> int:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    return graph_nodes(graph)


def _stage_us(fn, calls: int = 30, replays: int = 5) -> dict:
    """Mean device us of each kernel of ``fn`` over ``replays`` replays of a
    graph of ``calls`` calls, by kernel name."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    took = defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("hypotheses", "score", "polish") if f"pnp_{k}" in e.name),
                        e.name)
            took[name].append(e.time_range.end - e.time_range.start)
    return {k: round(float(np.mean(v)), 3) for k, v in took.items()}


def measure(name: str) -> dict:
    S, n, H, init, orb = SHAPES[name]
    x = problem(S, n, H, seed=1)
    cam = camera()
    args = [x[k] if S > 1 else x[k][0] for k in ARGS]
    kernels, plain = (call(cam, H, init, orb, plain=p) for p in (False, True))
    if S > 1:
        kernels, plain = torch.func.vmap(kernels), torch.func.vmap(plain)
    run = lambda fn: (lambda: fn(*args))
    got, want = run(kernels)(), run(plain)()
    return {"S": S, "N": n, "H": H,
            "kernels_graph_ms": round(graph_ms(run(kernels), calls=30), 5),
            "stage_us": _stage_us(run(kernels)),
            "kernel_nodes": _nodes(run(kernels)),
            "plain_graph_ms": round(graph_ms(run(plain), calls=2, replays=5), 4),
            "plain_nodes": _nodes(run(plain)),
            "max_T_diff": float((got[0] - want[0]).abs().max()),
            "inliers_equal": bool(torch.equal(got[1], want[1]))}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("pnp_timing needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"device": smi.strip().splitlines()[0] if smi else
                      torch.cuda.get_device_name(0),
                      **{name: measure(name) for name in SHAPES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
