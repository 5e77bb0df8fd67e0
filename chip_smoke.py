#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereo_visual_odometry_tpu_torch``)
on one NVIDIA GPU, end to end through its ``System``: LK on each level
tracker and prior of ``VOConfig``, ORB, persistent tracks and the
sliding-window BA backend; then S sequences in one batched step graph
through ``parallel.evaluate`` and the distributed BA on NCCL; then the
command line, checkpoint/resume and the online feed on a KITTI directory;
then a sequence batch split over a ``seq`` mesh of two shards.

    python3 chip_smoke.py    # the twenty-two phases below, on cuda:0 (and cuda:1)

Phases (each prints one line; any failure exits non-zero):
  1. device: needs ``torch.cuda.is_available()`` (no CPU path); prints
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
  2. build the kernels (``csrc/*.cu``, one nvcc per source, all at once)
     and K7's binding (``csrc/roll_binding.cpp``, the host compiler against
     PyTorch's headers), each with its seconds (cold: nothing built yet);
  3. K1 (``csrc/extract_windows.cu``) against its plain PyTorch version at
     the LK path's shapes, ORB's 3x3 subpixel reads, the XLA tracker's
     64x64 / 36x36 windows, and ragged N (0, 1, 7, 1023) at S = 24, (5, 7)
     and (64, 36): max abs error 0;
  4. K2 (``csrc/extract_patches.cu``, on the unpadded image) against its
     plain versions (on the edge-padded image, and with clamped taps) at the
     8 ORB level shapes with the level budgets (P = 39), P = 31, and centres
     up to 2 px outside the image on all four sides with N = 1, 7, 130: max
     abs error 0, and the BRIEF bits of the P = 39 patch sets equal;
  5. K3 and K4 (``csrc/lk_level.cu``: one kernel per level call, the
     wrappers' tail fused in) against their plain versions at the two padded
     LK level shapes, N = 1024, on a textured pair with a known subpixel
     shift, random guesses and a quarter of the points inactive: ok masks
     >= 99% equal, flows within 1e-3 px for >= 98% of the points both keep
     and within eps for all (sums in another order), the mean iterations and
     reloads per tracked point within 0.01; with N = 0 empty outputs and no
     launch counted;
  6. the LK slice: the 49-frame KITTI-shaped synthetic sequence (376x1241
     edge-padded to 384x1280, 1024 features) through
     ``System.run_chunked(chunk=16)``, the step replayed from its CUDA graph
     (``models/step_graph.py``) as in phases 7-9; ATE < 0.05 m, accept >=
     0.95, K1 launched 27 times per tracked frame + once at init (the
     graph's tally: its launches per replay, added at each replay);
  7. the ORB slice: the same frames, ``mode='orb'`` at 2048 features;
     ATE < 0.07 m, accept >= 0.95, and (without a reinit) K1 and K2
     launched 16 times per frame (8 levels x 2 images), 784 in all;
  8. the LK slice on K3 (``lk_kernel='cell'``) and on K4 (``'v1'``), the
     same 49 frames: ATE < 0.05 m, accept >= 0.95, K3 (K4) launched 6 times
     per tracked frame (one per level call), K1 once per frame;
  9. the kernel-free LK branches on the first 16 frames: ``lk_backend=
     'xla'`` (K1 7 per tracked frame: 6 search-window reads + 1 subpixel),
     ``lk_sweep=False`` (45: 4 legs x (5+3+3) dense reads + 1) and
     ``lk_predictive=False`` (61: 4 legs x (9+3+3) + 1); accept >= 0.9 and
     the ATE over frames 1.. < 0.15 m. Without the sweep the first step has
     no prior and is rejected, in the JAX package too, which leaves one
     frame's motion out of the chain; aligning from frame 1 removes that
     offset. The bounds sit above the JAX package's numbers on the same
     generator at half this resolution (``tests/torch_lk_branch_reference.py``);
 10. K5 and K6 (``csrc/lk_block.cu``: one kernel, a warp per point,
     staged regions, the wrappers' tail fused in; K5 with K3's body, K6
     with K4's) against their plain versions (K3's and K4's) on phase 5's
     inputs, K6 with every point tracked (its wrapper takes no mask):
     phase 5's criteria, and the mean iterations and reloads per tracked
     point within 0.01 of the plain version's; the same against the K3 and
     K4 kernels; K6 also with phase 5's mask through its bare C entry (K4's
     contract) against the K4 kernel with that mask; K5 and K6 again with
     guesses 11 px off the motion on LK level 1, so that their windows
     leave the staged region (more than one off-region reload per tracked
     point), against their plain versions and the K3 and K4 kernels; N = 0
     as in phase 5; one K6 wrapper call at phase 14's point one device op
     by the profiler;
 11. K7 (``csrc/roll.cu``, launched through its binding) against its plain
     version (``torch.roll``) over the roll probe's grid, (rows, 256) for
     rows 16..128 on both axes, with the amounts 0, 1, 3, 7, 9 / 100, -1, the
     axis length and + 5 (its 16-byte kernel), and on its one-element kernel
     (an odd width, a view off 16-byte alignment): max abs error 0; an
     output that is not its input,
     a CUDA graph of K7 calls equal to the eager calls, and a float64 or a
     3-D ``x`` refused with a ValueError and no launch counted;
 12. K8 (``csrc/lk_block.cu``, ``svo_lk_block_split``: every variant on
     K5's kernel) at the breakdown probe's operating point ((408, 1408),
     N = 1024): ``tmpl`` and ``reload`` (1 and 3 rounds) within 1e-4
     relative of their plain versions, ``full`` equal to K5's output bit
     for bit, each variant's call one device op by the profiler; N = 0 for
     each variant as in phase 5;
 13. this slice's paths, the probes of ``stereo_visual_odometry_tpu_torch/
     probes``: ``lk_block`` (K5/K6 against K3/K4 on the probes' pair moved
     by (3, 2) px), ``lk_breakdown`` (K8's four variants) and ``roll`` (the
     K7 envelope), each run with every count set to 0 just before and read
     just after; then their own timings (K3-K6 back to back and in a CUDA
     graph of 20 calls, the K8 split in graphs of 30 calls);
 14. K1-K7 timed with CUDA events against their plain versions, and inside
     a CUDA graph of 30 calls (every node a wrapper call launches); K1, K2
     and K7 against their library calls timed the same two ways
     (``F.grid_sample`` nearest for K1; bilinear with border padding on the
     unpadded image for K2; ``torch.roll`` for K7,
     ``probes/patch_timing.py``), with the wrappers' host time per call and,
     on lines of their own, K1's and K7's wrapper split piece by piece, and
     the graph time of a one-row K7 call (K7's practical floor); K3-K6
     through ``probes/lk_timing.py`` at two operating points, on a line of
     their own: the kernel alone (the bare C entry) in a graph, its template
     phase (``iters=0``) and one iteration, the wrapper's host time, the
     iterations and reloads per point, and the share of reloads served from
     the staged region by margin; and over every level call of the first 8
     bench frames (recorded from ``System.run_chunked``; K5 and K6 on K3's
     and K4's calls), the kernel alone in a graph, the iterations per
     tracked point and the staged share; and K8's split (template, one
     reload round, the rest of a full call);
 15. eager against graph: each slice of phases 6-9, on its first 16
     frames (8 for the three kernel-free branches of phase 9, the slowest
     eager steps), run by ``System`` with ``graph=False`` and then with the
     graph, in turns in this call: both
     ms/frame, ATE, accept and n_tracked, which must be equal, and whether
     the trajectories are equal bit for bit; then per path one profiled
     replay of the graph and one profiled eager step: device ops (nodes)
     per replay, device-busy ms, wall ms, the host time of one
     ``cudaGraphLaunch``, the replay back to back, and the device's idle
     share, one step of each from an idle device (``StageTimer``), and the
     step's ops by stage and function (``probes/step_nodes.py``);
 16. persistent tracks on phase 6's frames through ``run_chunked`` and the
     step graph: LK (1024 features) with phase 6's bounds and launches, ORB
     (2048) with phase 7's; each again eagerly, trajectories and final
     track ids equal bit for bit; the share of the previous frame's valid
     track ids kept, the largest track age;
 17. the JAX bench's BA leg (``bench.py:304-353``): 120 frames of a
     yaw-heavy drift scene (seed 11, 20000 landmarks, 376x1241 padded to
     384x1280), LK at 1024 features with persistent tracks, through
     ``System.run`` frontend-only, with ``BackendConfig(window=6,
     kf_every=4)`` and with ``marginalize=False``: ATE not aligned, as the
     JAX leg (frontend-only and marg < 0.30 m, marg <= 0.8 x drop-oldest,
     drop-oldest < 0.45 m), 20-40 solves, every solve's
     final cost <= 1.001 x its initial, K1 launched 1 + 27 per tracked
     frame in each pass; wall ms per solve (median, max); one steady
     marginalized ``bundle_adjust`` profiled (device ops, busy against wall
     ms, and 0 host syncs by ``torch.cuda.set_sync_debug_mode``); then ORB
     with the backend on phase 7's frames (>= 2 solves, ATE aligned < 1.5 x
     the JAX package's 0.4603 m on these frames); a JSON line of the leg's
     numbers, printed before the checks;
 18. slice 4 (``parallel/``): (a) LK dense at full width, S = 4 sequences
     of phase 6's 49 frames (the same frames, each sequence its own RANSAC
     draws, as the JAX bench's ``bench_tpu_batched``) through
     ``evaluate_batch`` with the batched step graph: per sequence ATE <
     0.05 m and accept >= 0.95, K1 launched 1 + 27 x 48 for the batch;
     then S = 1; aggregate frames/s, ms per batched frame, and of one
     profiled replay each the nodes, busy ms and idle share; (b) ``cell``,
     ``v1`` and ORB at S = 2 on 16 frames, each sequence within phases 8
     and 7's bounds, launches per batched frame as unbatched; (c) the
     batched entries of K1-K4 (one launch, a sequence axis) on phase 3-5's
     inputs stacked to B = 3: K1, K2 exact against the plain versions, K3,
     K4 phase 5's criteria, all bit for bit against B = 1 calls; each at
     B = 4 in a graph against 4 x B = 1 beside 4 x the bound; (d) the
     distributed solve on NCCL at world size 1 against ``bundle_adjust``
     (poses 5e-3, landmarks 3e-3 relative, costs 1e-4);
 19. slice 5 on phase 6's 49 frames as a KITTI directory (native 376x1241,
     8-bit PNGs written with zlib, a pose file, a reference-format YAML
     with the bench camera): first what the machine has (PIL, matplotlib,
     libpng's header, the native loader's build), the decoder the dataset
     picks and its ms per pair; K1 and K2 against their plain versions on
     the calls an eager step makes at the command line's 384x1248 (LK and
     ORB); (a) ``cli.main`` in process, LK: static shape (384, 1248), ATE <
     0.05 m, accept >= 0.95, K1 1 + 27 x 48, 49 poses written, the
     trajectory bit for bit ``System.run``'s on the decoded frames;
     (b) ``--chunked 16`` bit for bit ``run_chunked``'s, ``--mode orb``
     (2048 features) with phase 7's bounds and K1, K2 16 per frame,
     ``--batch`` over two directories (per sequence ATE < 0.05 m),
     ``--ba --window 6 --kf-every 4`` (>= 2 solves, ATE aligned < 1.5 x the
     JAX package's on the same frames on the CPU), ``--dump-overlays
     --every 10`` (the trajectory bit for bit (a)'s, the overlay arrays on
     the host, 4 PNGs where matplotlib imports, none without); (c) one
     ``python -m stereo_visual_odometry_tpu_torch.cli`` process on 8 frames
     (exit 0, ``ATE=``); (d) checkpoint/resume over 14 frames with
     persistent tracks, saved after 9 (after the first window slide of
     ``BackendConfig(window=3, kf_every=2)``), a fresh ``System`` loads and
     runs the rest: frontend-only bit for bit, with the backend poses within
     5e-3 (the solve sums with atomics) and the same keyframes; (e) the
     online feed, 16 pairs pushed with jitter inside slop, either side
     first: 16 results in order, none dropped, the worker's first step
     captures the graph, K1 1 + 27 x 15, the trajectory bit for bit
     ``System.run``'s; a burst into ``maxlen=2`` drops and never blocks;
     after ``close()`` no worker is alive;
 20. ``bench.py``'s card legs through ``probes/bench.py``'s own functions
     (``python -m stereo_visual_odometry_tpu_torch.probes.bench``): the
     kernel parity block on the first bench pair (K2 against the bilinear
     sampler, LK on K1 and K3 against the XLA formulation, BRIEF bits
     against float64), then ``gpu_lk`` and ``gpu_orb`` on phase 6's 49
     frames and on the flicker and yaw variants (``System.run_chunked``,
     chunk 16, the shipping configs at 1024 / 2048 features), the OpenCV
     rows read from ``BASELINE_MEASURED.json``, and the ``ba`` block built
     from phase 17's three passes; prints the bench's JSON line. LK rows:
     accept >= 0.95, K1 1 + 27 x 48, ATE < 0.05 m (clean, yaw), < 0.097
     (flicker); ORB rows: accept >= 0.95, K1 and K2 16 x 49, ATE < 0.07
     (clean), < 0.132 (flicker), < 0.144 (yaw); ``gpu_parity.ok`` with K1,
     K2 and K3 launched; 20-40 solves;
 21. the ``seq`` mesh (``parallel/``): S sequences split over two shards,
     ``(cuda:0, cuda:1)`` with two cards or more, else cuda:0 twice (the
     line says which), each shard with its own batched step graph;
     (a) LK dense at full width, S = 4 copies of phase 6's 49 frames
     through ``evaluate_batch``: per sequence ATE < 0.05 m and accept >=
     0.95, one graph per shard (27 K1 per replay), K1 launched 1 + 27 x 48
     per shard, each shard's replay as many nodes as a single-device S = 2
     graph's, each shard's trajectories bit for bit those of a
     single-device S = 2 run on its sequences with its draws; the
     unsplit S = 4 run on one device with the same draws within 0.05 m
     (phase 18's bound), its largest pose difference printed; aggregate
     frames/s and each card's idle share of one profiled replay per shard;
     (b) ``cell``, ``v1`` and ORB at S = 2 over the mesh on 16 frames,
     within phases 8 and 7's bounds, launches per shard as at S = 1;
     (c) ``probes/scaling.py``'s measurement (``--devices 1 --reps 2``, and
     ``1 2`` with two cards): SCALING.json's keys, the JSON line printed;
 22. the kernel report.
The launch counts hold without a reinit; each slice's run sets every
count to 0 just before ``run_chunked`` (``run`` in phase 17,
``evaluate_batch`` in phases 18 and 21, ``cli.main`` and the online feed in
phase 19, each bench row and the parity block in phase 20) and reads them
just after. The second-to-last line is the kernel
report (JSON), the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "stereo_visual_odometry_tpu_torch"

# The bench sequence (bench.py:31-49): KITTI 00 geometry, seed 3.
H, W, N_FRAMES = 384, 1280, 49
K1_SHAPES = [  # (Hp, Wp, S) that the LK path hands K1 at 384x1280
    (408, 1408, 24), (408, 1408, 22),   # LK level 0, padded
    (216, 768, 24), (216, 768, 22),     # LK level 1, padded
    (384, 1280, 3),                     # FAST score map, subpixel refine
]
N_POINTS = 1024
LK_LAUNCHES_PER_STEP = 27  # 26 LK window reads + 1 subpixel refine
LK_LEVELS_PER_STEP = 6     # level calls per step: stereo legs 1 level, temporal 2
# The kernel-free LK branches: config, K1 launches per tracked frame, frames.
LK_BRANCHES = [("xla", dict(lk_backend="xla"), 7), ("no_sweep", dict(lk_sweep=False), 45),
               ("not_predictive", dict(lk_predictive=False), 61)]
BRANCH_FRAMES = 16
EAGER_BRANCH_FRAMES = 8  # phase 15's depth for the kernel-free branches
LK_PADDED = [(408, 1408), (216, 768)]  # LK levels 0 and 1 at 384x1280, padded
WIN, PAD = 21, 12
# ORB at 384x1280, 8 levels of scale 1.2, 2048 features: each level's image
# shape, its score map padded to the 32-px cell, and its budget.
ORB_LEVELS = [(384, 1280), (320, 1067), (267, 889), (222, 741), (185, 617),
              (154, 514), (129, 429), (107, 357)]
ORB_BUDGETS = [445, 371, 309, 257, 214, 179, 149, 124]
ORB_FEATURES, ORB_PATCH = 2048, 39
ORB_LAUNCHES_PER_FRAME = 16  # per kernel: 8 levels x 2 images
K1_RAGGED, K2_RAGGED = (0, 1, 7, 1023), (1, 7, 130)  # ragged point counts
BA_FRAMES = 120  # the JAX bench's BA leg (bench.py:304-353, probes/ba_leg.py)
# H100 SXM datasheet peaks: HBM bytes/s, float32 FLOP/s.
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_SAID = [time.perf_counter()]


def say(line: str) -> None:
    """Print a phase's line with the seconds since the previous line."""
    now = time.perf_counter()
    print(f"{line} [{now - _SAID[0]:.1f} s]", flush=True)
    _SAID[0] = now


def lk_level_bound(torch, stats, corners, pts, active, hp, wp, kernel, io=None):
    """Least time of one K3-K6 call on these inputs: the distinct pixels of
    the template windows and of the windows the points visited (read once),
    the inputs and outputs, against the flops the taken iterations need.
    ``io``: the bytes of the points' inputs and outputs, by default the
    finished contract's with a mask (pts, guess and a bool mask in; flow
    and a bool ok out, no statistics)."""
    r = (WIN - 1) // 2
    tp = pts[active] + PAD
    tr = torch.floor(tp[:, 1] - r - 1.0).long().clamp(0, hp - WIN - 3)
    tc = torch.floor(tp[:, 0] - r - 1.0).long().clamp(0, wp - WIN - 3)
    n, n_act = pts.shape[0], int(active.sum())
    pix = (window_pixels(torch, hp, wp, tr, tc, WIN + 3) +
           window_pixels(torch, hp, wp, corners[:, 0].long(), corners[:, 1].long(),
                         WIN + 1))
    io = n * (8 + 8 + 1) + n * (8 + 1) if io is None else io  # pts, guess, active; flow, ok
    ww = WIN * WIN
    flops = n_act * (11 * (WIN + 2) ** 2 + 14 * ww)  # blend, gradients, 5 dots
    iters, reloads = int(stats["iters"].sum()), int(stats["reloads"].sum())
    if kernel == "cell":
        flops += reloads * 16 * ww + iters * 30  # 8 dots per cell; scalar steps
    else:
        flops += iters * (16 * ww + 10)          # blend + 2 dots per iteration
    return bound(4 * pix + io, flops)


def split_bound(torch, label, inputs, variants, stats=None, corners=None):
    """Least time of one K8 call: the distinct pixels of the template windows
    and (``reload``) of every forced round's windows, read once, with the
    inputs and outputs, against the flops of the template and the rounds'
    dots; ``full`` is K5's bound from its taken iterations (``stats``) and
    visited windows (``corners``)."""
    pts, (hp, wp) = inputs["pts"], inputs["prev"].shape
    n, ww, r = pts.shape[0], WIN * WIN, (WIN - 1) // 2
    mode, rounds = variants[label]
    if mode == "full":  # pts in; the delta and a float32 gate out
        return lk_level_bound(torch, stats, corners, pts,
                              torch.ones(n, dtype=torch.bool, device=pts.device),
                              hp, wp, "cell", io=n * 8 + n * (8 + 4))
    tp = pts + PAD
    tr = torch.floor(tp[:, 1] - r - 1.0).long().clamp(0, hp - WIN - 3)
    tc = torch.floor(tp[:, 0] - r - 1.0).long().clamp(0, wp - WIN - 3)
    pix = window_pixels(torch, hp, wp, tr, tc, WIN + 3)
    flops = n * (11 * (WIN + 2) ** 2 + 14 * ww)
    io = n * 8 + n * (8 + 4)  # pts; flow, ok
    if mode == "reload":
        rows = torch.cat([torch.floor(tp[:, 1] - r + rd).long().clamp(0, hp - WIN - 1)
                          for rd in range(rounds)])
        cols = torch.cat([torch.floor(tp[:, 0] - r + rd).long().clamp(0, wp - WIN - 1)
                          for rd in range(rounds)])
        pix += window_pixels(torch, hp, wp, rows, cols, WIN + 1)
        flops += n * rounds * 16 * ww
        io += n * rounds * 8 * 4  # the dots
    return bound(4 * pix + io, flops)


def level_call(torch, fn, *args, **kw):
    """One LK level call with its stats: (flow, ok, stats)."""
    stats = {}
    flow, ok = fn(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    return flow, ok, stats


def compare_levels(torch, tag, got, want, active, eps, shift, same_iters=False):
    """Hold one LK level call's (flow, ok, stats) to another's on the same
    inputs: ok masks >= 99% equal, more than half the tracked points kept by
    both, flows within 1e-3 px for >= 98% of those and within eps for all
    (sums in another order), no untracked point ok, the median error to the
    true shift < 0.05 px; with ``same_iters``, the mean iterations and
    reloads per tracked point within 0.01 of each other. Returns (the
    largest flow difference, a description)."""
    (fk, okk, st_k), (fp, okp, st_p) = got, want
    agree = float((okk == okp).float().mean())
    both = okk & okp
    d = (fk - fp).abs().amax(-1)[both]
    far = float((d > 1e-3).float().mean()) if len(d) else 0.0
    dmax = float(d.max()) if len(d) else 0.0
    true_err = float((fk[both] - torch.tensor(shift, device="cuda")).norm(dim=-1).median())
    check(agree >= 0.99, f"{tag}: ok masks agree on {agree} < 0.99")
    check(int(both.sum()) > 0.5 * int(active.sum()),
          f"{tag}: kept {int(both.sum())} of {int(active.sum())} points")
    check(dmax <= eps and far <= 0.02, f"{tag}: flows differ by up to {dmax} "
          f"({far:.3%} above 1e-3)")
    check(not bool(okk[~active].any()), f"{tag}: an inactive point is ok")
    check(true_err < 0.05, f"{tag}: median error {true_err} px to the true shift {shift}")
    per = lambda st, key: float(st[key][active].float().mean())
    it_k, rl_k, it_p, rl_p = (per(st_k, "iters"), per(st_k, "reloads"),
                              per(st_p, "iters"), per(st_p, "reloads"))
    if same_iters:
        check(abs(it_k - it_p) <= 0.01 and abs(rl_k - rl_p) <= 0.01,
              f"{tag}: iterations/reloads per tracked point {it_k}/{rl_k} against "
              f"{it_p}/{rl_p}")
    return dmax, (f"{tag}: max flow diff {dmax:.2e} px ({far:.2%} > 1e-3), ok agree "
                  f"{agree:.4f}, median error to the shift {true_err:.4f} px, "
                  f"iterations/reloads per tracked point {it_k:.2f}/{rl_k:.2f} against "
                  f"{it_p:.2f}/{rl_p:.2f}")


def no_points(torch, tag, kernels, dtypes, call):
    """A wrapper call with N = 0: empty outputs of the dtypes given, and no
    launch counted by any kernel. Returns a description."""
    before = {name: fn.launches for name, fn in kernels.items()}
    outs = call()
    torch.cuda.synchronize()
    check(all(o.shape[0] == 0 for o in outs), f"{tag} at N = 0: shapes "
          f"{[tuple(o.shape) for o in outs]}")
    check([o.dtype for o in outs] == list(dtypes), f"{tag} at N = 0: dtypes "
          f"{[o.dtype for o in outs]}, want {list(dtypes)}")
    after = {name: fn.launches for name, fn in kernels.items()}
    check(after == before, f"{tag} at N = 0 counted a launch: {after} against {before}")
    return f"{tag} {[tuple(o.shape) for o in outs]}"


def window_pixels(torch, hp, wp, rows, cols, size):
    """Distinct pixels of (hp, wp) that size x size windows at the corners
    (rows, cols) cover: the least the gather must read."""
    off = torch.arange(size, device=rows.device)
    r = (rows[:, None] + off).clamp(0, hp - 1)[:, :, None]
    c = (cols[:, None] + off).clamp(0, wp - 1)[:, None, :]
    seen = torch.zeros((hp, wp), dtype=torch.bool, device=rows.device)
    seen[r.expand(-1, size, size), c.expand(-1, size, size)] = True
    return int(seen.sum())


def one_node(torch, profiling, tag, call) -> str:
    """Check that one ``call`` (after one call unprofiled) is one device op
    by the profiler, a kernel of csrc/lk_block.cu; returns its name. A
    session that recorded no device op (CUPTI now and then delivers no
    record of a short session) is taken again, up to three times."""
    call()
    for _ in range(3):
        torch.cuda.synchronize()
        with profiling.trace(None) as prof:
            call()
            torch.cuda.synchronize()
        names = profiling.device_activity(prof)["names"]
        if names:
            break
    check(sum(names.values()) == 1 and "lk_block_cell_kernel" in next(iter(names)),
          f"{tag}: one call ran {names}, want one lk_block_cell_kernel")
    return next(iter(names))


def bound(bytes_moved, flops):
    """Least time on the card (ms) and what bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_launches(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def run_slice(np, torch, system_mod, trajectory, kernels, cfg, frames, poses_gt, tag,
              chunk=16, graph=True, keep=False):
    """Drive ``System.run_chunked`` once (the step from its CUDA graph, or
    eagerly with ``graph=False``) with the launch counts set to 0 just
    before and read just after; returns (numbers, launches), the numbers
    with the ``System`` under "system" if ``keep``."""
    sys_ = system_mod.System(cfg, device="cuda", graph=graph)
    reset_launches(kernels)
    t0 = time.perf_counter()
    traj = sys_.run_chunked(frames, chunk=chunk)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    check(traj.shape == (len(frames), 4, 4) and np.isfinite(traj).all(),
          f"{tag}: trajectory shape {traj.shape} or non-finite values")
    tracked = [m for m in sys_.metrics if not m["init"]]
    rpe_t, rpe_r = trajectory.rpe(traj, poses_gt)
    steady = [m["time_s"] for m in sys_.metrics[1 + chunk:]]  # after the first chunk
    out = {
        "ate": trajectory.ate_rmse(traj, poses_gt), "rpe_t": rpe_t, "rpe_r": rpe_r,
        "ate_from_1": trajectory.ate_rmse(traj[1:], poses_gt[1:]),
        "accept": float(np.mean([m["accept"] for m in tracked])),
        "n_tracked": float(np.mean([m["n_tracked"] for m in tracked])),
        "ms_frame": 1e3 * float(np.mean(steady)), "n_steady": len(steady), "wall": wall,
        "no_reinit": all(m["n_detected"] >= cfg.vo.min_features_detect
                         for m in sys_.metrics),
        "traj": traj, "accepts": [m["accept"] for m in tracked],
        "tracked": [m["n_tracked"] for m in tracked],
        "capture_s": sys_.graph.capture_s if graph else 0.0,
    }
    if keep:
        out["system"] = sys_
    return out, launches


def describe_slice(tag, r, launches, want, n_frames=N_FRAMES):
    return (f"{tag} System.run_chunked on cuda, {n_frames} frames {H}x{W}: "
            f"ATE {r['ate']:.4f} m (from frame 1: {r['ate_from_1']:.4f} m), RPE {r['rpe_t']:.4f} m / {r['rpe_r']:.5f} rad, "
            f"accept {r['accept']:.3f}, n_tracked {r['n_tracked']:.1f}, steady "
            f"{r['ms_frame']:.2f} ms/frame ({1e3 / r['ms_frame']:.1f} fps; "
            f"{r['n_steady']} frames after the first chunk), whole run "
            f"{r['wall']:.2f} s (warm-up and capture {r['capture_s']:.2f} s), launches "
            f"{launches} (want {want} without a reinit)")


def check_slice(tag, r, launches, want, max_ate, min_accept, ate="ate"):
    check(r[ate] < max_ate, f"{tag} {ate} {r[ate]} m >= {max_ate} m")
    check(r["accept"] >= min_accept, f"{tag} accept rate {r['accept']} < {min_accept}")
    for name, n in want.items():
        check(n == 0 or launches[name] > 0, f"the {tag} path never launched {name}")
    if r["no_reinit"]:
        check(launches == want, f"{tag} launches {launches}, want {want}")


def profile_step(np, torch, profiling, step_nodes, tag, eager, graphed, frame):
    """One profiled step of each run's ``System`` after its run, on its last
    frame: the eager ``step_fn`` and one replay of the graph (device ops,
    busy and wall ms, the idle share against that wall and against the run's
    steady ms/frame); for the graph also the host time of one launch
    (median of 5) and the replay back to back (``time_jitted``, 10
    replays); one eager step and one replay from an idle device, 3 of each
    in turns (``StageTimer``); and where the step's ops come from
    (``probes/step_nodes.py``: the aten ops with device work of one eager
    step, by stage and by function, the four most frequent of each).
    Returns a description."""
    sys_e, sys_g = eager["system"], graphed["system"]
    il, ir = (torch.as_tensor(a, device="cuda") for a in frame)
    nodes = step_nodes.count(sys_e.step_fn, sys_e.state, il, ir)
    head = lambda d: ", ".join(f"{k} x{v}" for k, v in list(d.items())[:4])
    host_us = []
    for _ in range(5):
        t0 = time.perf_counter()
        sys_g.graph.launch()
        host_us.append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    replay_ms = 1e3 * profiling.time_jitted(sys_g.graph.launch, iters=10, warmup=1)
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("eager"):
            sys_e.step_fn(sys_e.state, il, ir)
        with timer.stage("graph"):
            sys_g.graph.launch()
    stage_ms = {k: v["mean_ms"] for k, v in timer.summary().items()}
    out = []
    for name, call, run in (("eager", lambda: sys_e.step_fn(sys_e.state, il, ir), eager),
                            ("graph", sys_g.graph.launch, graphed)):
        for _ in range(3):  # CUPTI now and then records nothing of a trace
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiling.trace(None) as prof:
                call()
                torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            act = profiling.device_activity(prof)
            if act["ops"]:
                break
        top = sorted(act["names"].items(), key=lambda kv: -kv[1])[:3]
        out.append(f"{name} {act['ops']} ops, busy {act['busy_ms']:.3f} ms, span "
                   f"{act['span_ms']:.3f} ms, wall {wall:.3f} ms (profiled), idle "
                   f"{1 - act['busy_ms'] / wall:.3f} of that wall and "
                   f"{1 - act['busy_ms'] / run['ms_frame']:.3f} of the steady "
                   f"{run['ms_frame']:.2f} ms/frame; most frequent "
                   + ", ".join(f"{n[:40]} x{c}" for n, c in top))
    return (f"{tag}: " + "; ".join(out) + f"; graph launch host time "
            f"{np.median(host_us):.1f} us, replay back to back {replay_ms:.3f} ms; one step from "
            f"an idle device (StageTimer, 3 each in turns): eager {stage_ms['eager']:.3f} ms, "
            f"graph {stage_ms['graph']:.3f} ms; aten ops "
            f"with device work {nodes['total']} (+ the kernels {sys_g.graph.per_replay}), "
            f"by stage: {head(nodes['by_stage'])}; by function: {head(nodes['by_function'])}")


def track_stats(np, metrics) -> tuple[float, int]:
    """Over a persistent run's tracked frames: the mean share of the
    previous frame's valid track ids that are valid again, and the largest
    track age."""
    shares, age, prev = [], 0, None
    for m in metrics:
        if "track_id" not in m:
            continue
        ids = m["track_id"][m["track_valid"]]
        age = max(age, int(m["track_age"][m["track_valid"]].max(initial=0)))
        if prev is not None and len(prev):
            shares.append(float(np.isin(prev, ids).mean()))
        prev = ids
    return float(np.mean(shares)), age


def profile_solve(torch, profiling, be, ba) -> dict:
    """One window solve of the backend ``be`` as it stands (its problem
    already on the card, a solve of it run once before): the device ops,
    busy and wall ms by the profiler, and the host syncs inside the
    ``bundle_adjust`` call (under ``torch.cuda.set_sync_debug_mode("warn")``
    every synchronizing call warns; reading the cost back after the call
    is the control, one sync the count must see)."""
    import warnings
    problem = be.window_problem()
    check(problem is not None, "the backend has no window to solve")
    ba.bundle_adjust(**problem["solve"])
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then records nothing of a trace
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profiling.trace(None) as prof:
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = ba.bundle_adjust(**problem["solve"])
                    issue_ms = 1e3 * (time.perf_counter() - t0)
                    n_solve = len(caught)
                    float(out["cost_final"])  # one sync: the count must see it
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                wall = 1e3 * (time.perf_counter() - t0)
        act = profiling.device_activity(prof)
        if act["ops"]:
            break
    sync = lambda w: ("synchroniz" in str(w.message).lower()
                      and "prototype" not in str(w.message))
    syncs = [str(w.message) for w in caught[:n_solve] if sync(w)]
    check(sum(map(sync, caught[n_solve:])) == 1,
          f"the sync count missed the control's read-back: {caught[n_solve:]}")
    check(bool(torch.isfinite(out["poses"]).all()) and
          float(out["cost_final"]) <= 1.001 * float(out["cost_initial"]),
          f"the profiled solve: cost {float(out['cost_initial'])} -> "
          f"{float(out['cost_final'])}")
    top = sorted(act["names"].items(), key=lambda kv: -kv[1])[:3]
    return {"ops": act["ops"], "busy_ms": act["busy_ms"], "span_ms": act["span_ms"],
            "wall_ms": wall, "issue_ms": issue_ms, "host_syncs": len(syncs),
            "sync_lines": syncs[:3], "top": top, "n_kf": problem["n_kf"],
            "n_obs": problem["n_obs"], "n_landmarks": len(problem["tid_to_idx"])}


def persistent_phase(mods, cam, frames, poses_gt) -> dict:
    """Phase 16: persistent tracks, LK and ORB, through ``run_chunked`` and
    the step graph, then eagerly; returns each path's launches."""
    np, torch, kernels = mods["np"], mods["torch"], mods["kernels"]
    VOConfig, RunConfig = mods["VOConfig"], mods["RunConfig"]
    zero = dict.fromkeys(kernels, 0)
    lines, launches = [], {}
    for tag, vo, want, max_ate in (
            ("LK-persistent", VOConfig(height=H, width=W, max_features=N_POINTS,
                                       persistent_tracks=True),
             dict(zero, extract_windows_int=1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1)), 0.05),
            ("ORB-persistent", VOConfig(mode="orb", height=H, width=W,
                                        max_features=ORB_FEATURES, persistent_tracks=True),
             dict(zero, extract_windows_int=ORB_LAUNCHES_PER_FRAME * N_FRAMES,
                  extract_patches=ORB_LAUNCHES_PER_FRAME * N_FRAMES), 0.07)):
        cfg = RunConfig(camera=cam, vo=vo)
        run = lambda graph: run_slice(np, torch, mods["system_mod"], mods["trajectory"],
                                      kernels, cfg, frames, poses_gt, tag, graph=graph,
                                      keep=True)
        graphed, launches[tag] = run(True)
        check_slice(tag, graphed, launches[tag], want, max_ate, 0.95)
        eager, _ = run(False)
        ids_g, ids_e = (r["system"].state["track_id"].cpu() for r in (graphed, eager))
        same = (bool(np.array_equal(eager["traj"], graphed["traj"])) and
                bool(torch.equal(ids_g, ids_e)))
        check(same and eager["accepts"] == graphed["accepts"],
              f"{tag}: the graph differs from the eager step: ATE {graphed['ate']} against "
              f"{eager['ate']}, track ids equal {bool(torch.equal(ids_g, ids_e))}")
        share, age = track_stats(np, graphed["system"].metrics)
        lines.append(describe_slice(tag, graphed, launches[tag], want)
                     + f"; ids kept from the previous frame {share:.3f}, largest track age "
                     f"{age}, next id {int(graphed['system'].state['next_id'])}; eager "
                     f"{eager['ms_frame']:.2f} ms/frame, trajectory and final track ids "
                     f"equal to the graph's bit for bit: {same}")
        del graphed, eager
        torch.cuda.empty_cache()
    say("[16/22] " + "; ".join(lines))
    return launches


def ba_leg_phase(mods, cam, frames, poses_gt, smi) -> tuple[dict, dict]:
    """Phase 17: the JAX bench's BA leg through ``System.run`` (three
    passes), one profiled solve, and ORB with the backend on phase 7's
    frames; returns each pass's launches, and the three passes' ATE and
    solves (label -> dict) for phase 20's ``ba`` block."""
    np, torch, kernels, ba_leg = mods["np"], mods["torch"], mods["kernels"], mods["ba_leg"]
    VOConfig, RunConfig, BackendConfig = mods["VOConfig"], mods["RunConfig"], mods["BackendConfig"]
    launches = {}
    ba_frames, ba_gt, ba_cam = ba_leg.leg_frames()
    ba_cfg = ba_leg.leg_run_config(ba_cam)
    leg, be_marg = {}, None
    for label, bcfg in ba_leg.leg_configs():
        reset_launches(kernels)
        r = ba_leg.run_pass(ba_cfg, ba_frames, ba_gt, bcfg, "cuda")
        check(r["traj"].shape == (BA_FRAMES, 4, 4) and np.isfinite(r["traj"]).all(),
              f"BA leg {label}: trajectory of shape {r['traj'].shape} or non-finite")
        launches[f"ba_leg_{label}"] = {name: fn.launches for name, fn in kernels.items()}
        leg[label] = {k: r[k] for k in ("ate", "accept", "solves", "ms_frame")}
        for solve in r["solves"]:
            check(solve["cost_final"] <= 1.001 * solve["cost_initial"],
                  f"BA leg {label}: a solve raised the cost {solve['cost_initial']} -> "
                  f"{solve['cost_final']}")
        if label == "ba_marg":
            be_marg = r["system"].backend
        del r
    want_k1 = 1 + LK_LAUNCHES_PER_STEP * (BA_FRAMES - 1)
    fe, mg, dr = (leg[k]["ate"] for k in ("frontend_only", "ba_marg", "ba_drop_oldest"))
    n_solves = len(leg["ba_marg"]["solves"])
    walls = {k: [1e3 * r["wall_s"] for r in leg[k]["solves"]]
             for k in ("ba_marg", "ba_drop_oldest")}
    k1 = [launches[f"ba_leg_{k}"]["extract_windows_int"] for k in leg]
    say(f"[17/22] BA leg passes: ATE {fe:.4f} / {mg:.4f} / {dr:.4f} m, solves {n_solves}, "
          f"K1 launches {k1}")
    prof = profile_solve(torch, mods["profiling"], be_marg, mods["ba"])
    del be_marg
    # ORB with the backend on phase 7's frames.
    orb_vo = VOConfig(mode="orb", height=H, width=W, max_features=ORB_FEATURES,
                      persistent_tracks=True)
    reset_launches(kernels)
    r = ba_leg.run_pass(RunConfig(camera=cam, vo=orb_vo), frames, poses_gt,
                        BackendConfig(window=6, kf_every=4), "cuda", align=True)
    launches["ORB-ba"] = {name: fn.launches for name, fn in kernels.items()}
    orb_ate, orb_acc, orb_solves, orb_ms = (r[k] for k in ("ate", "accept", "solves",
                                                             "ms_frame"))
    orb_ate_raw = mods["trajectory"].ate_rmse(r["traj"], poses_gt, align=False)
    del r
    med = lambda v: float(np.median(v)) if v else float("nan")
    orb_wall = med([1e3 * r["wall_s"] for r in orb_solves])
    say(f"[17/22] BA leg on {smi}, System.run on cuda, {BA_FRAMES} frames 376x1241 "
          f"padded to {H}x{W}, LK {N_POINTS} features, persistent tracks; ATE (not aligned) "
          f"frontend-only {fe:.4f} m, BA+marg {mg:.4f} m, drop-oldest {dr:.4f} m; accept "
          + ", ".join(f"{k} {v['accept']:.3f}" for k, v in leg.items())
          + f"; solves marg {n_solves}, drop-oldest {len(leg['ba_drop_oldest']['solves'])}; "
          "wall ms per solve (assembly, device solve, copy back) median / max: "
          + ", ".join(f"{k} {med(v):.2f} / {max(v, default=float('nan')):.2f}"
                      for k, v in walls.items())
          + "; steady ms per frame without a solve: "
          + ", ".join(f"{k} {v['ms_frame']:.2f}" for k, v in leg.items())
          + f"; K1 launches per pass {want_k1}; one steady marginalized solve profiled "
          f"(K={prof['n_kf']}, {prof['n_landmarks']} landmarks, {prof['n_obs']} "
          f"observations): {prof['ops']} device ops, busy {prof['busy_ms']:.3f} ms, span "
          f"{prof['span_ms']:.3f} ms, wall {prof['wall_ms']:.3f} ms (host issue "
          f"{prof['issue_ms']:.3f} ms), idle {1 - prof['busy_ms'] / prof['wall_ms']:.3f}, host "
          f"syncs {prof['host_syncs']}, most frequent "
          + ", ".join(f"{n[:40]} x{c}" for n, c in prof["top"])
          + f"; ORB with the backend (phase 7's {N_FRAMES} frames, {ORB_FEATURES} features, "
          f"window 6, keyframe every 4): ATE {orb_ate:.4f} m aligned ({orb_ate_raw:.4f} not), "
          f"accept {orb_acc:.3f}, {len(orb_solves)} solves, wall ms per solve median "
          f"{orb_wall:.2f}, steady {orb_ms:.2f} ms/frame without a solve")
    print(json.dumps({"ba_leg": {
        "card": smi, "n_frames": BA_FRAMES, "ate_frontend_only_m": fe, "ate_ba_marg_m": mg,
        "ate_ba_drop_oldest_m": dr, "n_solves": n_solves,
        "n_solves_drop_oldest": len(leg["ba_drop_oldest"]["solves"]),
        "ms_per_solve_median": med(walls["ba_marg"]), "ms_per_solve_max": max(walls["ba_marg"]),
        "ms_per_solve_drop_oldest_median": med(walls["ba_drop_oldest"]),
        "ms_frame_no_solve": {k: v["ms_frame"] for k, v in leg.items()},
        "solve_profile": {k: prof[k] for k in ("ops", "busy_ms", "span_ms", "wall_ms",
                                               "issue_ms", "host_syncs")},
        "orb": {"ate_m": orb_ate, "ate_not_aligned_m": orb_ate_raw, "accept": orb_acc,
                "n_solves": len(orb_solves), "ms_per_solve_median": orb_wall}}}))
    check(fe < 0.30 and mg < 0.30, f"BA leg ATE frontend-only {fe} m, marg {mg} m: >= 0.30")
    # Marginalization carries the slid keyframes' information: it must beat
    # drop-oldest (reference 0.1898 against 0.3038 m). "marg <= 1.05 x
    # frontend-only", the reference's `improved`, does not hold on the
    # port, whose frontend is the more accurate (PERF.md, section 6).
    check(mg <= 0.8 * dr, f"BA leg: marg ATE {mg} m > 0.8 x drop-oldest {dr} m")
    check(dr < 0.45, f"BA leg: drop-oldest ATE {dr} m >= 0.45")
    check(20 <= n_solves <= 40, f"BA leg: {n_solves} solves, want 20-40")
    check(k1 == [want_k1] * 3, f"BA leg: K1 launches {k1}, want {want_k1} each")
    check(prof["host_syncs"] == 0, f"the profiled solve synchronized with the host "
          f"{prof['host_syncs']} times: {prof['sync_lines']}")
    # The JAX package on these frames (tests/torch_ba_reference.py orb_bench,
    # on the CPU): frontend-only 0.0455 m aligned, with the backend 0.4603:
    # its prior degrades ORB (drop-oldest 0.0654). Held to 1.5x that.
    check(orb_ate < 1.5 * 0.4603 and len(orb_solves) >= 2 and all(
        r["cost_final"] <= 1.001 * r["cost_initial"] for r in orb_solves),
          f"ORB with the backend: ATE {orb_ate} m, {len(orb_solves)} solves")
    return launches, {k: {"ate": v["ate"], "solves": v["solves"]} for k, v in leg.items()}


# Phase 20's ATE bounds (m) per bench row: the clean rows phases 6 and 7's;
# flicker and yaw twice the JAX reference's TPU ATE (BENCH_r05.json
# tpu_{lk,orb}_{flicker,yaw}), never below the clean bound.
BENCH_MAX_ATE = {"gpu_lk": 0.05, "gpu_lk_flicker": 0.097, "gpu_lk_yaw": 0.05,
                 "gpu_orb": 0.07, "gpu_orb_flicker": 0.132, "gpu_orb_yaw": 0.144}


def bench_phase(mods, frames, ba_passes, smi) -> dict:
    """Phase 20: the JAX bench's card legs through ``probes/bench.py``'s own
    functions (``bench_result``: the kernel parity block, the six rows on
    49 frames each, the OpenCV rows from ``BASELINE_MEASURED.json``), its
    ``ba`` block built by ``bench.ba_block`` from phase 17's three passes;
    prints the JSON line ``python -m ...probes.bench`` prints. Returns each
    run's launches."""
    torch, kernels, bench = mods["torch"], mods["kernels"], mods["bench"]
    zero = dict.fromkeys(kernels, 0)
    launches = {}

    @contextlib.contextmanager
    def each_run(name):
        reset_launches(kernels)
        yield
        torch.cuda.synchronize()
        launches[f"bench_{name}"] = {k: fn.launches for k, fn in kernels.items()}

    t0 = time.perf_counter()
    line = bench.bench_result("cuda", lambda: bench.ba_block(ba_passes, BA_FRAMES), each_run,
                              frames=frames)
    secs = time.perf_counter() - t0
    print(json.dumps(line))
    rows = line["parity"]
    want = {"lk": dict(zero, extract_windows_int=1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1)),
            "orb": dict(zero, extract_windows_int=ORB_LAUNCHES_PER_FRAME * N_FRAMES,
                        extract_patches=ORB_LAUNCHES_PER_FRAME * N_FRAMES)}
    par = launches["bench_gpu_parity"]
    say(f"[20/22] bench.py's card legs (probes/bench.py) on {smi}, {N_FRAMES} frames {H}x{W}: "
        + "; ".join(f"{k} ATE {r['ate_m']} m, accept {r['accept_rate']}, n_tracked "
                    f"{r['n_tracked']}, {r['fps']} frames/s, launches "
                    f"{ {n: c for n, c in launches['bench_' + k].items() if c} }"
                    for k, r in rows.items() if k.startswith("gpu_"))
        + f"; headline {line['value']} {line['unit']}, vs_baseline {line['vs_baseline']} "
        f"(OpenCV rows cached); gpu_parity {line['gpu_parity']}, launches "
        f"{ {n: c for n, c in par.items() if c} }; ba {line['ba']}; {secs:.1f} s")
    for name, max_ate in BENCH_MAX_ATE.items():
        r = rows[name]
        check(r["ate_m"] < max_ate and r["accept_rate"] >= 0.95,
              f"bench {name}: ATE {r['ate_m']} m (bound {max_ate}), accept {r['accept_rate']}")
        mode = name.split("_")[1]
        check(launches[f"bench_{name}"] == want[mode],
              f"bench {name}: launches {launches[f'bench_{name}']}, want {want[mode]}")
    check(line["gpu_parity"]["ok"] is True, f"bench gpu_parity: {line['gpu_parity']}")
    check(all(par[k] > 0 for k in ("extract_windows_int", "extract_patches",
                                   "level_track_cell")),
          f"bench gpu_parity did not launch K1, K2 and K3: {par}")
    check(20 <= line["ba"]["n_solves"] <= 40, f"bench ba: {line['ba']}")
    return launches


def stacked(torch, make, seeds):
    """``make(seed)`` for each seed (tuples of tensors), stacked along a new
    leading axis: one sequence per seed."""
    parts = [make(seed) for seed in seeds]
    return tuple(torch.stack(list(xs)) for xs in zip(*parts))


def batched_entries(mods, bounds) -> dict:
    """Phase 18c: K1-K4's batched entries on phase 3-5's inputs stacked to
    B = 3 sequences (other images and points per sequence) against their
    plain versions and against B = 1 wrapper calls, each batched call one
    launch; then each at B = 4 (phase 14's operating point, four copies) in a
    CUDA graph against four B = 1 calls in one, beside 4 x the single call's
    bound (``bounds``: name -> (ms, by)). Returns name -> numbers."""
    torch, patch, lk_cell, lk_v1 = mods["torch"], mods["patch"], mods["lk_cell"], mods["lk_v1"]
    lk_timing, patch_timing, timing = mods["lk_timing"], mods["patch_timing"], mods["timing"]
    k1_inputs, k2_inputs = patch_timing.k1_inputs, patch_timing.k2_inputs
    B, out = 3, {}

    def one_launch(counter, call):
        before = counter.launches
        res = call()
        torch.cuda.synchronize()
        check(counter.launches == before + 1, f"{counter.__name__}'s batched call counted "
              f"{counter.launches - before} launches, want 1")
        return res

    err = 0.0
    for i, (hp, wp, S) in enumerate(K1_SHAPES):
        imgs, cors = stacked(torch, lambda sd: k1_inputs(hp, wp, S, seed=sd),
                             [500 + 10 * i + b for b in range(B)])
        got = one_launch(patch.extract_windows_int, lambda: patch.extract_windows_int_batched(
            imgs, cors, S))
        for b in range(B):
            plain = patch.extract_windows_int_reference(imgs[b], cors[b], S)
            check(torch.equal(got[b], plain) and
                  torch.equal(got[b], patch.extract_windows_int(imgs[b], cors[b], S)),
                  f"K1 batched differs at {(hp, wp, S)} sequence {b}")
            err = max(err, float((got[b] - plain).abs().max()))
    out["extract_windows_int"] = {"entry": "svo_extract_windows_int_batched",
                                  "max_abs_err": err}
    err = 0.0
    for i, ((h, w), n) in enumerate(zip(ORB_LEVELS, ORB_BUDGETS)):
        imgs, xy = stacked(torch, lambda sd: k2_inputs(h, w, n, seed=sd),
                           [600 + 10 * i + b for b in range(B)])
        got = one_launch(patch.extract_patches,
                         lambda: patch.extract_patches_batched(imgs, xy, ORB_PATCH))
        for b in range(B):
            plain = patch.extract_patches_clamped(imgs[b], xy[b], ORB_PATCH)
            check(torch.equal(got[b], plain) and
                  torch.equal(got[b], patch.extract_patches(imgs[b], xy[b], ORB_PATCH)),
                  f"K2 batched differs at {(h, w, n)} sequence {b}")
            err = max(err, float((got[b] - plain).abs().max()))
    out["extract_patches"] = {"entry": "svo_extract_patches_batched", "max_abs_err": err}
    for name, fn, batched, plain in (
            ("level_track_cell", lk_cell.level_track_cell, lk_cell.level_track_cell_batched,
             lk_cell.level_track_cell_reference),
            ("level_track_v1", lk_v1.level_track_v1, lk_v1.level_track_v1_batched,
             lk_v1.level_track_v1_reference)):
        err = 0.0
        for lvl, (hp, wp) in enumerate(LK_PADDED):
            shift = (2.3 / 2 ** lvl, -1.4 / 2 ** lvl)
            seeds = [700 + 10 * lvl + b for b in range(B)]
            prev, nxt = stacked(torch, lambda sd: lk_timing.textured_pair(hp, wp, shift, sd),
                                seeds)
            pts, guess, active = stacked(torch, lambda sd: lk_timing.lk_level_inputs(
                hp, wp, seed=sd + 100), seeds)
            kw = dict(win=WIN, iters=30, eps=0.01, search_radius=6, pad=PAD)
            flow, ok = one_launch(fn, lambda: batched(prev, nxt, pts, guess, active=active,
                                                      **kw))
            for b in range(B):
                args = (prev[b], nxt[b], pts[b], guess[b])
                f1, o1, st1 = level_call(torch, fn, *args, active=active[b], **kw)
                check(torch.equal(flow[b], f1) and torch.equal(ok[b], o1),
                      f"{name} batched differs from B = 1 at {(hp, wp)} sequence {b}")
                dmax, _ = compare_levels(
                    torch, f"{name} batched vs plain {(hp, wp)} sequence {b}",
                    (flow[b], ok[b], st1), level_call(torch, plain, *args, active=active[b], **kw),
                    active[b], 0.01, shift, same_iters=True)
                err = max(err, dmax)
        out[name] = {"entry": f"svo_lk_level_{name.split('_')[-1]}_batched",
                     "max_abs_err": err}

    # B = 4 in a graph against 4 x B = 1 in one, at phase 14's points.
    hp, wp, S = patch_timing.K1_SHAPE
    img, cor = k1_inputs(hp, wp, S, seed=S)
    (h, w), n, P = patch_timing.K2_SHAPE, patch_timing.K2_N, patch_timing.K2_P
    img2, xy = k2_inputs(h, w, n, seed=7)
    hp3, wp3 = LK_PADDED[0]
    prev, nxt = lk_timing.textured_pair(hp3, wp3, lk_timing.SHIFT, seed=200)
    pts, guess, active = lk_timing.lk_level_inputs(hp3, wp3, seed=300)
    four = lambda *ts: [t.expand((4,) + tuple(t.shape)).contiguous() for t in ts]
    kw = dict(win=WIN, iters=30, eps=0.01, search_radius=6, pad=PAD)
    cases = {
        "extract_windows_int": (four(img, cor), patch.extract_windows_int_batched,
                                lambda a, b: patch.extract_windows_int(a, b, S), (S,)),
        "extract_patches": (four(img2, xy), patch.extract_patches_batched,
                            lambda a, b: patch.extract_patches(a, b, P), (P,)),
        "level_track_cell": (four(prev, nxt, pts, guess, active),
                             lambda *a: lk_cell.level_track_cell_batched(
                                 *a[:4], active=a[4], **kw),
                             lambda *a: lk_cell.level_track_cell(*a[:4], active=a[4], **kw), ()),
        "level_track_v1": (four(prev, nxt, pts, guess, active),
                           lambda *a: lk_v1.level_track_v1_batched(*a[:4], active=a[4], **kw),
                           lambda *a: lk_v1.level_track_v1(*a[:4], active=a[4], **kw), ()),
    }
    for name, (args, fb, f1, extra) in cases.items():
        batched_call = lambda fb=fb, args=args, extra=extra: fb(*args, *extra)
        singles = lambda f1=f1, args=args: [f1(*(a[b] for a in args)) for b in range(4)]
        runs = [timing.graph_ms(f) for f in (singles, batched_call, batched_call, singles)]
        ms, by = bounds[name]
        out[name].update(graph_ms_b4=min(runs[1], runs[2]), graph_ms_4x1=min(runs[0], runs[3]),
                         bound_ms_b4=4 * ms, bound_by=by)
    return out


def slice4_phase(mods, cam, il, ir, poses_gt, bounds) -> tuple[dict, dict]:
    """Phase 18: S sequences in one batched step graph through
    ``evaluate_batch`` (a: LK dense at S = 4 and S = 1 on the 49 bench
    frames; b: cell, v1 and ORB at S = 2 on 16), the batched entries (c)
    and the distributed solve on NCCL at world size 1 (d). Returns (each
    path's launches, the batched entries' numbers)."""
    np, torch, kernels = mods["np"], mods["torch"], mods["kernels"]
    VOConfig, trajectory, batched = mods["VOConfig"], mods["trajectory"], mods["batched"]
    sequences = mods["sequences"]
    zero = dict.fromkeys(kernels, 0)
    launches, lines = {}, []

    def drive(tag, vo, frames, S, want, max_ate):
        r = batched.run_batched(vo, cam, il[:frames], ir[:frames], S, kernels=kernels)
        launches[tag] = r["launches"]
        ates = [trajectory.ate_rmse(t, poses_gt[:frames]) for t in r["trajectories"]]
        check(all(len(t) == frames and np.isfinite(t).all() for t in r["trajectories"]),
              f"{tag}: trajectories {[t.shape for t in r['trajectories']]}")
        check(max(ates) < max_ate and min(r["accept_rate"]) >= 0.95,
              f"{tag}: ATE {ates} (bound {max_ate} m), accept {r['accept_rate']} (>= 0.95)")
        check(r["launches"] == want, f"{tag}: launches {r['launches']}, want {want}")
        prof = batched.profile_replay(r["graph"].launch)
        ms = r["ms_batched_frame"]
        line = (f"{tag} S={S} evaluate_batch on cuda, {frames} frames {H}x{W}: ATE "
                + "/".join(f"{a:.4f}" for a in ates) + " m, accept "
                + "/".join(f"{a:.3f}" for a in r["accept_rate"])
                + f", aggregate {r['frames_per_s']:.1f} frames/s, {ms:.2f} ms per batched "
                f"frame, one profiled replay: {prof['nodes']} nodes, busy "
                f"{prof['busy_ms']:.3f} ms, idle {1 - prof['busy_ms'] / ms:.3f}; launches "
                f"per replay {r['graph'].per_replay}, in the run "
                f"{ {k: v for k, v in r['launches'].items() if v} } (want "
                f"{ {k: v for k, v in want.items() if v} }), peak {r['peak_gb']:.2f} GB")
        out = dict(nodes=prof["nodes"], busy_ms=prof["busy_ms"], ms=ms,
                   fps=r["frames_per_s"], ates=ates, per_replay=r["graph"].per_replay)
        del r
        sequences.clear()
        torch.cuda.empty_cache()
        lines.append(line)
        return out

    lk_vo = VOConfig(height=H, width=W, max_features=N_POINTS)
    k1_lk = dict(zero, extract_windows_int=1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1))
    s4 = drive("LK-batched-S4", lk_vo, N_FRAMES, 4, k1_lk, 0.05)
    s1 = drive("LK-batched-S1", lk_vo, N_FRAMES, 1, k1_lk, 0.05)
    check(s4["per_replay"] == s1["per_replay"],
          f"K1 per replay at S = 4 {s4['per_replay']} against S = 1 {s1['per_replay']}")
    nodes = (f"nodes per replay S=4 {s4['nodes']} / S=1 {s1['nodes']} "
             f"({s4['nodes'] / max(s1['nodes'], 1):.3f}x); aggregate frames/s "
             f"{s4['fps']:.1f} / {s1['fps']:.1f} ({s4['fps'] / s1['fps']:.2f}x)")
    for name in ("cell", "v1"):
        counter = f"level_track_{name}"
        drive(f"LK-{name}-batched-S2", VOConfig(lk_kernel=name, height=H, width=W,
                                                 max_features=N_POINTS), BRANCH_FRAMES, 2,
              dict(zero, extract_windows_int=BRANCH_FRAMES,
                   **{counter: LK_LEVELS_PER_STEP * (BRANCH_FRAMES - 1)}), 0.05)
    drive("ORB-batched-S2", VOConfig(mode="orb", height=H, width=W, max_features=ORB_FEATURES),
          BRANCH_FRAMES, 2, dict(zero, extract_windows_int=ORB_LAUNCHES_PER_FRAME * BRANCH_FRAMES,
                                 extract_patches=ORB_LAUNCHES_PER_FRAME * BRANCH_FRAMES), 0.07)
    say("[18/22] slice 4, S sequences in one batched step graph (the same frames per "
          "sequence, draws of their own): " + "; ".join(lines) + "; " + nodes)

    entries = batched_entries(mods, bounds)
    say("[18/22] the batched entries (B = 3 sequences, other images per sequence) against "
          "their plain versions (K1, K2 exact; K3, K4 phase 5's criteria) and against B = 1 "
          "calls (bit for bit), one launch each; at B = 4 in a graph against 4 x B = 1: "
          + "; ".join(f"{k} ({v['entry']}) max err {v['max_abs_err']:.2e}, B=4 "
                      f"{1e3 * v['graph_ms_b4']:.2f} us against 4xB=1 "
                      f"{1e3 * v['graph_ms_4x1']:.2f} us, bound {1e3 * v['bound_ms_b4']:.3f} us"
                      for k, v in entries.items()))
    say("[18/22] " + dist_solve(mods))
    return launches, dict(entries, s4=s4, s1=s1)


def dist_solve(mods) -> str:
    """Phase 18d: ``dist_ba.make_distributed_ba`` on NCCL at world size 1
    (a ``HashStore``) against ``ba.bundle_adjust`` on the card, on the
    multi-process demo's problem, with and without pruning: poses within
    5e-3, landmarks within 3e-3 (absolute and relative), costs within 1e-4
    relative, the same observations pruned (the tolerances of
    ``test_bundle_adjust_on_cuda_matches_cpu``)."""
    np, torch, ba = mods["np"], mods["torch"], mods["ba"]
    dist_ba, multihost, demo = mods["dist_ba"], mods["multihost"], mods["multihost_demo"]
    from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole
    multihost.initialize(world_size=1, rank=0, backend="nccl")
    cam_p, poses_gt, _, table, poses_init, points_init = demo.problem(1)
    t = lambda a: torch.as_tensor(np.asarray(a), device="cuda")
    cam = Pinhole.create(*cam_p, device="cuda")
    obs = [t(a) for a in table]
    parts = []
    for prune in (None, 8.0):
        solve = dist_ba.make_distributed_ba(cam, None, n_kf=len(poses_init),
                                            n_lm=len(points_init), n_iters=10, prune_px=prune,
                                            device="cuda")
        got = solve(t(poses_init), t(points_init), *obs)
        want = ba.bundle_adjust(cam, t(poses_init), t(points_init), *obs, n_iters=10,
                                n_fixed=1, prune_px=prune)
        dp = float((got["poses"] - want["poses"]).abs().max())
        dx = float(((got["points"] - want["points"]).abs()
                    / (3e-3 + 3e-3 * want["points"].abs())).max())
        dc = max(abs(float(got[k]) / float(want[k]) - 1) for k in ("cost_initial", "cost_final"))
        same = bool(torch.equal(got["obs_w"] > 0, want["obs_w"] > 0))
        check(dp <= 5e-3 and dx <= 1.0 and dc <= 1e-4 and same,
              f"distributed solve (prune {prune}) off bundle_adjust: poses {dp}, landmarks "
              f"{dx} of the bound, costs {dc}, same pruned {same}")
        err = float((got["poses"].cpu().numpy() - poses_gt).__abs__().max())
        parts.append(f"prune {prune}: poses {dp:.2e} apart, landmarks {dx:.3f} of the bound, "
                     f"costs {dc:.2e} relative, cost {float(got['cost_initial']):.1f} -> "
                     f"{float(got['cost_final']):.3f}, max pose error {err:.4f}")
    torch.distributed.destroy_process_group()
    return ("distributed BA on NCCL at world size 1 (HashStore) against bundle_adjust on "
            "cuda, the multi-process demo's problem (6 keyframes, 120 landmarks): "
            + "; ".join(parts))


@contextlib.contextmanager
def evaluator_draws(evaluate, record=None, feed=None):
    """Inside: ``evaluate``'s RANSAC draws, one (S, num_hypotheses, 6) per
    frame, taken from the iterator ``feed``, or drawn as usual (and
    appended to ``record`` if given)."""
    real = evaluate.pnp

    def draw(*args, **kw):
        if feed is not None:
            return next(feed)
        u = real.draw_uniforms(*args, **kw)
        if record is not None:
            record.append(u.clone())
        return u

    evaluate.pnp = types.SimpleNamespace(draw_uniforms=draw)
    try:
        yield
    finally:
        evaluate.pnp = real


def mesh_phase(mods, cam, il, ir, poses_gt) -> dict:
    """Phase 21: a sequence batch over a ``seq`` mesh of two shards (a, b)
    and ``probes/scaling.py``'s measurement (c). Returns each path's
    launches."""
    np, torch, kernels, trajectory = mods["np"], mods["torch"], mods["kernels"], mods["trajectory"]
    VOConfig, batched, sequences = mods["VOConfig"], mods["batched"], mods["sequences"]
    evaluate, scaling = mods["evaluate"], mods["scaling"]
    from stereo_visual_odometry_tpu_torch.parallel.mesh import Mesh
    from stereo_visual_odometry_tpu_torch.utils.config import rig_from_config
    cards = torch.cuda.device_count()
    devs = tuple(torch.device("cuda", i if cards >= 2 else 0) for i in range(2))
    mesh = Mesh(devs, "seq")
    where = (f"two cards, {devs[0]} and {devs[1]}" if cards >= 2 else
             f"one card, {devs[0]} twice")
    rig = rig_from_config(cam, device=devs[0])
    zero = dict.fromkeys(kernels, 0)
    copies = lambda a, S: np.broadcast_to(a[None], (S,) + a.shape)
    launches = {}

    def run(vo, frames, S, on=None, record=None, feed=None):
        """``evaluate_batch`` of S copies of the first ``frames`` bench
        frames over ``on`` (a mesh, or cuda:0), its graphs captured first by
        a 2-frame evaluation, the counts set to 0 just before and read just
        after; returns (result, launches, one graph per shard)."""
        sequences.clear()
        torch.cuda.empty_cache()
        evaluate.evaluate_batch(copies(il[:2], S), copies(ir[:2], S), np.full(S, 2), vo, rig,
                                mesh=on)
        reset_launches(kernels)
        with evaluator_draws(evaluate, record, feed):
            out = evaluate.evaluate_batch(copies(il[:frames], S), copies(ir[:frames], S),
                                          np.full(S, frames), vo, rig, mesh=on)
        counted = {k: fn.launches for k, fn in kernels.items()}
        step = sequences.batched_frontend(vo, rig, S, mesh=on)[1]
        steps = getattr(step, "shards", (step,))
        return out, counted, [st.graph(S // len(steps)) for st in steps]

    def check_run(tag, out, frames, max_ate):
        ates = [trajectory.ate_rmse(t, poses_gt[:frames]) for t in out["trajectories"]]
        check(all(len(t) == frames and np.isfinite(t).all() for t in out["trajectories"]),
              f"{tag}: trajectories {[t.shape for t in out['trajectories']]}")
        check(max(ates) < max_ate and min(out["accept_rate"]) >= 0.95,
              f"{tag}: ATE {ates} (bound {max_ate} m), accept {out['accept_rate']} (>= 0.95)")
        return ates

    # (a) LK dense, S = 4 over the two shards.
    lk_vo = VOConfig(height=H, width=W, max_features=N_POINTS)
    S, per_shard = 4, 1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1)
    drawn = []
    got, counted, graphs = run(lk_vo, N_FRAMES, S, mesh, record=drawn)
    draws = torch.stack(drawn)  # (T - 1, S, num_hypotheses, 6) on the first shard's card
    ates = check_run("mesh LK S=4", got, N_FRAMES, 0.05)
    launches["mesh-LK-S4"] = counted
    check(len(graphs) == 2 and graphs[0] is not graphs[1]
          and [g.device for g in graphs] == list(devs)
          and all(g.per_replay == {"extract_windows_int": LK_LAUNCHES_PER_STEP} for g in graphs),
          f"mesh LK: graphs per shard {[(str(g.device), g.per_replay) for g in graphs]}")
    check(counted == dict(zero, extract_windows_int=2 * per_shard),
          f"mesh LK launches {counted}, want {per_shard} K1 per shard")
    profiles = [batched.profile_replay(g.launch, device=g.device) for g in graphs]
    nodes = [g.count_nodes() for g in graphs]
    ms = 1e3 * got["wall_s"] / (N_FRAMES - 1)
    busy = {}
    for dev, prof in zip(devs, profiles):
        busy[str(dev)] = busy.get(str(dev), 0.0) + prof["busy_ms"]
    idle = {d: 1 - b / ms for d, b in busy.items()}
    same = []
    for i, rows in enumerate((slice(0, 2), slice(2, 4))):
        want, n_want, g1 = run(lk_vo, N_FRAMES, 2, feed=iter(draws[:, rows].to(devs[0])))
        equal = all(np.array_equal(a, b) for a, b in
                    zip(got["trajectories"][rows], want["trajectories"], strict=True))
        check(equal and got["accept_rate"][rows] == want["accept_rate"],
              f"mesh LK shard {i}: not bit for bit the single-device S = 2 run (accept "
              f"{got['accept_rate'][rows]} against {want['accept_rate']})")
        check(n_want == dict(zero, extract_windows_int=per_shard),
              f"single-device S = 2 launches {n_want}, want {per_shard} K1")
        nodes1 = g1[0].count_nodes()
        check(nodes[i] == nodes1 > 0, f"mesh LK shard {i}: {nodes[i]} graph nodes, a "
              f"single-device S = 2 graph {nodes1}")
        same.append(nodes1)
    whole, _, _ = run(lk_vo, N_FRAMES, S, feed=iter(draws))
    diff = max(float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
               for a, b in zip(got["trajectories"], whole["trajectories"], strict=True))
    check(diff < 0.05, f"mesh LK against the unsplit S = 4 run: poses {diff} m apart "
          "(bound 0.05 m)")
    line_a = (f"(a) LK dense S={S} over {where}, evaluate_batch on {N_FRAMES} frames {H}x{W}: "
              f"ATE " + "/".join(f"{a:.4f}" for a in ates) + " m, accept "
              + "/".join(f"{a:.3f}" for a in got["accept_rate"])
              + f", aggregate {got['frames_per_s']:.1f} frames/s, {ms:.2f} ms per batched "
              f"frame; one graph per shard, {LK_LAUNCHES_PER_STEP} K1 per replay, K1 "
              f"{counted['extract_windows_int']} in the run ({per_shard} per shard); graph nodes "
              f"{nodes} (single-device S=2: {same}; profiled "
              f"{[p['nodes'] for p in profiles]}); busy ms "
              f"per replay {[round(p['busy_ms'], 3) for p in profiles]}, idle per card "
              + ", ".join(f"{d} {v:.3f}" for d, v in idle.items())
              + "; each shard bit for bit a single-device S=2 run with its draws; the unsplit "
              f"S=4 run {diff:.3e} m apart (aggregate {whole['frames_per_s']:.1f} frames/s)")
    del got, whole, graphs

    # (b) cell, v1 and ORB at S = 2 over the two shards, 16 frames.
    parts = []
    for name, vo, want1, max_ate in (
            ("cell", VOConfig(lk_kernel="cell", height=H, width=W, max_features=N_POINTS),
             dict(zero, extract_windows_int=BRANCH_FRAMES,
                  level_track_cell=LK_LEVELS_PER_STEP * (BRANCH_FRAMES - 1)), 0.05),
            ("v1", VOConfig(lk_kernel="v1", height=H, width=W, max_features=N_POINTS),
             dict(zero, extract_windows_int=BRANCH_FRAMES,
                  level_track_v1=LK_LEVELS_PER_STEP * (BRANCH_FRAMES - 1)), 0.05),
            ("ORB", VOConfig(mode="orb", height=H, width=W, max_features=ORB_FEATURES),
             dict(zero, extract_windows_int=ORB_LAUNCHES_PER_FRAME * BRANCH_FRAMES,
                  extract_patches=ORB_LAUNCHES_PER_FRAME * BRANCH_FRAMES), 0.07)):
        out, n, _ = run(vo, BRANCH_FRAMES, 2, mesh)
        a = check_run(f"mesh {name} S=2", out, BRANCH_FRAMES, max_ate)
        want = {k: 2 * v for k, v in want1.items()}
        check(n == want, f"mesh {name} launches {n}, want {want} (per shard as at S = 1)")
        launches[f"mesh-{name}-S2"] = n
        parts.append(f"{name} ATE " + "/".join(f"{x:.4f}" for x in a) + " m, accept "
                     + "/".join(f"{x:.3f}" for x in out["accept_rate"])
                     + f", {out['frames_per_s']:.1f} frames/s, launches "
                     f"{ {k: v for k, v in n.items() if v} }")
    sequences.clear()
    torch.cuda.empty_cache()
    say("[21/22] the seq mesh: " + line_a + f"; (b) S=2 over {where}, {BRANCH_FRAMES} frames: "
        + "; ".join(parts))

    # (c) probes/scaling.py's measurement.
    ns = ["1", "2"] if cards >= 2 else ["1"]
    result = scaling.measure(scaling.parse(["--devices", *ns, "--reps", "2"]))
    schema = json.loads((ROOT / "SCALING.json").read_text())
    check(set(schema) <= set(result) and all(
        [r["devices"] for r in result[axis]] == [int(n) for n in ns]
        and all(set(schema[axis][0]) <= set(r) for r in result[axis])
        for axis in ("seq_sharding", "dist_ba")),
        f"probes/scaling.py's result lacks SCALING.json's keys: {sorted(result)}")
    check(all(r["cost_final"] < r["cost_initial"] and r["backend"] == "nccl"
              for r in result["dist_ba"]), f"scaling BA rows {result['dist_ba']}")
    say(f"[21/22] (c) probes/scaling.py --devices {' '.join(ns)} --reps 2 on cuda: the line "
        "follows")
    print(json.dumps(result), flush=True)
    return launches


SLICE5_RAW = (376, 1241)  # the bench frames' native size, as KITTI's
SLICE5_HW = (384, 1248)   # utils/kitti.static_shape_for(376, 1241): multiples of 32
# The BA bound of (b): 1.5 x the JAX package's aligned ATE on these frames on
# the CPU (``tests/torch_ba_reference.py cli_ba jax``), as phase 17's ORB.
CLI_BA_JAX_ATE = 0.14498387788178257  # 11 solves; frontend-only 0.0243
CKPT_FRAMES, CKPT_SAVE = 14, 9  # the fourth keyframe (frame 7) slides the window
ONLINE_FRAMES, BURST = 16, 8


def write_png(path, img) -> None:
    """An 8-bit grey PNG, written with zlib alone (the card's machine may
    lack PIL)."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    h, w = img.shape
    rows = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter 0 per row
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def write_kitti_dir(trajectory, root, imgs_l, imgs_r, poses_gt) -> None:
    """``root/image_0``, ``root/image_1`` (8-bit PNGs) and ``root/poses.txt``."""
    for sub, imgs in (("image_0", imgs_l), ("image_1", imgs_r)):
        (root / sub).mkdir(parents=True)
        for i, img in enumerate(imgs):
            write_png(root / sub / f"{i:06d}.png", img)
    trajectory.save_kitti(str(root / "poses.txt"), poses_gt)


def bench_yaml(path, mode="lk", features=N_POINTS) -> str:
    """A reference-format config: the bench camera and ``VOConfig``'s
    defaults (the reader's own default draws 512 hypotheses)."""
    track = "LK_stereof2f_pnp" if mode == "lk" else "ORB_stereof2f_pnp"
    Path(path).write_text(
        "%YAML:1.0\ncamera1.fx: 718.856\ncamera1.fy: 718.856\n"
        f"camera1.cx: {SLICE5_RAW[1] / 2}\ncamera1.cy: {SLICE5_RAW[0] / 2}\n"
        f"t_lr0: -0.537\ntrack_mode: {track}\nnFeatures: {features}\n"
        "iterationsCount: 256\n")
    return str(path)


def machine_has(loader) -> tuple[str, dict]:
    """What the machine offers the dataset: PIL, matplotlib, libpng's header
    for g++, and the native loader's build."""
    import importlib.util
    has = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib")}
    try:
        png_h = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <png.h>\n",
                               capture_output=True, text=True, timeout=60).returncode == 0
    except FileNotFoundError:
        png_h = "no g++"
    try:
        loader.get_lib()
        built = f"built ({loader.library_path().name})"
    except (RuntimeError, OSError) as e:
        built = "not built: ..." + " ".join(str(e).split())[-160:]
    return (f"PIL {has['PIL']}, matplotlib {has['matplotlib']}, png.h {png_h}, the native "
            f"loader {built}"), has


def record_patch_calls(torch, patch, run) -> dict:
    """The arguments of every K1 and K2 wrapper call ``run()`` makes, cloned
    (the step reaches the wrappers through the ``patch`` module)."""
    calls = {"extract_windows_int": [], "extract_patches": []}
    orig = {name: getattr(patch, name) for name in calls}

    def recorder(name):
        def call(*args):
            calls[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return orig[name](*args)
        call.launches = 0  # the wrapper counts on the module's name, here this one
        return call
    for name in calls:
        setattr(patch, name, recorder(name))
    try:
        run()
    finally:
        for name, fn in orig.items():
            setattr(patch, name, fn)
    return calls


def check_patch_calls(torch, patch, calls) -> tuple[float, float, list, list]:
    """K1 and K2 against their plain versions on recorded calls: (K1's max
    abs err, K2's, K1's (Hp, Wp, S, N), K2's (h, w, P, N))."""
    k1_err = k2_err = 0.0
    k1_shapes, k2_shapes = set(), set()
    for img, corners, S in calls["extract_windows_int"]:
        got = patch.extract_windows_int(img, corners, S)
        want = patch.extract_windows_int_reference(img, corners, S)
        if len(corners):
            k1_err = max(k1_err, float((got - want).abs().max()))
        k1_shapes.add((*img.shape, S if isinstance(S, int) else tuple(S), len(corners)))
    for img, xy, P in calls["extract_patches"]:
        got = patch.extract_patches(img, xy, P)
        p_pad = P // 2 + 2
        want = patch.extract_patches_reference(patch.pad_edge(img, p_pad, p_pad, p_pad, p_pad),
                                               xy, P, p_pad)
        plain = patch.extract_patches_clamped(img, xy, P)
        if len(xy):
            k2_err = max(k2_err, float((got - want).abs().max()),
                         float((got - plain).abs().max()))
        k2_shapes.add((*img.shape, P, len(xy)))
    torch.cuda.synchronize()
    return k1_err, k2_err, sorted(k1_shapes), sorted(k2_shapes)


def drain(vo, n=None, timeout=120.0) -> list:
    """Poll an online feed until ``n`` results came (or, without ``n``,
    until none comes for a second)."""
    out, deadline = [], time.perf_counter() + timeout
    while (n is None or len(out) < n) and time.perf_counter() < deadline:
        r = vo.poll(timeout=1.0)
        if r is None and n is None:
            break
        if r is not None:
            out.append(r)
    return out


def slice5_phase(mods, cam, il, ir, poses_gt) -> tuple[dict, dict]:
    """Phase 19: the command line, checkpoint/resume and the online feed on
    phase 6's frames written as a KITTI directory. Returns (each path's
    launches, K1's and K2's errors against their plain versions on the
    calls of one step at the command line's shape)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile
    np, torch, kernels = mods["np"], mods["torch"], mods["kernels"]
    system_mod, trajectory, patch = mods["system_mod"], mods["trajectory"], mods["patch"]
    VOConfig, RunConfig, BackendConfig = mods["VOConfig"], mods["RunConfig"], mods["BackendConfig"]
    from stereo_visual_odometry_tpu_torch import cli
    from stereo_visual_odometry_tpu_torch.models.online import OnlineVO
    from stereo_visual_odometry_tpu_torch.native import loader
    from stereo_visual_odometry_tpu_torch.parallel import sequences
    from stereo_visual_odometry_tpu_torch.utils import checkpoint, kitti
    System = system_mod.System
    zero = dict.fromkeys(kernels, 0)
    k1_lk = dict(zero, extract_windows_int=1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1))
    launches = {}
    h, w = SLICE5_RAW
    raw_l, raw_r = il[:, :h, :w].astype(np.uint8), ir[:, :h, :w].astype(np.uint8)
    pad = lambda a: kitti.pad_to(a, *SLICE5_HW)
    lk_cfg = RunConfig(camera=cam, vo=VOConfig(height=SLICE5_HW[0], width=SLICE5_HW[1],
                                               max_features=N_POINTS))
    ate = lambda traj: trajectory.ate_rmse(traj, poses_gt[:len(traj)])
    tmp = Path(tempfile.mkdtemp(prefix="svo_slice5_"))
    try:
        seq, seq2 = tmp / "seq00", tmp / "seq01"
        write_kitti_dir(trajectory, seq, raw_l, raw_r, poses_gt)
        shutil.copytree(seq, seq2)
        gt = str(seq / "poses.txt")
        lk_yaml = bench_yaml(tmp / "lk.yaml")
        orb_yaml = bench_yaml(tmp / "orb.yaml", "orb", ORB_FEATURES)
        has_line, has = machine_has(loader)
        ds = kitti.KittiStereoDataset(str(seq), static_hw=SLICE5_HW)
        t0 = time.perf_counter()
        frames = [ds[i] for i in range(len(ds))]
        decode_ms = 1e3 * (time.perf_counter() - t0) / len(ds)
        check(len(frames) == N_FRAMES and all(
            np.array_equal(l, pad(a)) and np.array_equal(r, pad(b))
            for (l, r), a, b in zip(frames, raw_l, raw_r)),
              f"the {ds.decoder} decoder's frames differ from the written bytes")
        say(f"[19/22] slice 5 on a KITTI directory of {N_FRAMES} frames {h}x{w} (8-bit PNGs "
            f"by zlib): {has_line}; the dataset decodes with {ds.decoder!r}, "
            f"{decode_ms:.2f} ms per pair (padded to {SLICE5_HW}), frames equal to the "
            "written bytes")

        # K1 and K2 on the calls one eager step makes at the CLI's shape.
        errs, parts = {}, []
        orb_cfg = RunConfig(camera=cam, vo=VOConfig(mode="orb", height=SLICE5_HW[0],
                                                    width=SLICE5_HW[1],
                                                    max_features=ORB_FEATURES))
        for tag, cfg in (("LK", lk_cfg), ("ORB", orb_cfg)):
            calls = record_patch_calls(torch, patch, lambda cfg=cfg: System(
                cfg, device="cuda", graph=False).run(frames[:2]))
            k1e, k2e, k1s, k2s = check_patch_calls(torch, patch, calls)
            errs[tag] = (k1e, k2e)
            check(k1e == 0.0 and k2e == 0.0,
                  f"{tag} at {SLICE5_HW}: K1 max abs err {k1e}, K2 {k2e} (tolerance 0)")
            parts.append(f"{tag}: {len(calls['extract_windows_int'])} K1 calls on (Hp, Wp, S, "
                         f"N) {k1s}, {len(calls['extract_patches'])} K2 calls on (h, w, P, "
                         f"N) {k2s}")
        k1_err = max(e[0] for e in errs.values())
        say(f"[19/22] K1 and K2 vs plain on the calls of one eager tracked step at "
            f"{SLICE5_HW}: " + "; ".join(parts) + f": max abs err K1 {k1_err}, K2 "
            f"{errs['ORB'][1]} (tolerance 0)")

        def run_cli(tag, args):
            """``cli.main(args)`` in process, its stdout kept, the launch counts
            set to 0 just before and read just after; returns (each System
            it ran with its trajectory, the printed lines, wall s)."""
            made = []
            orig = {n: getattr(System, n) for n in ("run", "run_chunked")}

            def spy(name):
                def call(self, *a, **kw):
                    traj = orig[name](self, *a, **kw)
                    made.append((self, traj))
                    return traj
                return call
            for name in orig:
                setattr(System, name, spy(name))
            out = io.StringIO()
            reset_launches(kernels)
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    rc = cli.main(args)
            finally:
                for name, fn in orig.items():
                    setattr(System, name, fn)
            wall = time.perf_counter() - t0
            launches[tag] = {name: fn.launches for name, fn in kernels.items()}
            printed = out.getvalue().strip().splitlines()
            check(rc == 0, f"{tag}: cli.main returned {rc}")
            return made, printed, wall

        def counted(tag):
            return {k: v for k, v in launches[tag].items() if v}

        def plain_cfg(sys_):  # the CLI's config, writing nothing
            return dataclasses.replace(sys_.config, trajectory_out="", overlay_dir="")

        # (a) the CLI, LK ------------------------------------------------------
        out_file, plot = tmp / "traj.txt", tmp / "traj.png"
        made, printed, wall = run_cli("cli_lk", [lk_yaml, "--dataset", str(seq), "--out",
                                                 str(out_file), "--gt", gt, "--plot", str(plot)])
        (sys_a, traj_a), = made
        hw = (sys_a.vo_cfg.height, sys_a.vo_cfg.width)
        check(hw == SLICE5_HW, f"the CLI sized the step {hw}, want {SLICE5_HW}")
        check(sys_a.device.type == "cuda" and sys_a.graph is not None,
              "the CLI's System runs off the card's step graph")
        a_ate, a_acc = ate(traj_a), sys_a.summary()["accept_rate"]
        check(a_ate < 0.05 and a_acc >= 0.95, f"CLI LK: ATE {a_ate} m (< 0.05), accept {a_acc}")
        check(launches["cli_lk"] == k1_lk, f"CLI LK launches {counted('cli_lk')}, want "
              f"{k1_lk['extract_windows_int']} K1")
        written = trajectory.load_kitti(str(out_file))
        check(len(written) == N_FRAMES and plot.stat().st_size > 0,
              f"CLI wrote {len(written)} poses, plot {plot.stat().st_size} B")
        ref_a = System(plain_cfg(sys_a), device="cuda").run(frames)
        same_a = bool(np.array_equal(traj_a, ref_a))
        check(same_a, "CLI LK differs from System.run on the decoded frames: "
              f"{np.abs(traj_a - ref_a).max()}")
        steady = 1e3 * float(np.median([m["time_s"] for m in sys_a.metrics[2:]]))
        lines = [f"(a) cli.main LK, {wall:.2f} s (the graph's warm-up and capture "
                 f"{sys_a.graph.capture_s:.2f} s, then {steady:.2f} ms per frame, median, "
                 f"decode overlapped): {' | '.join(printed)}; static shape {hw}, "
                 f"ATE {a_ate:.4f} m, accept {a_acc:.3f}, launches {counted('cli_lk')}, "
                 f"{len(written)} poses written, plot {plot.stat().st_size} B, equal to "
                 f"System.run bit for bit: {same_a}"]

        # (b) the other modes ---------------------------------------------------
        made, printed, wall = run_cli("cli_chunked", [lk_yaml, "--dataset", str(seq),
                                                      "--chunked", "16", "--gt", gt])
        (sys_c, traj_c), = made
        ref_c = System(plain_cfg(sys_c), device="cuda").run_chunked(frames, chunk=16)
        same_c = bool(np.array_equal(traj_c, ref_c))
        check(same_c and launches["cli_chunked"] == k1_lk,
              f"--chunked 16: equal to run_chunked {same_c}, launches {counted('cli_chunked')}")
        lines.append(f"--chunked 16, {wall:.2f} s: {' | '.join(printed)}; equal to "
                     f"System.run_chunked(chunk=16) bit for bit: {same_c}, launches "
                     f"{counted('cli_chunked')}")

        made, printed, wall = run_cli("cli_orb", [orb_yaml, "--dataset", str(seq), "--mode",
                                                  "orb", "--gt", gt])
        (sys_o, traj_o), = made
        o_ate, o_acc = ate(traj_o), sys_o.summary()["accept_rate"]
        want = dict(zero, extract_windows_int=ORB_LAUNCHES_PER_FRAME * N_FRAMES,
                    extract_patches=ORB_LAUNCHES_PER_FRAME * N_FRAMES)
        check(sys_o.vo_cfg.mode == "orb" and sys_o.vo_cfg.max_features == ORB_FEATURES,
              f"--mode orb ran {sys_o.vo_cfg.mode} at {sys_o.vo_cfg.max_features}")
        check(o_ate < 0.07 and o_acc >= 0.95 and launches["cli_orb"] == want,
              f"--mode orb: ATE {o_ate} m (< 0.07), accept {o_acc}, launches "
              f"{counted('cli_orb')}")
        lines.append(f"--mode orb ({ORB_FEATURES} features), {wall:.2f} s: "
                     f"{' | '.join(printed)}; ATE {o_ate:.4f} m, accept {o_acc:.3f}, launches "
                     f"{counted('cli_orb')}")

        btraj = tmp / "btraj"
        made, printed, wall = run_cli("cli_batch", [lk_yaml, "--batch", str(seq), str(seq2),
                                                    "--batch-gt", gt, gt, "--out", str(btraj)])
        b_ates = [ate(trajectory.load_kitti(f"{btraj}.{s:02d}")) for s in range(2)]
        check(sum("ATE=" in ln for ln in printed) == 2 and max(b_ates) < 0.05
              and launches["cli_batch"] == k1_lk,
              f"--batch: ATE {b_ates} m (< 0.05), launches {counted('cli_batch')}")
        sequences.clear()
        lines.append(f"--batch (2 directories, S = 2), {wall:.2f} s: {' | '.join(printed)}; "
                     f"ATE from the written trajectories {b_ates[0]:.4f} / {b_ates[1]:.4f} m, "
                     f"launches {counted('cli_batch')} (1 + 27 x 48 for the batch)")

        made, printed, wall = run_cli("cli_ba", [lk_yaml, "--dataset", str(seq), "--ba",
                                                 "--window", "6", "--kf-every", "4",
                                                 "--gt", gt])
        (sys_b, traj_b), = made
        solves = sum("ba" in m for m in sys_b.metrics)
        ba_bound = 1.5 * CLI_BA_JAX_ATE
        b_ate = ate(traj_b)
        check(solves >= 2 and b_ate < ba_bound and launches["cli_ba"] == k1_lk,
              f"--ba: {solves} solves (>= 2), ATE {b_ate} m (< {ba_bound:.4f}), launches "
              f"{counted('cli_ba')}")
        lines.append(f"--ba --window 6 --kf-every 4, {wall:.2f} s: {' | '.join(printed)}; "
                     f"{solves} solves, ATE {b_ate:.4f} m aligned (bound {ba_bound:.4f}: 1.5 x "
                     f"the JAX package's {CLI_BA_JAX_ATE}), not aligned "
                     f"{trajectory.ate_rmse(traj_b, poses_gt, align=False):.4f} m, launches "
                     f"{counted('cli_ba')}")

        ovl = tmp / "overlays"
        made, printed, wall = run_cli("cli_overlays", [lk_yaml, "--dataset", str(seq),
                                                       "--dump-overlays", str(ovl),
                                                       "--every", "10"])
        (sys_v, traj_v), = made
        same_v = bool(np.array_equal(traj_v, traj_a))
        shapes = {k: (v.shape, v.dtype.name) for k, v in sys_v.metrics[10].items()
                  if k.startswith("tracked_")}
        want_shapes = {"tracked_prev": ((N_POINTS, 2), "float32"),
                       "tracked_cur": ((N_POINTS, 2), "float32"),
                       "tracked_valid": ((N_POINTS,), "bool")}
        pngs = sorted(p.name for p in ovl.glob("*.png"))
        want_pngs = [f"tracks_{i:06d}.png" for i in range(10, N_FRAMES, 10)]
        check(same_v and shapes == want_shapes and launches["cli_overlays"] == k1_lk,
              f"--dump-overlays: equal to (a) {same_v}, arrays {shapes}, launches "
              f"{counted('cli_overlays')}")
        check(pngs == (want_pngs if has["matplotlib"] else []),
              f"--dump-overlays wrote {pngs} (matplotlib {has['matplotlib']})")
        lines.append(f"--dump-overlays --every 10, {wall:.2f} s: trajectory equal to (a)'s "
                     f"bit for bit: {same_v}; overlay arrays on the host {shapes}; PNGs "
                     + (f"{len(pngs)}" if has["matplotlib"] else
                        "absent (no matplotlib: draw_tracks writes nothing, as in JAX)"))
        say("[19/22] the command line on cuda (python -m stereo_visual_odometry_tpu_torch.cli, "
            "in process; counts set to 0 before each call): " + "; ".join(lines))
        del sys_a, sys_c, sys_o, sys_b, sys_v, made
        torch.cuda.empty_cache()

        # (c) the real entry point ----------------------------------------------
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "stereo_visual_odometry_tpu_torch.cli",
                               lk_yaml, "--dataset", str(seq), "--max-frames", "8", "--gt", gt],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0 and "ATE=" in proc.stdout,
              f"python -m ...cli exited {proc.returncode}: {proc.stderr[-2000:]}")
        c_line = (f"(c) python -m stereo_visual_odometry_tpu_torch.cli --max-frames 8: exit 0 in "
                  f"{sub_s:.1f} s: {' | '.join(proc.stdout.strip().splitlines())}")

        # (d) checkpoint / resume after the first window slide -----------------
        vo_p = dataclasses.replace(lk_cfg.vo, persistent_tracks=True)
        ckpt, d_parts = tmp / "state.npz", []
        for variant, bcfg in (("frontend-only", None),
                              ("BA", BackendConfig(window=3, kf_every=2))):
            make = lambda: System(RunConfig(camera=cam, vo=vo_p), device="cuda",
                                  backend_cfg=bcfg)
            straight = make()
            for i, (l, r) in enumerate(frames[:CKPT_FRAMES]):
                straight.step(l, r)
                if i + 1 == CKPT_SAVE:
                    checkpoint.save(str(ckpt), straight)
                    prior = None if bcfg is None else straight.backend.prior
            resumed = make()
            resumed.step(*frames[0])
            checkpoint.load(str(ckpt), resumed)
            for l, r in frames[CKPT_SAVE:CKPT_FRAMES]:
                resumed.step(l, r)
            gap = float(np.abs(np.stack(resumed.poses) - np.stack(straight.poses)).max())
            if bcfg is None:
                check(gap == 0.0, f"checkpoint {variant}: resumed poses {gap} off")
                d_parts.append(f"{variant}: poses equal bit for bit")
            else:
                kf = (len(resumed.backend.kf_poses), len(straight.backend.kf_poses))
                check(prior is not None, "the save came before the first window slide")
                check(gap <= 5e-3 and resumed.backend.frame_of_kf == straight.backend.frame_of_kf,
                      f"checkpoint {variant}: poses {gap} off (<= 5e-3), keyframes "
                      f"{resumed.backend.frame_of_kf} against {straight.backend.frame_of_kf}")
                d_parts.append(f"{variant}: the prior present at the save, poses within "
                               f"{gap:.2e} (tolerance 5e-3), keyframes {kf[0]} / {kf[1]} at "
                               f"frames {straight.backend.frame_of_kf}")
            del straight, resumed
        d_line = (f"(d) checkpoint: persistent LK over {CKPT_FRAMES} frames, saved after "
                  f"{CKPT_SAVE} and resumed in a fresh System (graph): " + "; ".join(d_parts))

        # (e) the online feed ---------------------------------------------------
        sys_e = System(lk_cfg, device="cuda")
        vo = OnlineVO(sys_e, slop=0.02)
        reset_launches(kernels)
        try:
            for i, (l, r) in enumerate(frames[:ONLINE_FRAMES]):
                t = 0.1 * i
                pair = [(vo.push_left, t, l), (vo.push_right, t + 0.004 * (-1) ** i, r)]
                for push, ts, img in (pair if i % 2 else pair[::-1]):
                    push(ts, img)
            results = drain(vo, ONLINE_FRAMES)
            launches["online"] = {name: fn.launches for name, fn in kernels.items()}
        finally:
            vo.close()
        ts = [r["ts"] for r in results]
        captured = sys_e.graph is not None and sys_e.graph.key is not None  # by the worker
        ref_e = System(lk_cfg, device="cuda").run(frames[:ONLINE_FRAMES])
        same_e = len(sys_e.poses) == ONLINE_FRAMES and bool(
            np.array_equal(np.stack(sys_e.poses), ref_e))
        want_e = dict(zero, extract_windows_int=1 + LK_LAUNCHES_PER_STEP * (ONLINE_FRAMES - 1))
        check(len(results) == ONLINE_FRAMES and ts == sorted(ts) and vo.dropped == 0,
              f"online: {len(results)} results, ts {ts}, dropped {vo.dropped}")
        check(captured and same_e and launches["online"] == want_e
              and not vo._worker.is_alive(),
              f"online: graph captured {captured}, equal to System.run {same_e}, launches "
              f"{counted('online')}, worker alive {vo._worker.is_alive()}")
        burst = OnlineVO(sys_e, slop=0.02, maxlen=2)
        longest = 0.0
        try:
            for i in range(BURST):
                t0 = time.perf_counter()
                burst.push_left(100.0 + i, frames[i][0])
                burst.push_right(100.0 + i + 0.001, frames[i][1])
                longest = max(longest, time.perf_counter() - t0)
            got = drain(burst)
        finally:
            burst.close()
        check(burst.dropped >= 1 and len(got) + burst.dropped == BURST and longest < 0.5
              and not burst._worker.is_alive(),
              f"online burst: {len(got)} stepped, {burst.dropped} dropped of {BURST}, longest "
              f"push {longest * 1e3:.2f} ms, worker alive {burst._worker.is_alive()}")
        e_line = (f"(e) OnlineVO: {ONLINE_FRAMES} pairs pushed with jitter inside slop 0.02, "
                  f"either side first: {len(results)} results in order, dropped {vo.dropped}, "
                  f"the graph captured on the worker ({captured}), launches "
                  f"{counted('online')}, equal to System.run bit for bit: {same_e}; a burst "
                  f"of {BURST} into maxlen=2: {len(got)} stepped, {burst.dropped} dropped, the "
                  f"longest push {longest * 1e3:.3f} ms; after close() the workers alive: "
                  f"{vo._worker.is_alive()} / {burst._worker.is_alive()}")
        say("[19/22] " + "; ".join((c_line, d_line, e_line)))
        del sys_e
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, {"extract_windows_int": k1_err, "extract_patches": errs["ORB"][1]}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    t_start = time.perf_counter()
    import numpy as np
    import torch

    # 1. Device -----------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: "
          "this smoke run needs an NVIDIA GPU")
    check(PKG.is_dir(), f"the port package is missing beside this script ({PKG})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    say(f"[1/22] device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(smi)

    sys.path.insert(0, str(ROOT))
    from stereo_visual_odometry_tpu_torch.models import system as system_mod
    from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
    from stereo_visual_odometry_tpu_torch.ops import (cuda_stream, lk_block, lk_cell, lk_v1,
                                                      lk_v2, native, orb, patch, roll)
    from stereo_visual_odometry_tpu_torch.ops import lk as lk_ops
    from stereo_visual_odometry_tpu_torch.probes import ba_leg
    from stereo_visual_odometry_tpu_torch.probes import lk_block as probe_block
    from stereo_visual_odometry_tpu_torch.probes import lk_breakdown, lk_timing, patch_timing
    from stereo_visual_odometry_tpu_torch.probes import roll as probe_roll
    from stereo_visual_odometry_tpu_torch.probes import step_nodes
    from stereo_visual_odometry_tpu_torch.probes import timing
    k1_inputs, k2_inputs = patch_timing.k1_inputs, patch_timing.k2_inputs
    from stereo_visual_odometry_tpu_torch.models import ba
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    from stereo_visual_odometry_tpu_torch.utils import profiling, trajectory
    from stereo_visual_odometry_tpu_torch.utils.config import RunConfig

    kernels = {"extract_windows_int": patch.extract_windows_int,
               "extract_patches": patch.extract_patches,
               "level_track_cell": lk_cell.level_track_cell,
               "level_track_v1": lk_v1.level_track_v1,
               "level_track_block": lk_block.level_track_block,
               "level_track_v2": lk_v2.level_track_v2,
               "roll": roll.roll,
               "level_track_block_split": lk_block.level_track_block_split}
    plain_lk = {"cell": lk_cell.level_track_cell_reference,
                "v1": lk_v1.level_track_v1_reference,
                "block": lk_block.level_track_block_reference,
                "v2": lk_v2.level_track_v2_reference}
    lk_fn = {"cell": lk_cell.level_track_cell, "v1": lk_v1.level_track_v1,
             "block": lk_block.level_track_block, "v2": lk_v2.level_track_v2}
    masked = {"cell": True, "v1": True, "block": True, "v2": False}  # takes ``active``

    # 2. Build the kernels and K7's binding ----------------------------------
    lib_path = native.library_path()
    how = "found already built" if lib_path.exists() else "built with nvcc"
    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    ext_path = native.extension_path("roll_binding")
    how_ext = "found already built" if ext_path.exists() else "built"
    t0 = time.perf_counter()
    roll.launcher()
    bind_s = time.perf_counter() - t0
    cxx = native.extension_command("roll_binding")[0]
    say(f"[2/22] kernel library {lib_path.name} {how} in {build_s:.2f}s; K7 binding "
          f"{ext_path.name} {how_ext} with {cxx} (no ninja) in {bind_s:.2f}s; "
          f"ptxas: {'; '.join(ptxas)}")

    # 3. K1 vs plain at the LK and ORB shapes -------------------------------
    k1_err = 0.0
    orb_maps = [(-(-h // 32) * 32, -(-w // 32) * 32, 3, n)
                for (h, w), n in zip(ORB_LEVELS, ORB_BUDGETS)]
    k1_cases = [(hp, wp, S, N_POINTS) for hp, wp, S in K1_SHAPES] + orb_maps
    # The XLA tracker's search windows, (64, 64) at radius 20 and (36, 36) at
    # 6; ragged N and non-square windows (a quad that breaks a row, the
    # scalar path, a window over a whole CTA).
    k1_cases += [(406, 1302, (64, 64), N_POINTS), (406, 1302, (36, 36), N_POINTS)]
    k1_cases += [(408, 1408, S, n) for S in (24, (5, 7), (64, 36)) for n in K1_RAGGED]
    for i, (hp, wp, S, n) in enumerate(k1_cases):
        img, corners = k1_inputs(hp, wp, S, seed=i, n=n)
        got = patch.extract_windows_int(img, corners, S)
        torch.cuda.synchronize()
        want = patch.extract_windows_int_reference(img, corners, S)
        sh, sw = (S, S) if isinstance(S, int) else S
        check(got.shape == want.shape == (n, sh, sw), f"K1 shape {got.shape}")
        err = float((got - want).abs().max()) if n else 0.0
        check(err == 0.0, f"K1 disagrees with its plain version at {(hp, wp, S, n)}: "
              f"max abs err {err}")
        k1_err = max(k1_err, err)
    say(f"[3/22] K1 vs plain at {len(K1_SHAPES)} LK shapes (N={N_POINTS}), the XLA "
          f"tracker's S=64/36 windows, {len(orb_maps)} ORB score maps (S=3, "
          f"N=budget) and N={K1_RAGGED} at S=24, (5, 7), (64, 36) ({len(k1_cases)} "
          f"cases): max abs err {k1_err} (tolerance 0: a copy)")

    # 4. K2 vs plain at the ORB level shapes, P = 31, border cases ----------
    k2_err, bit_flips = 0.0, 0
    k2_cases = [(h, w, n, ORB_PATCH, 0.0) for (h, w), n in zip(ORB_LEVELS, ORB_BUDGETS)]
    k2_cases += [(h, w, n, 31, 0.0) for (h, w), n in zip(ORB_LEVELS[:2], ORB_BUDGETS[:2])]
    k2_cases += [(h, w, n, P, 2.0) for (h, w) in ORB_LEVELS[::3] for P in (ORB_PATCH, 31)
                 for n in K2_RAGGED]
    for i, (h, w, n, P, outside) in enumerate(k2_cases):
        img, xy = k2_inputs(h, w, n, seed=100 + i, outside=outside)
        got = patch.extract_patches(img, xy, P)
        torch.cuda.synchronize()
        p_pad = P // 2 + 2
        want = patch.extract_patches_reference(patch.pad_edge(img, p_pad, p_pad, p_pad, p_pad),
                                               xy, P, p_pad)
        plain = patch.extract_patches_clamped(img, xy, P)
        check(got.shape == want.shape == plain.shape == (n, P, P), f"K2 shape {got.shape}")
        err = max(float((got - want).abs().max()), float((got - plain).abs().max()))
        check(err == 0.0, f"K2 disagrees with its plain version at {(h, w, n, P, outside)}: "
              f"max abs err {err}")
        k2_err = max(k2_err, err)
        if P == ORB_PATCH:
            bits_k = orb.brief_bits_from_patches(got, None)
            bits_p = orb.brief_bits_from_patches(want, None)
            bit_flips += int((bits_k != bits_p).sum())
    check(bit_flips == 0, f"K2's patches give {bit_flips} other BRIEF bits")
    say(f"[4/22] K2 vs plain (on the padded image, and the clamped plain version) at "
          f"{len(ORB_LEVELS)} ORB level shapes (P={ORB_PATCH}, N={ORB_BUDGETS}), P=31 at "
          f"levels 0-1, and centres up to 2 px outside on all four sides at levels 0, 3, "
          f"6 for P={ORB_PATCH}/31 and N={K2_RAGGED} ({len(k2_cases)} cases): max abs err "
          f"{k2_err} (tolerance 0: the same products and fmas), BRIEF bits differing "
          f"{bit_flips}")

    # 5. K3 and K4 vs plain at the padded LK level shapes --------------------
    def level_cases():
        """Phase 5's inputs: each padded LK level shape with its textured
        pair, points, guesses and mask, at eps 0.01 and 0.03."""
        for lvl, (hp, wp) in enumerate(LK_PADDED):
            shift = (2.3 / 2 ** lvl, -1.4 / 2 ** lvl)
            prev, nxt = lk_timing.textured_pair(hp, wp, shift, seed=200 + lvl)
            pts, guess, active = lk_timing.lk_level_inputs(hp, wp, seed=300 + lvl)
            for eps in (0.01, 0.03):
                yield (hp, wp), shift, (prev, nxt, pts, guess), active, eps

    lk_err = dict.fromkeys(lk_fn, 0.0)
    lines = []
    for shape, shift, args, active, eps in level_cases():
        for name in ("cell", "v1"):
            kw = dict(win=WIN, iters=30, eps=eps, search_radius=6, pad=PAD, active=active)
            dmax, line = compare_levels(
                torch, f"{name} {shape} eps {eps}", level_call(torch, lk_fn[name], *args, **kw),
                level_call(torch, plain_lk[name], *args, **kw), active, eps, shift,
                same_iters=True)
            lk_err[name] = max(lk_err[name], dmax)
            lines.append(line)
    lk_bool = (torch.float32, torch.bool)
    empty = [no_points(torch, name, kernels, lk_bool, lambda name=name: lk_fn[name](
        args[0], args[1], args[2][:0], args[3][:0], pad=PAD, active=active[:0]))
        for name in ("cell", "v1")]
    say(f"[5/22] K3 (cell) and K4 (v1) vs plain (kernel against plain), N={N_POINTS}, "
          f"win {WIN}, 30 iters, {int(active.sum())} active: " + "; ".join(lines)
          + f"; N = 0, empty and no launch counted: {', '.join(empty)}")

    # 6-7. The LK and ORB slices through System on cuda ---------------------
    il, ir, poses_gt, cam = lk_timing.bench_sequence(N_FRAMES)
    frames = list(zip(il, ir))
    slices = {}  # tag -> (vo, frames, poses, chunk): phases 6-9's runs, for phase 15

    def run(vo, tag, fr=frames, gt=poses_gt, chunk=16, **kw):
        slices.setdefault(tag, (vo, fr, gt, chunk))
        return run_slice(np, torch, system_mod, trajectory, kernels,
                         RunConfig(camera=cam, vo=vo), fr, gt, tag, chunk=chunk, **kw)
    zero = dict.fromkeys(kernels, 0)
    lk_vo = dict(height=H, width=W, max_features=1024)
    launches = {}
    lk, launches["lk"] = run(VOConfig(**lk_vo), "LK")
    want = dict(zero, extract_windows_int=1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1))
    say("[6/22] " + describe_slice("LK", lk, launches["lk"], want))
    check_slice("LK", lk, launches["lk"], want, 0.05, 0.95)

    orb_cfg = VOConfig(mode="orb", height=H, width=W, max_features=ORB_FEATURES)
    ob, launches["orb"] = run(orb_cfg, "ORB")
    want = dict(zero, extract_windows_int=ORB_LAUNCHES_PER_FRAME * N_FRAMES,
                extract_patches=ORB_LAUNCHES_PER_FRAME * N_FRAMES)
    say("[7/22] " + describe_slice("ORB", ob, launches["orb"], want))
    check_slice("ORB", ob, launches["orb"], want, 0.07, 0.95)

    # 8. The LK slice on K3 and on K4 ---------------------------------------
    lines = []
    for name, counter in (("cell", "level_track_cell"), ("v1", "level_track_v1")):
        r, launches[f"lk_{name}"] = run(VOConfig(lk_kernel=name, **lk_vo), f"LK-{name}")
        want = dict(zero, extract_windows_int=N_FRAMES,
                    **{counter: LK_LEVELS_PER_STEP * (N_FRAMES - 1)})
        lines.append(describe_slice(f"LK lk_kernel={name!r}", r, launches[f"lk_{name}"],
                                    want))
        check_slice(f"LK-{name}", r, launches[f"lk_{name}"], want, 0.05, 0.95)
        lines[-1] += f"; {lk['ms_frame'] / r['ms_frame']:.2f}x the dense LK ms/frame"
    say("[8/22] " + "; ".join(lines) + f" (dense: {lk['ms_frame']:.2f} ms/frame)")

    # 9. The kernel-free LK branches on the first 16 frames -------------------
    lines = []
    for tag, kw, per_step in LK_BRANCHES:
        r, launches[f"lk_{tag}"] = run(VOConfig(**kw, **lk_vo), f"LK-{tag}",
                                       frames[:BRANCH_FRAMES], poses_gt[:BRANCH_FRAMES],
                                       chunk=8)
        want = dict(zero, extract_windows_int=1 + per_step * (BRANCH_FRAMES - 1))
        lines.append(describe_slice(f"LK {kw}", r, launches[f"lk_{tag}"], want,
                                    BRANCH_FRAMES))
        check_slice(f"LK-{tag}", r, launches[f"lk_{tag}"], want, 0.15, 0.9,
                    ate="ate_from_1")
    say("[9/22] " + "; ".join(lines))

    # 10. K5 and K6 vs plain, and vs the K3 and K4 kernels ---------------------
    lines = []
    # The device ops of one K6 wrapper call at phase 14's point (LK level 0,
    # every point tracked): one kernel.
    shape, shift, args, active, eps = next(level_cases())
    k6_node = one_node(torch, profiling, "K6's wrapper",
                       lambda: lk_fn["v2"](*args, win=WIN, eps=eps, pad=PAD))
    for shape, shift, args, active, eps in level_cases():
        for name, old in (("block", "cell"), ("v2", "v1")):
            kw = dict(win=WIN, iters=30, eps=eps, search_radius=6, pad=PAD)
            if masked[name]:
                kw["active"] = active
            tracked = active if masked[name] else torch.ones_like(active)
            got = level_call(torch, lk_fn[name], *args, **kw)
            dmax, line = compare_levels(
                torch, f"{name} {shape} eps {eps}", got,
                level_call(torch, plain_lk[name], *args, **kw), tracked, eps, shift,
                same_iters=True)
            _, line_old = compare_levels(
                torch, f"against the {old} kernel", got,
                level_call(torch, lk_fn[old], *args, **kw), tracked, eps, shift,
                same_iters=True)
            lk_err[name] = max(lk_err[name], dmax)
            lines.append(f"{line}; {line_old}")
    # K5's windows off its staged region: a smooth zero-mean pair (periods
    # 40-100 px, so LK converges from 11 px away) on LK level 1, guesses
    # STAGE_MARGIN + 4 px off the motion.
    hp, wp = LK_PADDED[1]
    shift = (2.0, -1.0)
    prev, nxt = lk_timing.textured_pair(hp, wp, shift, seed=210, periods=(40.0, 100.0),
                                        mean=0.0)
    pts, guess, active = lk_timing.lk_level_inputs(hp, wp, seed=310)
    guess = (guess / 3 + torch.tensor([shift[0] + lk_block.STAGE_MARGIN + 4, shift[1]],
                                      device="cuda")).contiguous()
    kw = dict(win=WIN, iters=30, eps=0.01, search_radius=20, pad=PAD, active=active)
    got = level_call(torch, lk_fn["block"], prev, nxt, pts, guess, **kw)
    plain_off = level_call(torch, plain_lk["block"], prev, nxt, pts, guess, **kw)
    share = lk_v1.staged_share(pts, guess, plain_off[2], hp, wp, pad=PAD)
    off = (1.0 - share) * len(plain_off[2]["corners"]) / int(active.sum())
    check(off > 1.0, f"K5 off the region: {off} off-region reloads per tracked point <= 1")
    dmax, line = compare_levels(torch, f"block off the region {(hp, wp)}", got, plain_off,
                                active, 0.01, shift, same_iters=True)
    _, line_old = compare_levels(torch, "against the cell kernel", got,
                                 level_call(torch, lk_fn["cell"], prev, nxt, pts, guess, **kw),
                                 active, 0.01, shift, same_iters=True)
    lk_err["block"] = max(lk_err["block"], dmax)
    lines.append(f"{line} ({off:.2f} off-region reloads per tracked point, staged share "
                 f"{share:.3f}); {line_old}")
    # K6 off the region on the same pair and guesses, every point tracked.
    kw.pop("active")
    every = torch.ones_like(active)
    got = level_call(torch, lk_fn["v2"], prev, nxt, pts, guess, **kw)
    plain_off = level_call(torch, plain_lk["v2"], prev, nxt, pts, guess, **kw)
    share = lk_v1.staged_share(pts, guess, plain_off[2], hp, wp, pad=PAD)
    off = (1.0 - share) * len(plain_off[2]["corners"]) / len(pts)
    check(off > 1.0, f"K6 off the region: {off} off-region reloads per point <= 1")
    dmax, line = compare_levels(torch, f"v2 off the region {(hp, wp)}", got, plain_off,
                                every, 0.01, shift, same_iters=True)
    _, line_old = compare_levels(torch, "against the v1 kernel", got,
                                 level_call(torch, lk_fn["v1"], prev, nxt, pts, guess, **kw),
                                 every, 0.01, shift, same_iters=True)
    lk_err["v2"] = max(lk_err["v2"], dmax)
    lines.append(f"{line} ({off:.2f} off-region reloads per point, staged share "
                 f"{share:.3f}); {line_old}")
    # K6 with phase 5's mask through its bare C entry, against the K4 kernel.
    for shape, shift, args, active, eps in level_cases():
        kw = dict(win=WIN, iters=30, eps=eps, search_radius=6, pad=PAD)
        held = lk_timing.bare_entry(native, cuda_stream.current_stream, "svo_lk_level_v2",
                                    args, dict(kw, active=active), stats=True)()
        torch.cuda.synchronize()
        flow, ok, counts = held[-3:]
        got = (flow, ok, {"iters": counts[:, 0], "reloads": counts[:, 1]})
        dmax, line = compare_levels(
            torch, f"v2 with the mask (bare entry) {shape} eps {eps} against the v1 kernel",
            got, level_call(torch, lk_fn["v1"], *args, active=active, **kw), active, eps,
            shift, same_iters=True)
        lk_err["v2"] = max(lk_err["v2"], dmax)
        lines.append(line)
    empty = [no_points(torch, name, kernels, lk_bool, lambda name=name: lk_fn[name](
        args[0], args[1], args[2][:0], args[3][:0], pad=PAD)) for name in ("block", "v2")]
    say(f"[10/22] K5 (block) and K6 (v2) vs plain (K3's and K4's plain versions) and "
          f"vs the K3/K4 kernels, N={N_POINTS}, win {WIN}, 30 iters, K5 with phase 5's "
          f"mask, K6's wrapper on every point and its bare entry with the mask: "
          + "; ".join(lines)
          + f"; N = 0, empty and no launch counted: {', '.join(empty)}; one K6 wrapper "
          f"call at phase 14's point, one device op: {k6_node}")

    # 11. K7 vs plain over the roll probe's grid -------------------------------
    k7_err, k7_cases = 0.0, 0
    g = torch.Generator(device="cuda").manual_seed(400)
    for axis in (0, 1):
        for rows in probe_roll.ROWS:
            x = torch.rand((rows, probe_roll.COLS), generator=g, device="cuda")
            for amt in probe_roll.amounts(axis, x.shape[axis], extended=True):
                a = torch.tensor([[amt]], dtype=torch.int32, device="cuda")
                got = roll.roll(x, a, axis)
                torch.cuda.synchronize()
                err = float((got - roll.roll_reference(x, a, axis)).abs().max())
                check(err == 0.0, f"K7 disagrees with torch.roll at axis {axis}, rows "
                      f"{rows}, amount {amt}: max abs err {err}")
                k7_err, k7_cases = max(k7_err, err), k7_cases + 1
    # The one-element kernel: an odd width, and a view off 16-byte alignment.
    flat = torch.rand(129 * 256, generator=g, device="cuda")
    for x in (torch.rand((37, 255), generator=g, device="cuda"),
              flat[1:1 + 128 * 256].view(128, 256)):
        for axis in (0, 1):
            for amt in (-5, -4, 3, 4, 9, 300):
                a = torch.tensor([[amt]], dtype=torch.int32, device="cuda")
                err = float((roll.roll(x, a, axis) - roll.roll_reference(x, a, axis)).abs().max())
                check(err == 0.0, f"K7 disagrees with torch.roll at {tuple(x.shape)} (aligned "
                      f"{x.data_ptr() % 16 == 0}), axis {axis}, amount {amt}: max abs err {err}")
                k7_err, k7_cases = max(k7_err, err), k7_cases + 1
    # The output is new memory; a graph of K7 calls replays them exactly; bad
    # inputs raise before any launch.
    x = torch.rand((128, probe_roll.COLS), generator=g, device="cuda")
    amts = [torch.tensor([[amt]], dtype=torch.int32, device="cuda") for amt in (9, -1, 300)]
    out = roll.roll(x, amts[0], 0)
    check(out.data_ptr() != x.data_ptr() and not torch.equal(out, x),
          "K7's output aliases its input")
    calls = lambda: [roll.roll(x, amts[i % 3], i % 2) for i in range(6)]
    graph_eq = timing.replays_equal(calls)
    check(graph_eq, "K7 replayed in a CUDA graph differs from its eager calls")
    refused = []
    for bad_x in (x.double(), x[None]):
        before = roll.roll.launches
        try:
            roll.roll(bad_x, amts[0], 0)
        except ValueError as e:
            refused.append(str(e).split(",")[0])
        check(roll.roll.launches == before, "K7 counted a launch for a refused input")
    check(len(refused) == 2, f"K7 took a float64 or a 3-D input: {refused}")
    say(f"[11/22] K7 through its binding vs plain (torch.roll) over {k7_cases} cases: axis "
          f"0 and 1, ({probe_roll.ROWS[0]}..{probe_roll.ROWS[-1]}, {probe_roll.COLS}), amounts "
          f"0, 1, 3, 7, 9 (axis 0) / 100 (axis 1), -1, the axis length and + 5, and on the "
          f"one-element kernel (37, 255) and a (128, 256) view 4 bytes off alignment: max abs "
          f"err {k7_err} (tolerance 0: a copy); output not its input; a CUDA graph of 6 "
          f"calls equal to the eager calls: {graph_eq}; refused: {refused}")

    # 12. K8 vs plain at the breakdown probe's operating point -----------------
    probe_in = probe_block.make_inputs("cuda")
    k8 = lk_breakdown.check(probe_in)
    torch.cuda.synchronize()
    full_flow, full_ok = lk_block.level_track_block(
        probe_in["prev"], probe_in["next"], probe_in["pts"], probe_in["guess"],
        search_radius=float("inf"), pad=probe_block.PAD)
    k8_full, k8_full_plain = k8["full"]["outputs"], k8["full"]["plain"]
    check(torch.equal(k8_full[0], full_flow) and torch.equal(k8_full[1] > 0, full_ok),
          "K8 full differs from K5's output on the same inputs")
    split_labels = [lb for lb in lk_breakdown.VARIANTS if lb != "full"]
    for label in split_labels:
        check(k8[label]["rel_err"] <= 1e-4, f"K8 {label} differs from its plain version "
              f"by {k8[label]['rel_err']} relative")
    k8_err = max(k8[lb]["abs_err"] for lb in split_labels)
    both = (k8_full[1] > 0) & (k8_full_plain[1] > 0)
    empty = [no_points(torch, label, kernels, (torch.float32,) * 3,
                       lambda label=label: lk_block.level_track_block_split(
                           probe_in["prev"], probe_in["next"], probe_in["pts"][:0],
                           probe_block.PAD, *lk_breakdown.VARIANTS[label]))
             for label in lk_breakdown.VARIANTS]
    k8_node = {label: one_node(torch, profiling, f"K8 {label}",
                               lambda label=label: lk_breakdown.run_variant(label, probe_in))
               for label in lk_breakdown.VARIANTS}
    say(f"[12/22] K8 vs plain at {tuple(probe_in['prev'].shape)}, N={len(probe_in['pts'])}: "
          + ", ".join(f"{lb} relative error {k8[lb]['rel_err']:.2e} (max abs "
                      f"{k8[lb]['abs_err']:.3g})" for lb in split_labels)
          + f" (tolerance 1e-4: sums in another order); full equals K5's output bit for "
          f"bit (against K5's plain version: ok agree "
          f"{float((k8_full[1] == k8_full_plain[1]).float().mean()):.4f}, max flow diff "
          f"{float((k8_full[0] - k8_full_plain[0]).abs().amax(-1)[both].max()):.2e} px); "
          f"N = 0, empty and no launch counted: {', '.join(empty)}; one device op per "
          f"call: " + ", ".join(f"{lb} {name}" for lb, name in k8_node.items()))

    # 13. This slice's paths: the probes, then their own timings ---------------
    probe_paths = {
        "probe_lk_block": (lambda: probe_block.parity(probe_in),
                           dict(level_track_cell=1, level_track_v1=1, level_track_block=1,
                                level_track_v2=1)),
        "probe_lk_breakdown": (lambda: lk_breakdown.check(probe_in),
                               dict(level_track_block_split=len(lk_breakdown.VARIANTS))),
        "probe_roll": (lambda: probe_roll.envelope("cuda"),
                       dict(roll=2 * len(probe_roll.ROWS) * 5)),
    }
    probe_out = {}
    for path, (drive, counts) in probe_paths.items():
        reset_launches(kernels)
        probe_out[path] = drive()
        torch.cuda.synchronize()
        launches[path] = {name: fn.launches for name, fn in kernels.items()}
        check(launches[path] == dict(zero, **counts),
              f"{path} launches {launches[path]}, want {dict(zero, **counts)}")
    for new, p in probe_out["probe_lk_block"].items():
        check(p["ok_agree"] >= 0.99 and p["max_flow_diff"] <= 0.01 and p["median_err"] < 0.05,
              f"probe lk_block: {new} against {p['against']}: {p}")
    for label in split_labels:
        check(probe_out["probe_lk_breakdown"][label]["rel_err"] <= 1e-4,
              f"probe lk_breakdown: {label} off its plain version")
    check(all(err == 0.0 for _, _, err in probe_out["probe_roll"]),
          f"probe roll: {probe_out['probe_roll']}")
    probe_t = probe_block.timing_ms(probe_in)
    k8_graph = lk_breakdown.timing_ms(probe_in)
    k8_split = lk_breakdown.split(k8_graph)
    say("[13/22] probes (launches read after each run: "
          + ", ".join(f"{p} {({k: v for k, v in launches[p].items() if v})}"
                      for p in probe_paths) + "): "
          + "; ".join(probe_block.describe(probe_out["probe_lk_block"], probe_t))
          + f"; roll envelope max err {max(e for _, _, e in probe_out['probe_roll'])}; "
          + "K8 in a CUDA graph of 30 calls: "
          + ", ".join(f"{lb} {t * 1e3:.2f} us" for lb, t in k8_graph.items())
          + " -> " + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in k8_split.items()))

    # 14. Timing: kernel, plain version, library call ------------------------
    def timed(kernel, plain, iters=200, plain_iters=200):
        runs = [timing.events_ms(f, iters=n) for f, n in
                ((plain, plain_iters), (kernel, iters), (kernel, iters),
                 (plain, plain_iters))]
        return min(runs[1], runs[2]), min(runs[0], runs[3])

    def plain_time(fn, iters=200):
        return min(timing.events_ms(fn, iters=iters) for _ in range(2))

    # K1 (S=24, N=1024 on LK level 0), K2 (P=39, N=445 on ORB level 0) and K7
    # ((128, 256), axis 0, amount 9), each back to back and in a CUDA graph of
    # 30 calls against its library call, and the wrappers' host time
    # (probes/patch_timing.py); the plain versions and the bounds here.
    pt = patch_timing.measure(patch, roll, timing)
    host = patch_timing.host_split(patch, native, cuda_stream.current_stream)
    k7_host = patch_timing.k7_host_split(roll)
    hp, wp, S = patch_timing.K1_SHAPE
    img, corners = k1_inputs(hp, wp, S, seed=S)
    _, c = patch_timing.k1_library(img, corners, S)
    k1_plain = plain_time(lambda: patch.extract_windows_int_reference(img, corners, S))
    k1_bound, k1_by = bound(4 * (window_pixels(torch, hp, wp, c[:, 0], c[:, 1], S)
                                 + N_POINTS * S * S) + 8 * N_POINTS, 0)

    # K2 reads the unpadded level: the distinct pixels its clamped windows cover.
    (h, w), n, P = patch_timing.K2_SHAPE, patch_timing.K2_N, patch_timing.K2_P
    img, xy = k2_inputs(h, w, n, seed=7)
    k2_plain = plain_time(lambda: patch.extract_patches_clamped(img, xy, P))
    pad, r = P // 2 + 2, (P - 1) / 2.0
    iy = torch.floor((xy[:, 1] + pad) - r).long().clamp(0, h + 2 * pad - P - 1) - pad
    ix = torch.floor((xy[:, 0] + pad) - r).long().clamp(0, w + 2 * pad - P - 1) - pad
    k2_bound, k2_by = bound(4 * (window_pixels(torch, h, w, iy, ix, P + 1) + n * P * P)
                            + 8 * n, 11 * n * P * P)

    # K3-K6 at LK level 0: 1024 points on (408, 1408), eps 0.01; K6's wrapper
    # on every point (it takes no mask), the others on the 770 of phase 5's
    # mask. Through probes/lk_timing.py (also at the lk_block probe's
    # operating point): the kernel alone (K6 with the mask, through its bare
    # C entry), its template phase and one iteration in a graph, the wrapper
    # in a graph, back to back and on the host, iterations, reloads and the
    # staged share; the plain versions, the bounds and K6's nodes here.
    lkt = lk_timing.measure({"lk_cell": lk_cell, "lk_v1": lk_v1, "lk_block": lk_block,
                             "lk_v2": lk_v2, "native": native,
                             "make_inputs": probe_block.make_inputs}, timing,
                            patch_timing.host_us, cuda_stream.current_stream,
                            bench=(frames[:lk_timing.BENCH_FRAMES], cam))
    hp, wp = LK_PADDED[0]
    prev, nxt = lk_timing.textured_pair(hp, wp, lk_timing.SHIFT, seed=200)
    pts, guess, active = lk_timing.lk_level_inputs(hp, wp, seed=300)
    lk_t = {}
    for name in lk_fn:
        kw = dict(win=WIN, iters=30, eps=0.01, search_radius=6, pad=PAD)
        if masked[name]:
            kw["active"] = active
        st_k, st_p = {}, {}
        lk_fn[name](prev, nxt, pts, guess, stats=st_k, **kw)
        plain_lk[name](prev, nxt, pts, guess, stats=st_p, **kw)
        plain = lambda name=name, kw=kw: plain_lk[name](prev, nxt, pts, guess, **kw)
        b_ms, b_by = lk_level_bound(torch, st_k, st_p["corners"], pts,
                                    active if masked[name] else torch.ones_like(active),
                                    hp, wp, "cell" if name in ("cell", "block") else "v1",
                                    io=None if masked[name] else len(pts) * (16 + 9))
        lk_t[name] = dict(lkt["smoke"][name], plain_ms=plain_time(plain, iters=5),
                          bound_ms=b_ms, bound_by=b_by)

    x = torch.rand(patch_timing.K7_SHAPE, device="cuda")
    a = torch.tensor([[patch_timing.K7_AMOUNT]], dtype=torch.int32, device="cuda")
    k7_plain = plain_time(lambda: roll.roll_reference(x, a, 0))
    k7_bound, k7_by = bound(2 * x.numel() * 4 + 4, 0)

    # K8 per variant at its probe's operating point (phase 12's inputs).
    st_k, st_p = {}, {}
    probe_block.run_level("block", probe_in, stats=st_k)
    lk_block.level_track_block_reference(probe_in["prev"], probe_in["next"], probe_in["pts"],
                                         probe_in["guess"], pad=probe_block.PAD,
                                         stats=st_p)
    k8_t = {}
    for label in lk_breakdown.VARIANTS:
        b_ms, b_by = split_bound(torch, label, probe_in, lk_breakdown.VARIANTS, st_k,
                                 st_p["corners"])
        ms, plain_ms = timed(lambda label=label: lk_breakdown.run_variant(label, probe_in),
                             lambda label=label: lk_breakdown.run_variant(label, probe_in,
                                                                          plain=True),
                             plain_iters=5)
        k8_t[label] = {"ms": ms, "graph_ms": k8_graph[label], "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
    lk_name = {"cell": "K3", "v1": "K4", "block": "K5", "v2": "K6"}
    us = lambda t: f"{t * 1e3:.2f} us"

    def patch_line(tag, key, plain, b_ms, b_by, lib):
        t = pt[key]
        return (f"{tag}: kernel {us(t['ms'])}, in a graph {us(t['graph_ms'])}, plain "
                f"{us(plain)}, {lib} {us(t['library_ms'])}, in a graph "
                f"{us(t['library_graph_ms'])} (max diff {t['library_max_diff']}), bound "
                f"{b_ms * 1e3:.3f} us ({b_by}), wrapper host time {t['host_us']:.2f} us")

    say("[14/22] K3-K6 (probes/lk_timing.py; graphs of "
          f"{lk_timing.GRAPH_CALLS} calls; staged share at margins {lk_timing.MARGINS}, "
          f"shipped {lk_v1.STAGE_MARGIN}; K6's wrapper on every point, one device op "
          f"(phase 10), its kernel alone with the mask): " + "; ".join(
              f"{lk_name[k]} {point}: kernel alone {us(t['kernel_graph_ms'])}, template "
              f"phase {us(t['template_graph_ms'])}, one iteration "
              f"{us(t['one_iter_graph_ms'])}, wrapper in a graph {us(t['graph_ms'])}, b2b "
              f"{us(t['ms'])}, host {t['host_us']:.2f} us, iterations {t['iters']}, reloads "
              f"{t['reloads']}, staged share {t['staged_share']}"
              for point in ("smoke", "probe") for k, t in lkt[point].items())
          + f"; on the first {lk_timing.BENCH_FRAMES} bench frames: " + "; ".join(
              f"{lk_name[k]} {b['calls']} calls ({b['recorded_on']}'s), kernel alone "
              f"{us(b['kernel_graph_ms'])} "
              f"(largest {us(b['kernel_graph_ms_max'])}), iterations {b['iters']}, staged "
              f"share {b['staged_share']}"
              for k, b in lkt["bench"].items()))
    say("[14/22] host time per K1 wrapper call, us (perf_counter over "
          f"{patch_timing.HOST_CALLS} calls, no sync): "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
    say("[14/22] host time per K7 call, us (the same way): "
          + ", ".join(f"{k} {v:.3f}" for k, v in k7_host.items())
          + f"; in a graph of {patch_timing.GRAPH_CALLS} calls, in turns: one row "
          f"{us(pt['k7']['one_row_graph_ms'])} (K7's practical floor), "
          f"{patch_timing.K7_SHAPE} {us(pt['k7']['graph_ms_beside_one_row'])}")
    say(f"[14/22] CUDA events, {patch_timing.B2B_CALLS} calls each (5 for the LK plain "
          f"versions), and CUDA graphs of {patch_timing.GRAPH_CALLS} calls: "
          + patch_line(f"K1 S={S} N={N_POINTS} on {patch_timing.K1_SHAPE[:2]}", "k1",
                       k1_plain, k1_bound, k1_by, "grid_sample(nearest)") + "; "
          + patch_line(f"K2 P={P} N={n} on {(h, w)}", "k2", k2_plain, k2_bound, k2_by,
                       "grid_sample(bilinear, border, unpadded)") + "; "
          + "; ".join(
              f"{lk_name[k]} ({k}) N={N_POINTS} on {(hp, wp)} eps 0.01: "
              f"kernel {us(t['ms'])}, in a graph {us(t['graph_ms'])}, plain "
              f"{us(t['plain_ms'])}, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), no "
              f"single library call" for k, t in lk_t.items()) + "; "
          + patch_line(f"K7 {tuple(x.shape)} axis 0 amount {patch_timing.K7_AMOUNT}", "k7",
                       k7_plain, k7_bound, k7_by, "torch.roll")
          + f"; K8 on {tuple(probe_in['prev'].shape)}: "
          + ", ".join(f"{lb} kernel {t['ms'] * 1e3:.2f} us, in a graph "
                      f"{t['graph_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
                      f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})"
                      for lb, t in k8_t.items()) + ", no single library call; one device op "
          "per call (phase 12); the split in graphs of 30 calls (phase 13): "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in k8_split.items()))

    # 15. Eager against graph, in turns; a profiled replay per path ---------
    lines, profiles = [], []
    branch_tags = {f"LK-{tag}" for tag, _, _ in LK_BRANCHES}
    for tag, (vo, fr, gt, chunk) in slices.items():
        # The first BRANCH_FRAMES frames of every path, and EAGER_BRANCH_FRAMES
        # of the kernel-free branches (the slowest eager steps), keep the
        # script's total near half its time limit, with phases 16-19.
        n = EAGER_BRANCH_FRAMES if tag in branch_tags else BRANCH_FRAMES
        fr, gt, chunk = fr[:n], gt[:n], min(chunk, n // 2)
        eager, _ = run(vo, tag, fr, gt, chunk, graph=False, keep=True)
        graphed, _ = run(vo, tag, fr, gt, chunk, keep=True)
        same = bool(np.array_equal(eager["traj"], graphed["traj"]))
        check(eager["accepts"] == graphed["accepts"] and eager["tracked"] == graphed["tracked"]
              and eager["ate"] == graphed["ate"] and same,
              f"{tag}: the graph differs from the eager step: ATE {graphed['ate']} against "
              f"{eager['ate']}, accept {graphed['accept']} against {eager['accept']}, "
              f"n_tracked {graphed['n_tracked']} against {eager['n_tracked']}, largest pose "
              f"difference {np.abs(eager['traj'] - graphed['traj']).max()}")
        lines.append(f"{tag} ({len(fr)} frames): eager {eager['ms_frame']:.2f} ms/frame, "
                     f"graph {graphed['ms_frame']:.2f} ({eager['ms_frame'] / graphed['ms_frame']:.2f}x), "
                     f"capture {graphed['capture_s']:.2f} s; ATE {eager['ate']:.4f} / "
                     f"{graphed['ate']:.4f} m, accept {eager['accept']:.3f} / "
                     f"{graphed['accept']:.3f}, n_tracked {eager['n_tracked']:.1f} / "
                     f"{graphed['n_tracked']:.1f}, trajectories equal bit for bit: {same}")
        profiles.append(profile_step(np, torch, profiling, step_nodes, tag, eager, graphed,
                                     fr[-1]))
        del eager, graphed
        torch.cuda.empty_cache()  # the graph's pool
    say("[15/22] eager against graph, System.run_chunked in turns (eager, then graph; "
          "steady ms/frame after the first chunk): " + "; ".join(lines))
    say("[15/22] one profiled step per path (eager: step_fn; graph: one replay; device "
          "ops = kernels, copies and fills; idle = 1 - busy / wall): " + "; ".join(profiles))

    # 16-17. Slice 3: persistent tracks, the BA leg ------------------------
    mods = dict(np=np, torch=torch, system_mod=system_mod, trajectory=trajectory,
                kernels=kernels, VOConfig=VOConfig, RunConfig=RunConfig,
                BackendConfig=BackendConfig, ba=ba, ba_leg=ba_leg, profiling=profiling)
    launches.update(persistent_phase(mods, cam, frames, poses_gt))
    ba_launches, ba_passes = ba_leg_phase(mods, cam, frames, poses_gt, smi)
    launches.update(ba_launches)

    # 18. Slice 4: S sequences in one step graph, the batched entries, the
    # distributed solve ------------------------------------------------------
    from stereo_visual_odometry_tpu_torch.parallel import dist_ba, multihost, sequences
    from stereo_visual_odometry_tpu_torch.probes import batched, multihost_demo
    mods.update(patch=patch, lk_cell=lk_cell, lk_v1=lk_v1, lk_timing=lk_timing,
                patch_timing=patch_timing, timing=timing, batched=batched,
                sequences=sequences, dist_ba=dist_ba, multihost=multihost,
                multihost_demo=multihost_demo)
    bounds = {"extract_windows_int": (k1_bound, k1_by), "extract_patches": (k2_bound, k2_by),
              "level_track_cell": (lk_t["cell"]["bound_ms"], lk_t["cell"]["bound_by"]),
              "level_track_v1": (lk_t["v1"]["bound_ms"], lk_t["v1"]["bound_by"])}
    s4_launches, s4 = slice4_phase(mods, cam, il, ir, poses_gt, bounds)
    launches.update(s4_launches)

    # 19. Slice 5: the command line, checkpoint/resume, the online feed --------
    s5_launches, s5_err = slice5_phase(mods, cam, il, ir, poses_gt)
    launches.update(s5_launches)
    k1_err, k2_err = max(k1_err, s5_err["extract_windows_int"]), max(k2_err,
                                                                    s5_err["extract_patches"])

    # 20. bench.py's card legs ------------------------------------------------
    from stereo_visual_odometry_tpu_torch.probes import bench
    mods.update(bench=bench)
    launches.update(bench_phase(mods, (il, ir, poses_gt), ba_passes, smi))

    # 21. The seq mesh: a sequence batch split over two shards -----------------
    from stereo_visual_odometry_tpu_torch.parallel import evaluate
    from stereo_visual_odometry_tpu_torch.probes import scaling
    mods.update(evaluate=evaluate, scaling=scaling)
    launches.update(mesh_phase(mods, cam, il, ir, poses_gt))

    # 22. Kernel report ---------------------------------------------------
    src = "stereo_visual_odometry_tpu_torch/csrc/"
    by_path = lambda name: {p: ln[name] for p, ln in launches.items()}
    timed_keys = ("ms", "graph_ms", "library_ms", "library_graph_ms", "library_max_diff")
    patch_t = {key: {k: pt[key][k] for k in timed_keys} for key in pt}
    report = [
        {"name": "extract_windows_int", "route": "cuda", "source": src + "extract_windows.cu",
         "replaces": "stereo_visual_odometry_tpu/ops/patch_pallas.py:88",
         "max_abs_err": k1_err, **patch_t["k1"], "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "host_us": pt["k1"]["host_us"]},
        {"name": "extract_patches", "route": "cuda", "source": src + "extract_patches.cu",
         "replaces": "stereo_visual_odometry_tpu/ops/patch_pallas.py:46",
         "max_abs_err": k2_err, **patch_t["k2"], "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "host_us": pt["k2"]["host_us"]},
    ]
    for name, counter, source, replaces in (
            ("cell", "level_track_cell", "lk_level.cu",
             "stereo_visual_odometry_tpu/ops/lk_pallas_cell.py:48"),
            ("v1", "level_track_v1", "lk_level.cu",
             "stereo_visual_odometry_tpu/ops/lk_pallas.py:46"),
            ("block", "level_track_block", "lk_block.cu", "scripts/lk_pallas_block.py:58"),
            ("v2", "level_track_v2", "lk_block.cu", "scripts/lk_pallas_v2.py:43")):
        report.append({"name": counter, "route": "cuda", "source": src + source,
                       "replaces": replaces, "max_abs_err": lk_err[name], **lk_t[name],
                       "library_ms": None})
        if name == "v2":
            report[-1]["device_ops_per_call"] = 1  # one_node's check in phase 10
        if name in lkt["bench"]:
            report[-1].update(probe_point=lkt["probe"][name], bench_point=lkt["bench"][name])
    report.append({"name": "roll", "route": "cuda", "source": src + "roll.cu",
                   "binding": src + "roll_binding.cpp", "binding_build_s": bind_s,
                   "replaces": "scripts/probe_roll.py:12", "max_abs_err": k7_err,
                   **patch_t["k7"], "plain_ms": k7_plain, "bound_ms": k7_bound,
                   "bound_by": k7_by, "host_us": pt["k7"]["host_us"],
                   "one_row_graph_ms": pt["k7"]["one_row_graph_ms"],
                   "host_split_us": k7_host})
    # K8's headline numbers are the reload variant with 3 rounds (the JAX
    # probe's default); every variant is listed under "variants".
    report.append({"name": "level_track_block_split", "route": "cuda",
                   "source": src + "lk_block.cu",
                   "replaces": "scripts/probe_lk_breakdown.py:42", "max_abs_err": k8_err,
                   "kernel": "K5's (lk_block_cell_kernel): full its body with the raw "
                             "tail, tmpl its staging and template phase, reload also its "
                             "window read and 8 dots per forced round",
                   "device_ops_per_call": 1,  # one_node's check in phase 12
                   "max_rel_err": max(k8[lb]["rel_err"] for lb in split_labels),
                   **k8_t["reload3"], "library_ms": None, "variants": k8_t,
                   "split_graph_ms": k8_split})
    for entry in report:
        if entry["name"] in s4:  # K1-K4: the batched entry beside the kernel
            entry["batched"] = s4[entry["name"]]
        entry["launches_by_path"] = by_path(entry["name"])
        entry["launches"] = sum(entry["launches_by_path"].values())
    say(f"[22/22] kernel report and result ({time.perf_counter() - t_start:.1f} s since the "
          "start)")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
