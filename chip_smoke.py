#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereo_visual_odometry_tpu_torch``)
on one NVIDIA GPU, end to end through its ``System``.

    python3 chip_smoke.py    # the five phases below, on cuda:0

Phases (each prints one line; any failure exits non-zero):
  1. device: needs ``torch.cuda.is_available()`` (no CPU path); prints
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
  2. build K1 (``csrc/extract_windows.cu``) with nvcc from the checkout;
  3. K1 against its plain PyTorch version at the main path's shapes:
     max abs error must be 0;
  4. the slice: the 49-frame KITTI-shaped synthetic sequence (376x1241
     edge-padded to 384x1280, 1024 features) through
     ``System.run_chunked(chunk=16)`` on cuda; ATE < 0.05 m, accept >= 0.95,
     and K1 launched 27 times per tracked frame + once at init;
  5. K1 against the plain version, timed with CUDA events.
The second-to-last line is the kernel report (JSON), the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "stereo_visual_odometry_tpu_torch"

# The bench sequence (bench.py:31-49): KITTI 00 geometry, seed 3.
H_RAW, W_RAW, H, W = 376, 1241, 384, 1280
N_FRAMES, FX, BASELINE = 49, 718.856, 0.537
K1_SHAPES = [  # (Hp, Wp, S) that the main path hands K1 at 384x1280
    (408, 1408, 24), (408, 1408, 22),   # LK level 0, padded
    (216, 768, 24), (216, 768, 22),     # LK level 1, padded
    (384, 1280, 3),                     # FAST score map, subpixel refine
]
N_POINTS = 1024
LAUNCHES_PER_STEP = 27  # 26 LK window reads + 1 subpixel refine


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def k1_inputs(torch, hp, wp, S, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((hp, wp), generator=g, device="cuda") * 255
    rows = torch.randint(0, hp - S + 1, (N_POINTS,), generator=g, device="cuda")
    cols = torch.randint(0, wp - S + 1, (N_POINTS,), generator=g, device="cuda")
    corners = torch.stack([rows, cols], -1).to(torch.int32)
    # The extremes of the pre-clipped range, and a few outside it (clamped).
    corners[:6] = torch.tensor([[0, 0], [hp - S, wp - S], [-3, wp + 5],
                                [hp + 2, -1], [0, wp - S], [hp - S, 0]],
                               dtype=torch.int32, device="cuda")
    return img.contiguous(), corners.contiguous()


def time_ms(torch, fn, iters=200, warmup=10):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_frames(synthetic, np):
    seq = synthetic.render_sequence(n_frames=N_FRAMES, h=H_RAW, w=W_RAW, fx=FX,
                                    baseline=BASELINE, n_points=9000, speed=1.1,
                                    seed=3)
    pad = lambda a: np.pad(a, ((0, 0), (0, H - H_RAW), (0, W - W_RAW)), mode="edge")
    return pad(seq["images_l"]), pad(seq["images_r"]), seq["poses_gt"]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
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
    print(f"[1/5] device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(smi)

    sys.path.insert(0, str(ROOT))
    from stereo_visual_odometry_tpu_torch.models import system as system_mod
    from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
    from stereo_visual_odometry_tpu_torch.ops import native, patch
    from stereo_visual_odometry_tpu_torch.utils import synthetic, trajectory
    from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig

    # 2. Build K1 ----------------------------------------------------------
    lib_path = native.library_path()
    how = "found already built" if lib_path.exists() else "built with nvcc"
    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln]
    print(f"[2/5] K1 library {lib_path.name} {how} in {build_s:.2f}s; "
          f"ptxas: {'; '.join(ptxas)}")

    # 3. K1 vs plain at the main-path shapes --------------------------------
    max_err = 0.0
    for i, (hp, wp, S) in enumerate(K1_SHAPES):
        img, corners = k1_inputs(torch, hp, wp, S, seed=i)
        got = patch.extract_windows_int(img, corners, S)
        torch.cuda.synchronize()
        want = patch.extract_windows_int_reference(img, corners, S)
        check(got.shape == want.shape == (N_POINTS, S, S), f"K1 shape {got.shape}")
        err = float((got - want).abs().max())
        check(err == 0.0, f"K1 disagrees with its plain version at {(hp, wp, S)}: "
              f"max abs err {err}")
        max_err = max(max_err, err)
    print(f"[3/5] K1 vs plain at {len(K1_SHAPES)} main-path shapes, N={N_POINTS}: "
          f"max abs err {max_err} (tolerance 0: a copy)")

    # 4. The slice through System on cuda -----------------------------------
    il, ir, poses_gt = bench_frames(synthetic, np)
    frames = list(zip(il, ir))
    cfg = RunConfig(camera=CameraConfig(fx=FX, fy=FX, cx=W_RAW / 2, cy=H_RAW / 2,
                                        baseline=BASELINE),
                    vo=VOConfig(height=H, width=W, max_features=1024))
    sys_ = system_mod.System(cfg, device="cuda")
    patch.extract_windows_int.launches = 0
    t0 = time.perf_counter()
    traj = sys_.run_chunked(frames, chunk=16)
    wall = time.perf_counter() - t0
    launches = patch.extract_windows_int.launches
    check(traj.shape == (N_FRAMES, 4, 4) and np.isfinite(traj).all(),
          f"trajectory shape {traj.shape} or non-finite values")
    tracked = [m for m in sys_.metrics if not m["init"]]
    ate = trajectory.ate_rmse(traj, poses_gt)
    rpe_t, rpe_r = trajectory.rpe(traj, poses_gt)
    accept = float(np.mean([m["accept"] for m in tracked]))
    n_tracked = float(np.mean([m["n_tracked"] for m in tracked]))
    steady = [m["time_s"] for m in sys_.metrics[1 + 16:]]  # after the first chunk
    ms_frame = 1e3 * float(np.mean(steady))
    no_reinit = all(m["n_detected"] >= cfg.vo.min_features_detect for m in sys_.metrics)
    want_launches = 1 + LAUNCHES_PER_STEP * (N_FRAMES - 1)
    print(f"[4/5] System.run_chunked on cuda, {N_FRAMES} frames {H}x{W}: "
          f"ATE {ate:.4f} m, RPE {rpe_t:.4f} m / {rpe_r:.5f} rad, accept {accept:.3f}, "
          f"n_tracked {n_tracked:.1f}, steady {ms_frame:.2f} ms/frame "
          f"({1e3 / ms_frame:.1f} fps; {len(steady)} frames after the first chunk), "
          f"whole run {wall:.2f} s, K1 launches {launches} (want {want_launches})")
    check(ate < 0.05, f"ATE {ate} m >= 0.05 m")
    check(accept >= 0.95, f"accept rate {accept} < 0.95")
    if no_reinit:
        check(launches == want_launches, f"K1 launched {launches} times, "
              f"the main path needs {want_launches}")
    check(launches > 0, "the main path never launched K1")

    # 5. K1 vs plain, timed ------------------------------------------------
    timings = {}
    for hp, wp, S in K1_SHAPES[:2]:
        img, corners = k1_inputs(torch, hp, wp, S, seed=S)
        k = lambda: patch.extract_windows_int(img, corners, S)
        p = lambda: patch.extract_windows_int_reference(img, corners, S)
        runs = [time_ms(torch, f) for f in (p, k, k, p)]
        timings[S] = (min(runs[1], runs[2]), min(runs[0], runs[3]))
    print("[5/5] K1 CUDA events, N=1024 on (408, 1408): " + ", ".join(
        f"S={S} kernel {k_ms * 1e3:.2f} us vs plain {p_ms * 1e3:.2f} us"
        for S, (k_ms, p_ms) in timings.items()))

    k24, p24 = timings[24]
    print(json.dumps({"kernels": [{
        "name": "extract_windows_int", "route": "cuda",
        "source": "stereo_visual_odometry_tpu_torch/csrc/extract_windows.cu",
        "replaces": "stereo_visual_odometry_tpu/ops/patch_pallas.py:88",
        "launches": launches, "max_abs_err": max_err,
        "ms": k24, "plain_ms": p24}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
