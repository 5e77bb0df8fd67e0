#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereo_visual_odometry_tpu_torch``)
on one NVIDIA GPU, end to end through its ``System``, in LK and ORB mode.

    python3 chip_smoke.py    # the eight phases below, on cuda:0

Phases (each prints one line; any failure exits non-zero):
  1. device: needs ``torch.cuda.is_available()`` (no CPU path); prints
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
  2. build the kernels (``csrc/*.cu``, one nvcc per source, all at once);
  3. K1 (``csrc/extract_windows.cu``) against its plain PyTorch version at
     the LK path's shapes and at ORB's 3x3 subpixel reads: max abs error 0;
  4. K2 (``csrc/extract_patches.cu``) against its plain version at the 8
     ORB level shapes with the level budgets (P = 39): max abs error 0, and
     the BRIEF bits of both patch sets equal;
  5. the LK slice: the 49-frame KITTI-shaped synthetic sequence (376x1241
     edge-padded to 384x1280, 1024 features) through
     ``System.run_chunked(chunk=16)``; ATE < 0.05 m, accept >= 0.95, K1
     launched 27 times per tracked frame + once at init;
  6. the ORB slice: the same frames, ``mode='orb'`` at 2048 features;
     ATE < 0.07 m, accept >= 0.95, and (without a reinit) K1 and K2
     launched 16 times per frame (8 levels x 2 images), 784 in all;
  7. K1 and K2 timed with CUDA events against their plain versions and one
     library call each (``F.grid_sample``), with each call's max difference;
  8. the kernel report.
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
K1_SHAPES = [  # (Hp, Wp, S) that the LK path hands K1 at 384x1280
    (408, 1408, 24), (408, 1408, 22),   # LK level 0, padded
    (216, 768, 24), (216, 768, 22),     # LK level 1, padded
    (384, 1280, 3),                     # FAST score map, subpixel refine
]
N_POINTS = 1024
LK_LAUNCHES_PER_STEP = 27  # 26 LK window reads + 1 subpixel refine
# ORB at 384x1280, 8 levels of scale 1.2, 2048 features: each level's image
# shape, its score map padded to the 32-px cell, and its budget.
ORB_LEVELS = [(384, 1280), (320, 1067), (267, 889), (222, 741), (185, 617),
              (154, 514), (129, 429), (107, 357)]
ORB_BUDGETS = [445, 371, 309, 257, 214, 179, 149, 124]
ORB_FEATURES, ORB_PATCH = 2048, 39
ORB_LAUNCHES_PER_FRAME = 16  # per kernel: 8 levels x 2 images
# H100 SXM datasheet peaks: HBM bytes/s, float32 FLOP/s.
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def k1_inputs(torch, hp, wp, S, seed, n=N_POINTS):
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((hp, wp), generator=g, device="cuda") * 255
    rows = torch.randint(0, hp - S + 1, (n,), generator=g, device="cuda")
    cols = torch.randint(0, wp - S + 1, (n,), generator=g, device="cuda")
    corners = torch.stack([rows, cols], -1).to(torch.int32)
    # The extremes of the pre-clipped range, and a few outside it (clamped).
    corners[:6] = torch.tensor([[0, 0], [hp - S, wp - S], [-3, wp + 5],
                                [hp + 2, -1], [0, wp - S], [hp - S, 0]],
                               dtype=torch.int32, device="cuda")
    return img.contiguous(), corners.contiguous()


def k2_inputs(torch, h, w, n, seed):
    """A random level image and n centres where ORB puts them (inside the
    EDGE = 19 border), plus the image corners."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((h, w), generator=g, device="cuda") * 255
    lo = torch.tensor([19.0, 19.0], device="cuda")
    span = torch.tensor([w - 39.0, h - 39.0], device="cuda")
    xy = lo + torch.rand((n, 2), generator=g, device="cuda") * span
    xy[:4] = torch.tensor([[0.0, 0.0], [w - 1.0, h - 1.0], [w - 1.0, 0.0],
                           [0.0, h - 1.0]], device="cuda")
    return img, xy


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


def window_pixels(torch, hp, wp, rows, cols, size):
    """Distinct pixels of (hp, wp) that size x size windows at the corners
    (rows, cols) cover: the least the gather must read."""
    off = torch.arange(size, device=rows.device)
    r = (rows[:, None] + off).clamp(0, hp - 1)[:, :, None]
    c = (cols[:, None] + off).clamp(0, wp - 1)[:, None, :]
    seen = torch.zeros((hp, wp), dtype=torch.bool, device=rows.device)
    seen[r.expand(-1, size, size), c.expand(-1, size, size)] = True
    return int(seen.sum())


def bound(bytes_moved, flops):
    """Least time on the card (ms) and what bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bench_frames(synthetic, np):
    seq = synthetic.render_sequence(n_frames=N_FRAMES, h=H_RAW, w=W_RAW, fx=FX,
                                    baseline=BASELINE, n_points=9000, speed=1.1,
                                    seed=3)
    pad = lambda a: np.pad(a, ((0, 0), (0, H - H_RAW), (0, W - W_RAW)), mode="edge")
    return pad(seq["images_l"]), pad(seq["images_r"]), seq["poses_gt"]


def run_slice(np, torch, system_mod, trajectory, patch, cfg, frames, poses_gt, tag):
    """Drive ``System.run_chunked`` once with the launch counts set to 0 just
    before and read just after; returns (numbers, launches)."""
    sys_ = system_mod.System(cfg, device="cuda")
    patch.extract_windows_int.launches = 0
    patch.extract_patches.launches = 0
    t0 = time.perf_counter()
    traj = sys_.run_chunked(frames, chunk=16)
    wall = time.perf_counter() - t0
    launches = {"extract_windows_int": patch.extract_windows_int.launches,
                "extract_patches": patch.extract_patches.launches}
    check(traj.shape == (N_FRAMES, 4, 4) and np.isfinite(traj).all(),
          f"{tag}: trajectory shape {traj.shape} or non-finite values")
    tracked = [m for m in sys_.metrics if not m["init"]]
    rpe_t, rpe_r = trajectory.rpe(traj, poses_gt)
    steady = [m["time_s"] for m in sys_.metrics[1 + 16:]]  # after the first chunk
    out = {
        "ate": trajectory.ate_rmse(traj, poses_gt), "rpe_t": rpe_t, "rpe_r": rpe_r,
        "accept": float(np.mean([m["accept"] for m in tracked])),
        "n_tracked": float(np.mean([m["n_tracked"] for m in tracked])),
        "ms_frame": 1e3 * float(np.mean(steady)), "n_steady": len(steady), "wall": wall,
        "no_reinit": all(m["n_detected"] >= cfg.vo.min_features_detect
                         for m in sys_.metrics),
    }
    return out, launches


def describe_slice(tag, r, launches, want):
    return (f"{tag} System.run_chunked on cuda, {N_FRAMES} frames {H}x{W}: "
            f"ATE {r['ate']:.4f} m, RPE {r['rpe_t']:.4f} m / {r['rpe_r']:.5f} rad, "
            f"accept {r['accept']:.3f}, n_tracked {r['n_tracked']:.1f}, steady "
            f"{r['ms_frame']:.2f} ms/frame ({1e3 / r['ms_frame']:.1f} fps; "
            f"{r['n_steady']} frames after the first chunk), whole run "
            f"{r['wall']:.2f} s, launches {launches} (want {want} without a reinit)")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    # 1. Device -----------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: "
          "this smoke run needs an NVIDIA GPU")
    check(PKG.is_dir(), f"the port package is missing beside this script ({PKG})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[1/8] device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(smi)

    sys.path.insert(0, str(ROOT))
    from stereo_visual_odometry_tpu_torch.models import system as system_mod
    from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
    from stereo_visual_odometry_tpu_torch.ops import native, orb, patch
    from stereo_visual_odometry_tpu_torch.utils import synthetic, trajectory
    from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig

    # 2. Build K1 and K2 ---------------------------------------------------
    lib_path = native.library_path()
    how = "found already built" if lib_path.exists() else "built with nvcc"
    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[2/8] kernel library {lib_path.name} {how} in {build_s:.2f}s; "
          f"ptxas: {'; '.join(ptxas)}")

    # 3. K1 vs plain at the LK and ORB shapes -------------------------------
    k1_err = 0.0
    orb_maps = [(-(-h // 32) * 32, -(-w // 32) * 32, 3, n)
                for (h, w), n in zip(ORB_LEVELS, ORB_BUDGETS)]
    k1_cases = [(hp, wp, S, N_POINTS) for hp, wp, S in K1_SHAPES] + orb_maps
    for i, (hp, wp, S, n) in enumerate(k1_cases):
        img, corners = k1_inputs(torch, hp, wp, S, seed=i, n=n)
        got = patch.extract_windows_int(img, corners, S)
        torch.cuda.synchronize()
        want = patch.extract_windows_int_reference(img, corners, S)
        check(got.shape == want.shape == (n, S, S), f"K1 shape {got.shape}")
        err = float((got - want).abs().max())
        check(err == 0.0, f"K1 disagrees with its plain version at {(hp, wp, S)}: "
              f"max abs err {err}")
        k1_err = max(k1_err, err)
    print(f"[3/8] K1 vs plain at {len(K1_SHAPES)} LK shapes (N={N_POINTS}) and "
          f"{len(orb_maps)} ORB score maps (S=3, N=budget): max abs err {k1_err} "
          "(tolerance 0: a copy)")

    # 4. K2 vs plain at the ORB level shapes --------------------------------
    k2_err, bit_flips = 0.0, 0
    pad = ORB_PATCH // 2 + 2
    for lvl, ((h, w), n) in enumerate(zip(ORB_LEVELS, ORB_BUDGETS)):
        img, xy = k2_inputs(torch, h, w, n, seed=100 + lvl)
        got = patch.extract_patches(img, xy, ORB_PATCH)
        torch.cuda.synchronize()
        want = patch.extract_patches_reference(patch.pad_edge(img, pad, pad, pad, pad),
                                               xy, ORB_PATCH, pad)
        check(got.shape == want.shape == (n, ORB_PATCH, ORB_PATCH),
              f"K2 shape {got.shape}")
        err = float((got - want).abs().max())
        check(err == 0.0, f"K2 disagrees with its plain version at level {lvl} "
              f"{(h, w)}: max abs err {err}")
        k2_err = max(k2_err, err)
        bits_k = orb.brief_bits_from_patches(got, None)
        bits_p = orb.brief_bits_from_patches(want, None)
        bit_flips += int((bits_k != bits_p).sum())
    check(bit_flips == 0, f"K2's patches give {bit_flips} other BRIEF bits")
    print(f"[4/8] K2 vs plain at {len(ORB_LEVELS)} ORB level shapes (P={ORB_PATCH}, "
          f"N={ORB_BUDGETS}): max abs err {k2_err} (tolerance 0: the same products "
          f"and fmas), BRIEF bits differing {bit_flips}")

    # 5-6. The LK and ORB slices through System on cuda ---------------------
    il, ir, poses_gt = bench_frames(synthetic, np)
    frames = list(zip(il, ir))
    cam = CameraConfig(fx=FX, fy=FX, cx=W_RAW / 2, cy=H_RAW / 2, baseline=BASELINE)
    lk, lk_launches = run_slice(
        np, torch, system_mod, trajectory, patch,
        RunConfig(camera=cam, vo=VOConfig(height=H, width=W, max_features=1024)),
        frames, poses_gt, "LK")
    want_lk = {"extract_windows_int": 1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1),
               "extract_patches": 0}
    print("[5/8] " + describe_slice("LK", lk, lk_launches, want_lk))
    check(lk["ate"] < 0.05, f"LK ATE {lk['ate']} m >= 0.05 m")
    check(lk["accept"] >= 0.95, f"LK accept rate {lk['accept']} < 0.95")
    check(lk_launches["extract_windows_int"] > 0, "the LK path never launched K1")
    if lk["no_reinit"]:
        check(lk_launches == want_lk, f"LK launches {lk_launches}, want {want_lk}")

    orb_cfg = RunConfig(camera=cam, vo=VOConfig(mode="orb", height=H, width=W,
                                                max_features=ORB_FEATURES))
    ob, orb_launches = run_slice(np, torch, system_mod, trajectory, patch, orb_cfg,
                                 frames, poses_gt, "ORB")
    want_orb = {k: ORB_LAUNCHES_PER_FRAME * N_FRAMES for k in want_lk}
    print("[6/8] " + describe_slice("ORB", ob, orb_launches, want_orb))
    check(ob["ate"] < 0.07, f"ORB ATE {ob['ate']} m >= 0.07 m")
    check(ob["accept"] >= 0.95, f"ORB accept rate {ob['accept']} < 0.95")
    check(min(orb_launches.values()) > 0, f"the ORB path skipped a kernel: {orb_launches}")
    if ob["no_reinit"]:
        check(orb_launches == want_orb, f"ORB launches {orb_launches}, want {want_orb}")

    # 7. Timing: kernel, plain version, library call -------------------------
    def timed(kernel, plain, library):
        runs = [time_ms(torch, f) for f in (plain, kernel, kernel, plain)]
        return min(runs[1], runs[2]), min(runs[0], runs[3]), time_ms(torch, library)

    # K1 at the LK path's S=24 shape, N=1024.
    hp, wp, S = K1_SHAPES[0]
    img, corners = k1_inputs(torch, hp, wp, S, seed=S)
    c = corners.long().clamp(min=0)
    c = torch.stack([c[:, 0].clamp(max=hp - S), c[:, 1].clamp(max=wp - S)], -1)
    off = torch.arange(S, device="cuda", dtype=torch.float32)
    gx = (c[:, 1, None, None] + off[None, None, :]).expand(-1, S, S) * (2.0 / (wp - 1)) - 1
    gy = (c[:, 0, None, None] + off[None, :, None]).expand(-1, S, S) * (2.0 / (hp - 1)) - 1
    grid1 = torch.stack([gx, gy], -1).reshape(1, -1, S, 2)
    lib1 = lambda: F.grid_sample(img[None, None], grid1, mode="nearest",
                                 align_corners=True)
    k1_out = patch.extract_windows_int(img, corners, S)
    k1_lib_diff = float((lib1().reshape(-1, S, S) - k1_out).abs().max())
    k1_ms, k1_plain, k1_lib = timed(lambda: patch.extract_windows_int(img, corners, S),
                                    lambda: patch.extract_windows_int_reference(
                                        img, corners, S), lib1)
    k1_bound, k1_by = bound(4 * (window_pixels(torch, hp, wp, c[:, 0], c[:, 1], S)
                                 + N_POINTS * S * S) + 8 * N_POINTS, 0)

    # K2 at ORB level 0: 445 patches of 39x39 on the 384x1280 level.
    (h, w), n = ORB_LEVELS[0], ORB_BUDGETS[0]
    img, xy = k2_inputs(torch, h, w, n, seed=7)
    img_pad = patch.pad_edge(img, pad, pad, pad, pad)
    hp, wp = img_pad.shape
    r = (ORB_PATCH - 1) / 2.0
    ty, tx = (xy[:, 1] + pad) - r, (xy[:, 0] + pad) - r
    iy = torch.floor(ty).long().clamp(0, hp - ORB_PATCH - 1)
    ix = torch.floor(tx).long().clamp(0, wp - ORB_PATCH - 1)
    off = torch.arange(ORB_PATCH, device="cuda", dtype=torch.float32)
    gx = (tx[:, None, None] + off[None, None, :]).expand(-1, ORB_PATCH, ORB_PATCH)
    gy = (ty[:, None, None] + off[None, :, None]).expand(-1, ORB_PATCH, ORB_PATCH)
    grid2 = torch.stack([gx * (2.0 / (wp - 1)) - 1, gy * (2.0 / (hp - 1)) - 1],
                        -1).reshape(1, -1, ORB_PATCH, 2)
    lib2 = lambda: F.grid_sample(img_pad[None, None], grid2, mode="bilinear",
                                 padding_mode="border", align_corners=True)
    k2_out = patch.extract_patches(img, xy, ORB_PATCH)
    k2_lib_diff = float((lib2().reshape(-1, ORB_PATCH, ORB_PATCH) - k2_out).abs().max())
    k2_ms, k2_plain, k2_lib = timed(
        lambda: patch.extract_patches(img, xy, ORB_PATCH),
        lambda: patch.extract_patches_reference(patch.pad_edge(img, pad, pad, pad, pad),
                                                xy, ORB_PATCH, pad), lib2)
    k2_bound, k2_by = bound(
        4 * (window_pixels(torch, hp, wp, iy, ix, ORB_PATCH + 1) + n * ORB_PATCH ** 2)
        + 8 * n, 11 * n * ORB_PATCH ** 2)
    print(f"[7/8] CUDA events, 200 calls each: K1 S={S} N={N_POINTS} on "
          f"{K1_SHAPES[0][:2]}: kernel {k1_ms * 1e3:.2f} us, plain {k1_plain * 1e3:.2f} us, "
          f"grid_sample(nearest) {k1_lib * 1e3:.2f} us (max diff {k1_lib_diff}), bound "
          f"{k1_bound * 1e3:.3f} us ({k1_by}); K2 P={ORB_PATCH} N={n} on {(h, w)}: "
          f"kernel {k2_ms * 1e3:.2f} us, plain {k2_plain * 1e3:.2f} us, "
          f"grid_sample(bilinear) {k2_lib * 1e3:.2f} us (max diff {k2_lib_diff}), bound "
          f"{k2_bound * 1e3:.3f} us ({k2_by})")

    # 8. Kernel report ----------------------------------------------------
    src = "stereo_visual_odometry_tpu_torch/csrc/"
    print("[8/8] kernel report and result")
    print(json.dumps({"kernels": [
        {"name": "extract_windows_int", "route": "cuda", "source": src + "extract_windows.cu",
         "replaces": "stereo_visual_odometry_tpu/ops/patch_pallas.py:88",
         "launches": lk_launches["extract_windows_int"] + orb_launches["extract_windows_int"],
         "launches_by_path": {"lk": lk_launches["extract_windows_int"],
                              "orb": orb_launches["extract_windows_int"]},
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib, "lib_ms": k1_lib,
         "library_max_diff": k1_lib_diff},
        {"name": "extract_patches", "route": "cuda", "source": src + "extract_patches.cu",
         "replaces": "stereo_visual_odometry_tpu/ops/patch_pallas.py:46",
         "launches": orb_launches["extract_patches"],
         "launches_by_path": {"lk": lk_launches["extract_patches"],
                              "orb": orb_launches["extract_patches"]},
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib, "lib_ms": k2_lib,
         "library_max_diff": k2_lib_diff},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
