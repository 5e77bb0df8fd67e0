#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereo_visual_odometry_tpu_torch``)
on one NVIDIA GPU, end to end through its ``System``: LK on each level
tracker and prior of ``VOConfig``, and ORB.

    python3 chip_smoke.py    # the eleven phases below, on cuda:0

Phases (each prints one line; any failure exits non-zero):
  1. device: needs ``torch.cuda.is_available()`` (no CPU path); prints
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
  2. build the kernels (``csrc/*.cu``, one nvcc per source, all at once);
  3. K1 (``csrc/extract_windows.cu``) against its plain PyTorch version at
     the LK path's shapes and at ORB's 3x3 subpixel reads: max abs error 0;
  4. K2 (``csrc/extract_patches.cu``) against its plain version at the 8
     ORB level shapes with the level budgets (P = 39): max abs error 0, and
     the BRIEF bits of both patch sets equal;
  5. K3 and K4 (``csrc/lk_level.cu``) against their plain versions at the
     two padded LK level shapes, N = 1024, on a textured pair with a known
     subpixel shift, random guesses and a quarter of the points inactive:
     ok masks >= 99% equal, flows within 1e-3 px for >= 98% of the points
     both keep and within eps for all (sums in another order);
  6. the LK slice: the 49-frame KITTI-shaped synthetic sequence (376x1241
     edge-padded to 384x1280, 1024 features) through
     ``System.run_chunked(chunk=16)``; ATE < 0.05 m, accept >= 0.95, K1
     launched 27 times per tracked frame + once at init;
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
 10. K1-K4 timed with CUDA events against their plain versions and, for
     K1 and K2, one library call each (``F.grid_sample``);
 11. the kernel report.
The launch counts hold without a reinit; each slice's run sets every
count to 0 just before ``run_chunked`` and reads them just after. The
second-to-last line is the kernel report (JSON), the last line
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
LK_LEVELS_PER_STEP = 6     # level calls per step: stereo legs 1 level, temporal 2
# The kernel-free LK branches: config, K1 launches per tracked frame, frames.
LK_BRANCHES = [("xla", dict(lk_backend="xla"), 7), ("no_sweep", dict(lk_sweep=False), 45),
               ("not_predictive", dict(lk_predictive=False), 61)]
BRANCH_FRAMES = 16
LK_PADDED = [(408, 1408), (216, 768)]  # LK levels 0 and 1 at 384x1280, padded
WIN, PAD = 21, 12
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


def textured_pair(torch, hp, wp, shift_xy, seed):
    """A smooth random texture (40 sinusoids, periods 6-40 px) and the same
    texture moved by ``shift_xy`` px: an exact subpixel shift."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = 40
    period = 6.0 + 34.0 * torch.rand(k, generator=g, device="cuda")
    theta = 2 * torch.pi * torch.rand(k, generator=g, device="cuda")
    phase = 2 * torch.pi * torch.rand(k, generator=g, device="cuda")
    amp = 10.0 + 20.0 * torch.rand(k, generator=g, device="cuda")
    wx, wy = 2 * torch.pi * torch.cos(theta) / period, 2 * torch.pi * torch.sin(theta) / period
    y = torch.arange(hp, device="cuda", dtype=torch.float64)[:, None, None]
    x = torch.arange(wp, device="cuda", dtype=torch.float64)[None, :, None]

    def img(dx, dy):
        arg = (wx.double() * (x - dx) + wy.double() * (y - dy) + phase.double())
        return (128.0 + (amp.double() * torch.sin(arg)).sum(-1) / 4).float().contiguous()

    return img(0.0, 0.0), img(*shift_xy)


def lk_level_inputs(torch, hp, wp, seed, n=N_POINTS):
    """Points inside a padded level, guesses within 1.5 px, ~25% inactive."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    span = torch.tensor([wp - 2 * PAD - 1.0, hp - 2 * PAD - 1.0], device="cuda")
    pts = torch.rand((n, 2), generator=g, device="cuda") * span
    guess = (torch.rand((n, 2), generator=g, device="cuda") - 0.5) * 3.0
    active = torch.rand(n, generator=g, device="cuda") > 0.25
    return pts.contiguous(), guess.contiguous(), active


def lk_level_bound(torch, stats, corners, pts, active, hp, wp, kernel):
    """Least time of one K3/K4 call on these inputs: the distinct pixels of
    the template windows and of the windows the points visited (read once),
    the inputs and outputs, against the flops the taken iterations need."""
    r = (WIN - 1) // 2
    tp = pts[active] + PAD
    tr = torch.floor(tp[:, 1] - r - 1.0).long().clamp(0, hp - WIN - 3)
    tc = torch.floor(tp[:, 0] - r - 1.0).long().clamp(0, wp - WIN - 3)
    n, n_act = pts.shape[0], int(active.sum())
    pix = (window_pixels(torch, hp, wp, tr, tc, WIN + 3) +
           window_pixels(torch, hp, wp, corners[:, 0].long(), corners[:, 1].long(),
                         WIN + 1))
    io = n * (8 + 8 + 4) + n * (8 + 4 + 8)  # pts, guess, active; flow, ok, counts
    ww = WIN * WIN
    flops = n_act * (11 * (WIN + 2) ** 2 + 14 * ww)  # blend, gradients, 5 dots
    iters, reloads = int(stats["iters"].sum()), int(stats["reloads"].sum())
    if kernel == "cell":
        flops += reloads * 16 * ww + iters * 30  # 8 dots per cell; scalar steps
    else:
        flops += iters * (16 * ww + 10)          # blend + 2 dots per iteration
    return bound(4 * pix + io, flops)


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


def reset_launches(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def run_slice(np, torch, system_mod, trajectory, kernels, cfg, frames, poses_gt, tag,
              chunk=16):
    """Drive ``System.run_chunked`` once with the launch counts set to 0 just
    before and read just after; returns (numbers, launches)."""
    sys_ = system_mod.System(cfg, device="cuda")
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
    }
    return out, launches


def describe_slice(tag, r, launches, want, n_frames=N_FRAMES):
    return (f"{tag} System.run_chunked on cuda, {n_frames} frames {H}x{W}: "
            f"ATE {r['ate']:.4f} m (from frame 1: {r['ate_from_1']:.4f} m), RPE {r['rpe_t']:.4f} m / {r['rpe_r']:.5f} rad, "
            f"accept {r['accept']:.3f}, n_tracked {r['n_tracked']:.1f}, steady "
            f"{r['ms_frame']:.2f} ms/frame ({1e3 / r['ms_frame']:.1f} fps; "
            f"{r['n_steady']} frames after the first chunk), whole run "
            f"{r['wall']:.2f} s, launches {launches} (want {want} without a reinit)")


def check_slice(tag, r, launches, want, max_ate, min_accept, ate="ate"):
    check(r[ate] < max_ate, f"{tag} {ate} {r[ate]} m >= {max_ate} m")
    check(r["accept"] >= min_accept, f"{tag} accept rate {r['accept']} < {min_accept}")
    for name, n in want.items():
        check(n == 0 or launches[name] > 0, f"the {tag} path never launched {name}")
    if r["no_reinit"]:
        check(launches == want, f"{tag} launches {launches}, want {want}")


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
    print(f"[1/11] device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(smi)

    sys.path.insert(0, str(ROOT))
    from stereo_visual_odometry_tpu_torch.models import system as system_mod
    from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
    from stereo_visual_odometry_tpu_torch.ops import lk_cell, lk_v1, native, orb, patch
    from stereo_visual_odometry_tpu_torch.utils import synthetic, trajectory
    from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig

    kernels = {"extract_windows_int": patch.extract_windows_int,
               "extract_patches": patch.extract_patches,
               "level_track_cell": lk_cell.level_track_cell,
               "level_track_v1": lk_v1.level_track_v1}
    plain_lk = {"cell": lk_cell.level_track_cell_reference,
                "v1": lk_v1.level_track_v1_reference}
    lk_fn = {"cell": lk_cell.level_track_cell, "v1": lk_v1.level_track_v1}

    # 2. Build the kernels ---------------------------------------------------
    lib_path = native.library_path()
    how = "found already built" if lib_path.exists() else "built with nvcc"
    t0 = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[2/11] kernel library {lib_path.name} {how} in {build_s:.2f}s; "
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
    # The XLA tracker's search windows, (64, 64) at radius 20 and (36, 36) at 6.
    for size in (64, 36):
        img, corners = k1_inputs(torch, 406, 1302, size, seed=size)
        got = patch.extract_windows_int(img, corners, (size, size))
        torch.cuda.synchronize()
        err = float((got - patch.extract_windows_int_reference(img, corners, size))
                    .abs().max())
        check(err == 0.0, f"K1 disagrees with its plain version at S={size}: {err}")
    print(f"[3/11] K1 vs plain at {len(K1_SHAPES)} LK shapes (N={N_POINTS}), the XLA "
          f"tracker's S=64/36 windows and {len(orb_maps)} ORB score maps (S=3, "
          f"N=budget): max abs err {k1_err} (tolerance 0: a copy)")

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
    print(f"[4/11] K2 vs plain at {len(ORB_LEVELS)} ORB level shapes (P={ORB_PATCH}, "
          f"N={ORB_BUDGETS}): max abs err {k2_err} (tolerance 0: the same products "
          f"and fmas), BRIEF bits differing {bit_flips}")

    # 5. K3 and K4 vs plain at the padded LK level shapes --------------------
    lk_err = {"cell": 0.0, "v1": 0.0}
    lines = []
    for lvl, (hp, wp) in enumerate(LK_PADDED):
        shift = (2.3 / 2 ** lvl, -1.4 / 2 ** lvl)
        prev, nxt = textured_pair(torch, hp, wp, shift, seed=200 + lvl)
        pts, guess, active = lk_level_inputs(torch, hp, wp, seed=300 + lvl)
        for eps in (0.01, 0.03):
            for name in ("cell", "v1"):
                kw = dict(win=WIN, iters=30, eps=eps, search_radius=6, pad=PAD,
                          active=active)
                st_k, st_p = {}, {}
                fk, okk = lk_fn[name](prev, nxt, pts, guess, stats=st_k, **kw)
                torch.cuda.synchronize()
                fp, okp = plain_lk[name](prev, nxt, pts, guess, stats=st_p, **kw)
                agree = float((okk == okp).float().mean())
                both = okk & okp
                d = (fk - fp).abs().amax(-1)[both]
                far = float((d > 1e-3).float().mean()) if len(d) else 0.0
                dmax = float(d.max()) if len(d) else 0.0
                true_err = float((fk[both] - torch.tensor(shift, device="cuda"))
                                 .norm(dim=-1).median())
                check(agree >= 0.99, f"{name} ok masks agree on {agree} < 0.99 "
                      f"at {(hp, wp)}, eps {eps}")
                check(int(both.sum()) > 0.5 * int(active.sum()),
                      f"{name} kept {int(both.sum())} of {int(active.sum())} points")
                check(dmax <= eps and far <= 0.02, f"{name} flows differ from the "
                      f"plain version's by up to {dmax} ({far:.3%} above 1e-3) at "
                      f"{(hp, wp)}, eps {eps}")
                check(not bool(okk[~active].any()), f"{name}: an inactive point is ok")
                check(true_err < 0.05, f"{name}: median error {true_err} px to the "
                      f"true shift {shift}")
                lk_err[name] = max(lk_err[name], dmax)
                a = active
                lines.append(
                    f"{name} {(hp, wp)} eps {eps}: max flow diff {dmax:.2e} px "
                    f"({far:.2%} > 1e-3), ok agree {agree:.4f}, median error to the "
                    f"shift {true_err:.4f} px, iterations/reloads per active point "
                    f"kernel {float(st_k['iters'][a].float().mean()):.2f}/"
                    f"{float(st_k['reloads'][a].float().mean()):.2f} plain "
                    f"{float(st_p['iters'][a].float().mean()):.2f}/"
                    f"{float(st_p['reloads'][a].float().mean()):.2f}")
    print(f"[5/11] K3 (cell) and K4 (v1) vs plain, N={N_POINTS}, win {WIN}, 30 iters, "
          f"{int(active.sum())} active: " + "; ".join(lines))

    # 6-7. The LK and ORB slices through System on cuda ---------------------
    il, ir, poses_gt = bench_frames(synthetic, np)
    frames = list(zip(il, ir))
    cam = CameraConfig(fx=FX, fy=FX, cx=W_RAW / 2, cy=H_RAW / 2, baseline=BASELINE)
    run = lambda vo, tag, fr=frames, gt=poses_gt, chunk=16: run_slice(
        np, torch, system_mod, trajectory, kernels, RunConfig(camera=cam, vo=vo), fr, gt,
        tag, chunk=chunk)
    zero = dict.fromkeys(kernels, 0)
    lk_vo = dict(height=H, width=W, max_features=1024)
    launches = {}
    lk, launches["lk"] = run(VOConfig(**lk_vo), "LK")
    want = dict(zero, extract_windows_int=1 + LK_LAUNCHES_PER_STEP * (N_FRAMES - 1))
    print("[6/11] " + describe_slice("LK", lk, launches["lk"], want))
    check_slice("LK", lk, launches["lk"], want, 0.05, 0.95)

    orb_cfg = VOConfig(mode="orb", height=H, width=W, max_features=ORB_FEATURES)
    ob, launches["orb"] = run(orb_cfg, "ORB")
    want = dict(zero, extract_windows_int=ORB_LAUNCHES_PER_FRAME * N_FRAMES,
                extract_patches=ORB_LAUNCHES_PER_FRAME * N_FRAMES)
    print("[7/11] " + describe_slice("ORB", ob, launches["orb"], want))
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
    print("[8/11] " + "; ".join(lines) + f" (dense: {lk['ms_frame']:.2f} ms/frame)")

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
    print("[9/11] " + "; ".join(lines))

    # 10. Timing: kernel, plain version, library call ------------------------
    def timed(kernel, plain, iters=200, plain_iters=200):
        runs = [time_ms(torch, f, iters=n) for f, n in
                ((plain, plain_iters), (kernel, iters), (kernel, iters),
                 (plain, plain_iters))]
        return min(runs[1], runs[2]), min(runs[0], runs[3])

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
    k1_ms, k1_plain = timed(lambda: patch.extract_windows_int(img, corners, S),
                            lambda: patch.extract_windows_int_reference(img, corners, S))
    k1_lib = time_ms(torch, lib1)
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
    k2_ms, k2_plain = timed(
        lambda: patch.extract_patches(img, xy, ORB_PATCH),
        lambda: patch.extract_patches_reference(patch.pad_edge(img, pad, pad, pad, pad),
                                                xy, ORB_PATCH, pad))
    k2_lib = time_ms(torch, lib2)
    k2_bound, k2_by = bound(
        4 * (window_pixels(torch, hp, wp, iy, ix, ORB_PATCH + 1) + n * ORB_PATCH ** 2)
        + 8 * n, 11 * n * ORB_PATCH ** 2)

    # K3 and K4 at LK level 0: 1024 points on (408, 1408), eps 0.01.
    hp, wp = LK_PADDED[0]
    prev, nxt = textured_pair(torch, hp, wp, (2.3, -1.4), seed=200)
    pts, guess, active = lk_level_inputs(torch, hp, wp, seed=300)
    kw = dict(win=WIN, iters=30, eps=0.01, search_radius=6, pad=PAD, active=active)
    lk_t = {}
    for name in ("cell", "v1"):
        st_k, st_p = {}, {}
        lk_fn[name](prev, nxt, pts, guess, stats=st_k, **kw)
        plain_lk[name](prev, nxt, pts, guess, stats=st_p, **kw)
        ms, plain_ms = timed(lambda: lk_fn[name](prev, nxt, pts, guess, **kw),
                             lambda: plain_lk[name](prev, nxt, pts, guess, **kw),
                             plain_iters=5)
        b_ms, b_by = lk_level_bound(torch, st_k, st_p["corners"], pts, active, hp, wp,
                                    name)
        lk_t[name] = (ms, plain_ms, b_ms, b_by)
    print(f"[10/11] CUDA events, 200 calls each (5 for the LK plain versions): K1 S={S} "
          f"N={N_POINTS} on {K1_SHAPES[0][:2]}: kernel {k1_ms * 1e3:.2f} us, plain "
          f"{k1_plain * 1e3:.2f} us, grid_sample(nearest) {k1_lib * 1e3:.2f} us (max diff "
          f"{k1_lib_diff}), bound {k1_bound * 1e3:.3f} us ({k1_by}); K2 P={ORB_PATCH} "
          f"N={n} on {(h, w)}: kernel {k2_ms * 1e3:.2f} us, plain {k2_plain * 1e3:.2f} us, "
          f"grid_sample(bilinear) {k2_lib * 1e3:.2f} us (max diff {k2_lib_diff}), bound "
          f"{k2_bound * 1e3:.3f} us ({k2_by}); " + "; ".join(
              f"{'K3' if k == 'cell' else 'K4'} ({k}) N={N_POINTS} on {(hp, wp)} eps 0.01: "
              f"kernel {t[0] * 1e3:.2f} us, plain {t[1] * 1e3:.2f} us, bound "
              f"{t[2] * 1e3:.3f} us ({t[3]}), no single library call"
              for k, t in lk_t.items()))

    # 11. Kernel report ---------------------------------------------------
    src = "stereo_visual_odometry_tpu_torch/csrc/"
    by_path = lambda name: {p: ln[name] for p, ln in launches.items()}
    report = [
        {"name": "extract_windows_int", "route": "cuda", "source": src + "extract_windows.cu",
         "replaces": "stereo_visual_odometry_tpu/ops/patch_pallas.py:88",
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib, "library_max_diff": k1_lib_diff},
        {"name": "extract_patches", "route": "cuda", "source": src + "extract_patches.cu",
         "replaces": "stereo_visual_odometry_tpu/ops/patch_pallas.py:46",
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib, "library_max_diff": k2_lib_diff},
    ]
    for name, counter, replaces in (
            ("cell", "level_track_cell", "stereo_visual_odometry_tpu/ops/lk_pallas_cell.py:48"),
            ("v1", "level_track_v1", "stereo_visual_odometry_tpu/ops/lk_pallas.py:46")):
        ms, plain_ms, b_ms, b_by = lk_t[name]
        report.append({"name": counter, "route": "cuda", "source": src + "lk_level.cu",
                       "replaces": replaces, "max_abs_err": lk_err[name], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None})
    for entry in report:
        entry["launches_by_path"] = by_path(entry["name"])
        entry["launches"] = sum(entry["launches_by_path"].values())
    print("[11/11] kernel report and result")
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
