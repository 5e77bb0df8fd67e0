"""The JAX package's ``bench.py`` on the card: throughput and accuracy of the
port's ``System`` over the bench's synthetic KITTI-shaped sequence, its
stress variants and its BA leg, with an on-card kernel parity check.

    python -m stereo_visual_odometry_tpu_torch.probes.bench

Prints ONE JSON line in ``bench.py``'s schema: ``metric: vo_frames_per_s``,
``value`` (frames/s of the better mode by speed-up over its own OpenCV
row), ``unit``, ``vs_baseline``, ``parity`` (rows ``gpu_lk``, ``gpu_orb``,
``gpu_{lk,orb}_{flicker,yaw}`` and the six ``opencv_*`` rows), ``gpu_parity``
and ``ba``, plus ``device`` (the card's name and power limit by
``nvidia-smi``) and ``opencv_source``. The card has no OpenCV: the
``opencv_*`` rows are the cached CPU figures of ``BASELINE_MEASURED.json``
(the faithful OpenCV re-executions of both reference pipelines that
``bench.py`` ran on an earlier host), read and never written.

Function by function (``bench.py``'s line numbers):
  make_frames      ``make_frames`` (:42-49) and ``STRESS_VARIANTS`` (:56-59)
  run_gpu          ``run_tpu`` (:237-301): ``System.run_chunked(chunk=16)``
                   over the whole sequence, the step replayed from its CUDA
                   graph; frames/s over chunks 1-2, as the first absorbs the
                   capture
  run_gpu_ba       ``run_tpu_ba`` (:304-355), on ``probes/ba_leg.py``
  run_gpu_parity   ``run_tpu_parity`` (:401-475): K2 against the bilinear
                   sampler, LK on K1 (``dense``) and K3 (``cell``) against
                   the XLA formulation, BRIEF bits against float64 numpy
  main             ``main`` (:478-570)

Sizes and depths are the module's constants (``bench.py``'s), read when a
function runs. Runs on the card; without a GPU it raises unless
``--device cpu`` is given (the tests' small runs).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..models.frontend import VOConfig
from ..models.system import System
from ..utils import synthetic, trajectory
from ..utils.config import CameraConfig, RunConfig
from . import ba_leg

H_RAW, W_RAW = 376, 1241
H, W = 384, 1280
N_FRAMES = 49       # frame 0 initializes; 48 tracked steps = 3 chunks of 16
FEATURES = 1024     # LK; ORB runs at the reference's nFeatures=2000
ORB_FEATURES = 2048
FX, BASELINE = 718.856, 0.537
CHUNK = 16
MODES = ("lk", "orb")
STRESS_VARIANTS = {
    "flicker": dict(flicker=0.25),
    "yaw": dict(yaw_rate=0.02),
}
OPENCV_CACHE = Path(__file__).resolve().parents[2] / "BASELINE_MEASURED.json"
OPENCV_KEYS = tuple(f"reference_{m}{v}" for v in ("", "_flicker", "_yaw") for m in MODES)


def make_frames(seed: int = 3, n_frames: int | None = None, **stress):
    """The bench sequence: left and right (N, H, W) float32 grey levels,
    edge-padded from (H_RAW, W_RAW), and the (N, 4, 4) true poses."""
    seq = synthetic.render_sequence(
        n_frames=N_FRAMES if n_frames is None else n_frames, h=H_RAW, w=W_RAW, fx=FX,
        baseline=BASELINE, n_points=9000, speed=1.1, seed=seed, **stress)
    pad = lambda a: np.pad(a, ((0, 0), (0, H - H_RAW), (0, W - W_RAW)), mode="edge")
    return pad(seq["images_l"]), pad(seq["images_r"]), seq["poses_gt"]


def run_gpu(il, ir, mode: str = "lk", device: str = "cuda") -> dict:
    """The whole sequence through ``System.run_chunked``: trajectory, accept
    rate and mean n_tracked over every tracked frame; frames/s over the
    chunks after the first (its wall includes the graph's capture) up to the
    last full one. The config is the shipping ``VOConfig`` for the mode at
    the frames' size, nothing pinned."""
    chunk = CHUNK
    n_chunks = (len(il) - 1) // chunk
    if n_chunks < 2:
        raise ValueError(f"{len(il)} frames: the timed chunks need at least 2 * {chunk} + 1")
    cfg = VOConfig(mode=mode, height=il.shape[1], width=il.shape[2],
                   max_features=ORB_FEATURES if mode == "orb" else FEATURES)
    cam = CameraConfig(fx=FX, fy=FX, cx=W_RAW / 2, cy=H_RAW / 2, baseline=BASELINE)
    sys_ = System(RunConfig(camera=cam, vo=cfg), device=device)
    poses = sys_.run_chunked(list(zip(il, ir)), chunk=chunk)
    tracked = [m for m in sys_.metrics if not m["init"]]
    # run_chunked splits each chunk's wall (from a synchronised start to its
    # outputs on the host) evenly over the chunk's frames.
    timed = tracked[chunk:chunk * n_chunks]
    fps = len(timed) / sum(m["time_s"] for m in timed)
    acc = np.array([m["accept"] for m in tracked])
    trk = np.array([m["n_tracked"] for m in tracked])
    print(f"[bench] gpu {mode}: {len(timed)} timed frames at {fps:.2f} frames/s "
          f"(accept_rate={acc.mean():.2f} over {len(acc)} frames, "
          f"n_tracked_mean={trk.mean():.0f})", file=sys.stderr)
    return {"fps": fps, "poses": poses, "accept": float(acc.mean()),
            "n_tracked": float(trk.mean())}


def row_metrics(res: dict, poses_gt) -> dict:
    """A parity row, as ``bench.main``'s ``metrics``: ATE aligned, RPE,
    accept rate, mean n_tracked, frames/s, rounded as there."""
    ate = trajectory.ate_rmse(res["poses"], poses_gt)
    rpe_t, rpe_r = trajectory.rpe(res["poses"], poses_gt)
    return {"fps": round(res["fps"], 2), "ate_m": round(ate, 4),
            "rpe_t_m": round(rpe_t, 4), "rpe_r_rad": round(rpe_r, 5),
            "accept_rate": round(res["accept"], 3),
            "n_tracked": round(res["n_tracked"], 1)}


def ba_block(passes: dict, n_frames: int) -> dict:
    """``bench.py``'s ``ba`` keys from the BA leg's three passes (label ->
    ``ba_leg.run_pass`` result): ATEs not aligned, the marginalized pass's
    solves and median wall ms per solve (the first solve's wall includes
    warm-up and would dominate a mean), and ``improved``, JAX's test
    ``marg <= frontend-only``."""
    out = {f"ate_{label}_m": round(float(passes[label]["ate"]), 4) for label in ba_leg.PASSES}
    solves = [s["wall_s"] for s in passes["ba_marg"]["solves"]]
    out["n_frames"] = n_frames
    out["n_solves"] = len(solves)
    out["ms_per_solve"] = round(1e3 * float(np.median(solves)), 1) if solves else None
    out["improved"] = bool(out["ate_ba_marg_m"] <= out["ate_frontend_only_m"])
    return out


def run_gpu_ba(device: str = "cuda", n_frames: int | None = None) -> dict:
    """The BA leg (``probes/ba_leg.py``: 120 yaw-heavy frames, persistent
    LK): frontend-only, with marginalization and with drop-oldest, the same
    frames and ``RunConfig.seed=0``; returns ``ba_block``."""
    frames, poses_gt, cam = ba_leg.leg_frames(ba_leg.N_FRAMES if n_frames is None
                                              else n_frames)
    cfg = ba_leg.leg_run_config(cam, seed=0)
    passes = {}
    for label, bcfg in ba_leg.leg_configs():
        r = ba_leg.run_pass(cfg, frames, poses_gt, bcfg, device)
        passes[label] = {"ate": r["ate"], "solves": r["solves"]}
    out = ba_block(passes, len(frames))
    print(f"[bench] gpu ba: frontend ATE={out['ate_frontend_only_m']} vs BA+marg "
          f"{out['ate_ba_marg_m']} vs drop-oldest {out['ate_ba_drop_oldest_m']} "
          f"({out['n_solves']} solves, {out['ms_per_solve']} ms/solve)", file=sys.stderr)
    return out


def run_gpu_parity(il, ir, device: str = "cuda") -> dict:
    """The kernels against their XLA-formulation counterparts on the card,
    on the first bench pair: K2 patches against ``interp.sample_patches``
    (max error < 2e-3), a 3-level LK track on K1 (``dense``) and on K3
    (``cell``) against ``lk._level_track`` (n >= 30 points both keep, median
    disagreement < 0.05 px), and BRIEF bits of K2's patches against a float64
    numpy evaluation (median Hamming 0, flips <= 1e-4 of the bits whose pair
    difference exceeds one grey level). On the CPU the wrappers run their
    plain versions, so there is nothing to check: skipped."""
    from ..ops import fast, interp, lk, orb, patch, pyramid, select

    if torch.device(device).type != "cuda":
        return {"ok": False, "skipped": "no GPU: the kernels run only on the card"}
    i0 = torch.as_tensor(il[0], device=device).to(torch.float32)
    i1 = torch.as_tensor(il[1], device=device).to(torch.float32)
    score = fast.detect(i0, 20.0)
    kp, _, valid = select.grid_top_k(score, 256, cell=32, k_per_cell=2)

    pp = patch.extract_patches(i0, kp, 21)
    px = interp.sample_patches(i0, kp, 21)
    patch_err = float(torch.max(torch.abs(pp - px)))

    p0 = tuple(pyramid.build_pyramid(i0, 4))
    p1 = tuple(pyramid.build_pyramid(i1, 4))
    pts_x, ok_x = lk.track(p0, p1, kp, levels=3, active=valid, use_pallas=False)
    per_kernel = {}
    ok = patch_err < 2e-3
    for kern in ("dense", "cell"):
        pts_p, ok_p = lk.track(p0, p1, kp, levels=3, active=valid, use_pallas=True,
                               pallas_kernel=kern)
        both = (ok_x & ok_p & valid).cpu().numpy()
        n_both = int(both.sum())
        diff = torch.abs(pts_p - pts_x).cpu().numpy()
        flow_med = float(np.median(diff[both])) if n_both else float("nan")
        per_kernel[kern] = {"median_px": round(flow_med, 6), "n": n_both}
        ok = ok and n_both >= 30 and flow_med < 0.05

    blur = pyramid.gaussian_blur(i0)
    patches = patch.extract_patches(blur, kp, orb.DESC_PATCH)
    ang = orb.ic_angle_from_patches(orb._ic_crop(patches))
    bits_gpu = orb.brief_bits_from_patches(patches, ang).cpu().numpy()
    p_np = patches.cpu().numpy().astype(np.float64).reshape(patches.shape[0], -1)
    D_np = orb._bin_diff_np(False).astype(np.float64)
    bins = np.round(np.mod(ang.cpu().numpy().astype(np.float64), 2 * np.pi)
                    / (2 * np.pi) * orb.N_ANGLE_BINS).astype(int) % orb.N_ANGLE_BINS
    diffs_ref = np.einsum("np,nkp->nk", p_np, D_np[bins])
    bits_ref = diffs_ref > 0
    vmask = valid.cpu().numpy()
    ham = np.sum(bits_gpu[vmask] != bits_ref[vmask], axis=1)
    orb_ham = float(np.median(ham))
    meaningful = np.abs(diffs_ref[vmask]) > 1.0
    flips = (bits_gpu[vmask] != bits_ref[vmask]) & meaningful
    ok = ok and orb_ham == 0.0 and flips.sum() <= 1e-4 * meaningful.sum()

    res = {"ok": bool(ok), "patch_max_err_px": round(patch_err, 6),
           "lk_median_disagreement_px": per_kernel["dense"]["median_px"],
           "n_points_compared": per_kernel["dense"]["n"],
           "per_kernel": per_kernel,
           "orb_brief_median_hamming_vs_f64": round(orb_ham, 3)}
    print(f"[bench] gpu kernel parity: {res}", file=sys.stderr)
    return res


def opencv_rows() -> dict:
    """The six cached OpenCV rows (``reference_*`` keys of
    ``BASELINE_MEASURED.json``, schema 2); a missing key raises."""
    cached = json.loads(OPENCV_CACHE.read_text())
    if cached.get("schema") != 2:
        raise ValueError(f"{OPENCV_CACHE.name}: schema {cached.get('schema')}, want 2")
    missing = [k for k in OPENCV_KEYS if k not in cached]
    if missing:
        raise KeyError(f"{OPENCV_CACHE.name} lacks {', '.join(missing)}")
    return {k: cached[k] for k in OPENCV_KEYS}


def card(device: str) -> str:
    """The card's name and power limit (``nvidia-smi``), or 'cpu'."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bench_result(device: str, ba, each_run=lambda name: contextlib.nullcontext(),
                 frames=None) -> dict:
    """``bench.main``'s result dict, with ``device`` and ``opencv_source``.
    ``ba()`` gives the ``ba`` block; each measured run (the parity block,
    each ``gpu_*`` row) runs inside ``each_run(name)``; ``frames``: the clean
    sequence as ``make_frames()`` gives it, if already rendered."""
    il, ir, poses_gt = make_frames() if frames is None else frames
    ref = opencv_rows()
    with each_run("gpu_parity"):
        gpu_parity = run_gpu_parity(il, ir, device)
    gpu = {}
    for mode in MODES:
        with each_run(f"gpu_{mode}"):
            gpu[mode] = row_metrics(run_gpu(il, ir, mode, device), poses_gt)
    parity = {"opencv_lk": ref["reference_lk"], "opencv_orb": ref["reference_orb"],
              "gpu_lk": gpu["lk"], "gpu_orb": gpu["orb"]}
    for var, kw in STRESS_VARIANTS.items():
        il_v, ir_v, gt_v = make_frames(**kw)
        for mode in MODES:
            with each_run(f"gpu_{mode}_{var}"):
                row = row_metrics(run_gpu(il_v, ir_v, mode, device), gt_v)
            parity[f"opencv_{mode}_{var}"] = ref[f"reference_{mode}_{var}"]
            parity[f"gpu_{mode}_{var}"] = row
    ba_out = ba()
    # Headline: the better mode by speed-up, each against its own OpenCV row.
    ratio = {m: gpu[m]["fps"] / ref[f"reference_{m}"]["fps"] for m in MODES}
    best = "orb" if ratio["orb"] >= ratio["lk"] else "lk"
    return {"metric": "vo_frames_per_s", "value": round(gpu[best]["fps"], 3),
            "unit": "frames/s", "vs_baseline": round(ratio[best], 3), "parity": parity,
            "gpu_parity": gpu_parity, "ba": ba_out, "device": card(device),
            "opencv_source": f"{OPENCV_CACHE.name}: OpenCV on an earlier host's CPU, "
                             "cached, not measured in this run"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain versions at a test's size")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on an NVIDIA GPU "
                           "(--device cpu runs the plain versions on the CPU)")
    print(json.dumps(bench_result(args.device, lambda: run_gpu_ba(args.device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
