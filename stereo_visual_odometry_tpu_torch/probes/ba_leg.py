"""Probe: the JAX bench's BA leg (``bench.py:304-353``) through the port's
``System``, over RANSAC seeds or with draws given from a file.

Each run drives ``System.run`` three times on the leg's 120 frames (a
yaw-heavy KITTI-shaped drift scene, seed 11, 376x1241 edge-padded to
384x1280; LK at 1024 features with persistent tracks): frontend-only, with
``BackendConfig(window=6, kf_every=4)`` and with ``marginalize=False``, and
reports each ATE (not aligned, as the JAX leg), the solves and the wall ms
per solve. The three passes of a run share their RANSAC draws: the
``System``'s generator from ``RunConfig.seed``, or, with ``--draws``, an
(n_frames - 1, num_hypotheses, 6) float32 array of uniforms fed to the
steps in order (the JAX reference's, written by the JAX package's own key
stream: ``tests/torch_jax_kernels.jax_draws(119, 256)``).

    python -m stereo_visual_odometry_tpu_torch.probes.ba_leg --seeds 0 1 2 3
    python -m stereo_visual_odometry_tpu_torch.probes.ba_leg --draws FILE.npy

One JSON line per run, then a summary line. Runs on the card by default.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

H_RAW, W_RAW, H, W = 376, 1241, 384, 1280
FX, BASELINE, N_FRAMES, FEATURES = 718.856, 0.537, 120, 1024
PASSES = ("frontend_only", "ba_marg", "ba_drop_oldest")


def leg_frames(n_frames: int = N_FRAMES):
    """The leg's stereo pairs (numpy, edge-padded to (H, W)), true poses
    and camera."""
    from ..utils import synthetic
    from ..utils.config import CameraConfig
    seq = synthetic.render_sequence(n_frames=n_frames, h=H_RAW, w=W_RAW, fx=FX,
                                    baseline=BASELINE, n_points=20000, speed=1.1, seed=11,
                                    yaw_rate=0.01, cloud_extent=(40.0, 8.0, 260.0))
    pad = lambda a: np.pad(a, ((0, 0), (0, H - H_RAW), (0, W - W_RAW)), mode="edge")
    cam = CameraConfig(fx=FX, fy=FX, cx=W_RAW / 2, cy=H_RAW / 2, baseline=BASELINE)
    return list(zip(pad(seq["images_l"]), pad(seq["images_r"]))), seq["poses_gt"], cam


def leg_configs():
    """(label, BackendConfig or None) of the leg's three passes."""
    from ..models.backend import BackendConfig
    return list(zip(PASSES, (None, BackendConfig(window=6, kf_every=4),
                             BackendConfig(window=6, kf_every=4, marginalize=False))))


def leg_run_config(cam, seed: int = 0):
    """The leg's ``RunConfig``: LK at 1024 features with persistent tracks
    (``min_features_track=8``), ``seed`` for the RANSAC generator."""
    from ..models.frontend import VOConfig
    from ..utils.config import RunConfig
    vo = VOConfig(mode="lk", height=H, width=W, max_features=FEATURES, min_features_track=8,
                  persistent_tracks=True)
    return RunConfig(camera=cam, vo=vo, seed=seed)


def run_pass(cfg, frames, poses_gt, backend_cfg, device, draws=None, align=False) -> dict:
    """One ``System.run``: ATE, accept rate, the solves' result dicts, the
    median ms of the frames without a solve, and the ``System``. ``draws``:
    the steps' RANSAC uniforms in order, in place of the generator's."""
    from ..models.system import System
    from ..ops import pnp
    from ..utils import trajectory
    sys_ = System(cfg, device=device, backend_cfg=backend_cfg)
    orig = pnp.draw_uniforms
    if draws is not None:
        queue = [torch.from_numpy(u).to(device) for u in draws]
        pnp.draw_uniforms = lambda *a, **kw: queue.pop(0)
    try:
        traj = sys_.run(frames)
    finally:
        pnp.draw_uniforms = orig
    tracked = [m for m in sys_.metrics if not m["init"]]
    plain = [m["time_s"] for m in tracked[1:] if "ba" not in m]
    return {"ate": trajectory.ate_rmse(traj, poses_gt, align=align), "traj": traj,
            "accept": float(np.mean([m["accept"] for m in tracked])),
            "solves": [m["ba"] for m in tracked if "ba" in m],
            "ms_frame": 1e3 * float(np.median(plain)), "system": sys_}


def run_leg(frames, poses_gt, cam, device, seed: int = 0, draws=None) -> dict:
    """The three passes with one seed (or the given draws): per pass the ATE,
    accept, solves and median / max wall ms per solve."""
    cfg = leg_run_config(cam, seed)
    out = {}
    for label, bcfg in leg_configs():
        r = run_pass(cfg, frames, poses_gt, bcfg, device, draws)
        walls = [1e3 * s["wall_s"] for s in r["solves"]]
        out[label] = {"ate": r["ate"], "accept": r["accept"], "n_solves": len(walls),
                      "ms_per_solve_median": float(np.median(walls)) if walls else None,
                      "ms_per_solve_max": max(walls, default=None)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0],
                    help="RunConfig.seed of each run (the System's RANSAC generator)")
    ap.add_argument("--draws", default=None,
                    help="a .npy of (frames - 1, 256, 6) uniforms: one more run with them")
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe runs on an NVIDIA GPU "
                           "(--device cpu runs it on the CPU)")
    frames, poses_gt, cam = leg_frames(args.frames)
    runs = [(f"seed {s}", dict(seed=s)) for s in args.seeds]
    if args.draws:
        runs.append((f"draws {args.draws}", dict(draws=np.load(args.draws)[:len(frames) - 1])))
    ratios = []
    for name, kw in runs:
        leg = run_leg(frames, poses_gt, cam, args.device, **kw)
        ratios.append(leg["ba_marg"]["ate"] / leg["frontend_only"]["ate"])
        print(json.dumps({"run": name, **leg}), flush=True)
    print(json.dumps({"runs": len(runs), "marg_over_frontend_only": ratios,
                      "device": torch.cuda.get_device_name(0) if args.device != "cpu"
                      else "cpu"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
