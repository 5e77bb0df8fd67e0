"""Command-line runner — the ``run_kitti_stereo`` equivalent.

Port of ``stereo_visual_odometry_tpu/cli.py``, with its arguments and
printed lines, plus ``--device``: the run goes on the card (``cuda``, the
default, which raises without a GPU) unless ``--device cpu`` asks for the
CPU. The reference app takes one argument, a YAML path, builds ``System``
and calls ``Run()`` (``reference/app/run_kitti_stereo.cpp:5-18``). Same
shape here, plus trajectory output, ATE against optional ground truth, and
an offline trajectory plot:

  python -m stereo_visual_odometry_tpu_torch.cli CONFIG.yaml \\
      [--dataset DIR] [--mode lk|orb] [--max-frames N] \\
      [--out traj.txt] [--gt poses.txt] [--plot traj.png] [--device cuda|cpu]

CONFIG.yaml may be a reference-format OpenCV YAML (``config/default.yaml``
schema) or omitted entirely (KITTI defaults). The step's static shape is
sized to the images (``utils/kitti.static_shape_for``: 376x1241 runs at
384x1248).

Every BASELINE.json configuration is runnable from here:
  config 1/2 (single sequence)    default
  config 3 (sliding-window BA)    --ba [--kf-every N --window K]
  offline throughput mode         --chunked N (N frames per host round trip)
  config 4 (multi-sequence batch) --batch DIR1 DIR2 ... [--batch-gt F1 F2 ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", help="reference-format YAML config")
    ap.add_argument("--dataset", default=None, help="KITTI sequence dir")
    ap.add_argument("--mode", choices=["lk", "orb"], default=None)
    ap.add_argument("--max-frames", type=int, default=-1)
    ap.add_argument("--out", default="", help="trajectory output (KITTI format)")
    ap.add_argument("--gt", default="", help="ground-truth poses for ATE/RPE")
    ap.add_argument("--plot", default="", help="trajectory plot output path")
    ap.add_argument("--dump-overlays", default="", metavar="DIR",
                    help="write per-frame association overlays (the "
                         "displayTracking window, offline) into DIR")
    ap.add_argument("--every", type=int, default=10,
                    help="overlay stride (with --dump-overlays)")
    ap.add_argument("--ba", action="store_true",
                    help="sliding-window BA backend (config 3; forces "
                         "persistent tracks)")
    ap.add_argument("--window", type=int, default=6,
                    help="BA keyframe window (with --ba)")
    ap.add_argument("--kf-every", type=int, default=5,
                    help="frames between keyframes (with --ba)")
    ap.add_argument("--chunked", type=int, default=0, metavar="N",
                    help="offline throughput mode: N frames per host round "
                         "trip (incompatible with --ba)")
    ap.add_argument("--batch", nargs="+", default=None, metavar="DIR",
                    help="batched multi-sequence mode (config 4): run all "
                         "sequence dirs concurrently, vmapped")
    ap.add_argument("--batch-gt", nargs="+", default=None, metavar="FILE",
                    help="per-sequence ground-truth pose files (with --batch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    if args.ba and args.chunked:
        ap.error("--ba needs per-frame host bookkeeping; drop --chunked")

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLI runs on an NVIDIA GPU "
                           "(--device cpu runs it on the CPU)")

    from .utils.config import RunConfig, load_reference_yaml
    from .utils import trajectory as traj_mod
    from .models.system import System

    cfg = load_reference_yaml(args.config) if args.config else RunConfig()
    if args.dataset:
        cfg = dataclasses.replace(cfg, dataset_dir=args.dataset)
    if args.mode:
        cfg = dataclasses.replace(cfg, vo=dataclasses.replace(cfg.vo, mode=args.mode))
    cfg = dataclasses.replace(cfg, max_frames=args.max_frames,
                              trajectory_out=args.out,
                              overlay_dir=args.dump_overlays,
                              overlay_every=args.every)

    if args.batch:
        return _run_batch(args, cfg)

    if not cfg.dataset_dir:
        ap.error("no dataset: pass --dataset or set dataset_dir in the YAML")

    # Size the static shapes to the actual images.
    from .utils.kitti import KittiStereoDataset

    probe = KittiStereoDataset(cfg.dataset_dir)
    H, W = probe.static_hw
    cfg = dataclasses.replace(cfg, vo=dataclasses.replace(cfg.vo, height=H, width=W))

    backend_cfg = None
    if args.ba:
        from .models.backend import BackendConfig

        cfg = dataclasses.replace(
            cfg, vo=dataclasses.replace(cfg.vo, persistent_tracks=True))
        backend_cfg = BackendConfig(window=args.window, kf_every=args.kf_every)

    system = System(cfg, device=args.device, backend_cfg=backend_cfg)
    if args.chunked:
        ds = KittiStereoDataset(cfg.dataset_dir,
                                static_hw=(cfg.vo.height, cfg.vo.width))
        traj = system.run_chunked(ds.iter_prefetch(), chunk=args.chunked,
                                  max_frames=cfg.max_frames)
    else:
        traj = system.run_kitti()
    s = system.summary()
    print(f"frames={s['frames']} fps={s['fps']:.2f} "
          f"accept_rate={s['accept_rate']:.2%}")
    if args.ba and system.backend is not None:
        ba_runs = [m["ba"] for m in system.metrics if "ba" in m]
        print(f"ba: {len(ba_runs)} window solves, "
              f"{len(system.backend.kf_poses)} keyframes live")

    gt = traj_mod.load_kitti(args.gt) if args.gt else None
    if gt is not None:
        n = min(len(gt), len(traj))
        ate = traj_mod.ate_rmse(traj[:n], gt[:n])
        t_rpe, r_rpe = traj_mod.rpe(traj[:n], gt[:n])
        print(f"ATE={ate:.3f}m RPE_t={t_rpe:.4f}m RPE_r={r_rpe:.5f}rad")
    if args.plot:
        from .utils.viz import plot_trajectory

        plot_trajectory(args.plot, traj, gt)
        print(f"wrote {args.plot}")
    return 0


def _run_batch(args, cfg) -> int:
    """Config 4: all sequence dirs concurrently through the streaming
    batch evaluator (``parallel/evaluate.py``), per-sequence ATE."""
    from .utils.config import rig_from_config
    from .utils.kitti import KittiStereoDataset
    from .parallel.evaluate import evaluate_kitti_dirs

    if args.batch_gt and len(args.batch_gt) != len(args.batch):
        raise SystemExit("--batch-gt needs one file per --batch dir")
    probe = KittiStereoDataset(args.batch[0])
    H, W = probe.static_hw
    vo = dataclasses.replace(cfg.vo, height=H, width=W)
    rig = rig_from_config(cfg.camera, device=args.device)
    out = evaluate_kitti_dirs(args.batch, vo, rig,
                              chunk=args.chunked or 8,
                              gt_files=args.batch_gt, device=args.device)
    print(f"sequences={len(args.batch)} "
          f"frames_per_s={out['frames_per_s']:.1f} wall={out['wall_s']:.1f}s")
    for s, d in enumerate(args.batch):
        line = (f"  [{s}] {d}: frames={len(out['trajectories'][s])} "
                f"accept_rate={out['accept_rate'][s]:.2%}")
        if "ate" in out:
            line += f" ATE={out['ate'][s]:.3f}m"
        print(line)
    if args.out:
        from .utils import trajectory as traj_mod

        for s in range(len(args.batch)):
            traj_mod.save_kitti(f"{args.out}.{s:02d}", out["trajectories"][s])
        print(f"wrote {args.out}.NN per sequence")
    return 0


if __name__ == "__main__":
    sys.exit(main())
