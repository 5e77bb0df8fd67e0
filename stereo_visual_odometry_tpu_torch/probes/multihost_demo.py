"""Multi-process distributed BA: N worker processes, one group, one solve.

Counterpart of ``scripts/run_multihost_demo.py``: the same seeded BA
problem (``rng(7)``, 6 keyframes, 120 landmarks, 0.3 px noise), split by
landmark over the processes (one device each), solved by
``parallel.dist_ba`` with its all-reduces crossing the processes.

Launcher mode (no ``--proc``): starts ``--nprocs`` workers of this module,
which join one process group through a ``FileStore`` in a fresh temporary
directory (no port, so runs side by side do not collide), and prints
process 0's JSON line: ``processes``, ``devices``, ``ok``,
``cost_initial``, ``cost_final`` and ``max_pose_err``. The workers run on
``--device cuda`` (the default; NCCL, one card per process) or ``cpu``
(gloo).

    python -m stereo_visual_odometry_tpu_torch.probes.multihost_demo --nprocs 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np


def problem(n_global: int):
    """The JAX demo's problem, in its draw order: (cam params, poses_gt,
    pts_gt, the partitioned table, poses_init, points_init)."""
    rng = np.random.default_rng(7)
    n_kf, n_lm = 6, 120
    poses_gt = np.stack([np.eye(4) for _ in range(n_kf)]).astype(np.float32)
    for k in range(n_kf):
        poses_gt[k][:3, 3] = [0.02 * k, -0.01 * k, -0.8 * k]
    pts_gt = np.stack([rng.uniform(-8, 8, n_lm), rng.uniform(-4, 4, n_lm),
                       rng.uniform(8, 40, n_lm)], -1).astype(np.float32)
    obs = []
    for k in range(n_kf):
        pc = pts_gt @ poses_gt[k][:3, :3].T + poses_gt[k][:3, 3]
        uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                       500 * pc[:, 1] / pc[:, 2] + 240], -1)
        for l in range(n_lm):
            if pc[l, 2] > 1:
                obs.append((k, l, uv[l] + rng.normal(size=2) * 0.3))
    m = len(obs)
    obs_kf = np.zeros(m, np.int32)
    obs_lm = np.zeros(m, np.int32)
    obs_uv = np.zeros((m, 2), np.float32)
    obs_w = np.zeros(m, np.float32)
    for i, (k, l, uv) in enumerate(obs):
        obs_kf[i], obs_lm[i], obs_uv[i], obs_w[i] = k, l, uv, 1.0
    from ..parallel import dist_ba

    table = dist_ba.partition_obs_by_landmark(obs_kf, obs_lm, obs_uv, obs_w, n_global)
    poses_init = poses_gt.copy()
    for k in range(1, n_kf):
        poses_init[k][:3, 3] += rng.normal(size=3).astype(np.float32) * 0.05
    points_init = pts_gt + rng.normal(size=pts_gt.shape).astype(np.float32) * 0.2
    return (500.0, 500.0, 320.0, 240.0), poses_gt, pts_gt, table, poses_init, points_init


def worker(args) -> None:
    import torch
    import torch.distributed as dist

    from ..ops.camera import Pinhole
    from ..parallel import dist_ba, multihost

    store = dist.FileStore(os.path.join(args.store, "store"), args.nprocs)
    multihost.initialize(store=store, world_size=args.nprocs, rank=args.proc,
                         backend="nccl" if args.device == "cuda" else "gloo")
    try:
        mesh = multihost.global_mesh(axis="ba")
        dev = multihost.local_device()
        cam_p, poses_gt, _, table, poses_init, points_init = problem(mesh.size)
        shard = table[0].shape[0] // args.nprocs
        lo, hi = args.proc * shard, (args.proc + 1) * shard
        local = [multihost.host_local_array(mesh, "ba", a[lo:hi]) for a in table]
        cam = Pinhole.create(*cam_p, device=dev)
        solve = dist_ba.make_distributed_ba(cam, None, n_kf=poses_gt.shape[0],
                                            n_lm=points_init.shape[0], n_iters=10,
                                            gm_polish=True, device=dev)
        out = solve(multihost.replicated_array(mesh, poses_init),
                    multihost.replicated_array(mesh, points_init), *local)
        poses = out["poses"].cpu().numpy()
        err = float(np.abs(poses - poses_gt).max())
        c0, c1 = float(out["cost_initial"]), float(out["cost_final"])
        if args.proc == 0:
            print(json.dumps({"processes": args.nprocs, "devices": mesh.size,
                              "device": str(dev), "cost_initial": c0, "cost_final": c1,
                              "max_pose_err": err, "ok": bool(err < 0.02 and c1 < c0)}),
                  flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--proc", type=int, default=None, help="(worker mode)")
    ap.add_argument("--store", default=None, help="(worker mode) the FileStore's directory")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.proc is not None:
        worker(args)
        return 0
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.nprocs:
            raise RuntimeError(f"{args.nprocs} processes on cuda need as many GPUs, "
                               f"have {torch.cuda.device_count()}; --device cpu runs on gloo")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", __spec__.name, "--nprocs", str(args.nprocs),
               "--device", args.device, "--store", tmp]
        procs = [subprocess.Popen(cmd + ["--proc", str(i)],
                                  stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL)
                 for i in range(args.nprocs)]
        try:
            out, _ = procs[0].communicate(timeout=args.timeout)
            for p in procs[1:]:
                p.wait(timeout=args.timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    sys.stdout.write(out.decode())
    return 0 if all(p.returncode == 0 for p in procs) else 1


if __name__ == "__main__":
    sys.exit(main())
