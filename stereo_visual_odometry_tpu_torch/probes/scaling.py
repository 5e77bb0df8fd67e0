"""Probe: throughput against the number of devices, on both parallel axes.

Port of ``scripts/measure_scaling.py`` (BASELINE.json target #3). Weak
scaling: the work per device stays constant while the device count grows,
so the ideal wall time is flat and efficiency(n) = t(1) / t(n).

* ``seq_sharding`` (config 4): n sequences, one per device, at 192x256 with
  the script's ``VOConfig`` (LK, 256 features, 128 hypotheses), over a
  ``seq`` mesh of n in this process (``parallel/sequences.py``): each
  shard's batched step replayed from its own graph, frame by frame, every
  shard's frame queued before the next frame. One rep is one chunk of
  ``--frames - 1`` frames from the same initial state.
* ``dist_ba`` (config 5): the script's BA problem (``rng(7)``, 8 keyframes,
  512 landmarks, ``--obs-per-device`` x n observations, in its draw
  order), split by landmark over n processes of one ``torch.distributed``
  group (``parallel/dist_ba.py``, 6 iterations, no polish): NCCL on
  ``cuda``, one card per process; gloo on ``cpu``. The processes join
  through a ``FileStore`` in a temporary directory, as
  ``probes/multihost_demo.py``'s do.

On ``cuda`` (the default) n above ``torch.cuda.device_count()`` raises, on
either axis: the mesh takes one card per shard here, and NCCL one card per
rank; nothing falls back to gloo or to the CPU. On ``cpu`` a mesh of n is n
shards of the CPU and the BA axis n gloo processes, all sharing the host's
cores: the numbers then bound the overhead of the split, not a speed-up.

    python -m stereo_visual_odometry_tpu_torch.probes.scaling --devices 1 2 4
    python -m stereo_visual_odometry_tpu_torch.probes.scaling --platform cpu --devices 1 2

Prints one JSON line in SCALING.json's schema (``platform``,
``host_cores``, ``note``, ``seq_sharding``, ``dist_ba``), with ``device``:
each card's name and power limit by ``nvidia-smi`` (or ``cpu``). It writes
no file: SCALING.json holds the JAX package's numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PKG_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds the package
H, W, FX = 192, 256, 300.0
N_KF, N_LM = 8, 512
WORKER_TIMEOUT_S = 600.0  # a BA worker's start, NCCL's set-up and the solves
NOTE = ("weak scaling: per-device work constant; ideal t(n) flat, eff = t(1)/t(n). On cpu "
        "the shards and processes share the host's cores: an overhead bound, not a speed-up.")


def cards(platform: str) -> list[str]:
    """Each card's name and power limit (``nvidia-smi``), or ['cpu']."""
    if platform != "cuda":
        return ["cpu"]
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()


def sync(devices) -> None:
    import torch
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def timed(fn, reps: int, devices) -> float:
    """Seconds per call of ``fn`` over ``reps`` calls after one warm call
    (the kernels' build, the graphs' capture), all devices idle at both
    ends."""
    fn()
    sync(devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(devices)
    return (time.perf_counter() - t0) / reps


def seq_axis(devices: list[int], platform: str, frames: int, reps: int) -> list[dict]:
    """The ``seq_sharding`` rows: n sequences over a mesh of n, per n."""
    import torch

    from ..models.frontend import VOConfig
    from ..parallel import sequences
    from ..parallel.mesh import make_mesh
    from ..utils import synthetic
    from ..utils.config import CameraConfig, rig_from_config

    seqs = [synthetic.render_sequence(n_frames=frames, h=H, w=W, fx=FX, speed=1.0, seed=s)
            for s in range(max(devices))]
    il = np.stack([s["images_l"] for s in seqs]).astype(np.float32)
    ir = np.stack([s["images_r"] for s in seqs]).astype(np.float32)
    rp = seqs[0]["rig"]
    cam = CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"],
                       baseline=rp["baseline"])
    cfg = VOConfig(mode="lk", height=H, width=W, max_features=256, num_hypotheses=128,
                   min_features_track=8)
    rows, base = [], None
    for n in devices:
        mesh = make_mesh(n, axis="seq", platform=platform)
        rig = rig_from_config(cam, device=mesh.devices[0])
        init_fn, step_fn, place = sequences.make_batched_frontend(cfg, rig, mesh)
        state = init_fn(place(il[:n, 0]), place(ir[:n, 0]))
        l, r = place(il[:n, 1:]), place(ir[:n, 1:])
        gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
        u = torch.rand(n, frames - 1, cfg.num_hypotheses, 6, generator=gen,
                       device=mesh.devices[0])
        out = {}

        def run():
            out["m"] = sequences.run_chunk_scan(step_fn, state, l, r, u)[1]

        t = timed(run, reps, mesh.devices)
        base = base or t
        accept = sequences.gather(out["m"], ("accept",), axis=1)["accept"]
        rows.append({"devices": n, "mesh": [str(d) for d in mesh.devices], "wall_s": t,
                     "frames_per_s": n * (frames - 1) / t, "weak_efficiency": base / t,
                     "accept_rate": float(accept.mean())})
        print(f"[seq] n={n}: {t * 1e3:.1f} ms/chunk {rows[-1]['frames_per_s']:.1f} "
              f"frames/s eff={base / t:.3f}", file=sys.stderr, flush=True)
        del init_fn, step_fn, place, state, l, r, u, out
        if platform == "cuda":
            torch.cuda.empty_cache()
    return rows


def ba_problems(devices: list[int], obs_per_device: int):
    """Per n of ``devices``, in order, the script's problem: (poses_init,
    points_init, obs_kf, obs_lm, obs_uv, obs_w), drawn from one
    ``rng(7)`` in the script's order (each n's draws follow the last's)."""
    rng = np.random.default_rng(7)
    poses_gt = np.stack([np.eye(4)] * N_KF).astype(np.float32)
    for k in range(N_KF):
        poses_gt[k][:3, 3] = [0.02 * k, -0.01 * k, -0.8 * k]
    pts_gt = np.stack([rng.uniform(-8, 8, N_LM), rng.uniform(-4, 4, N_LM),
                       rng.uniform(8, 40, N_LM)], -1).astype(np.float32)
    for n in devices:
        m_obs = obs_per_device * n
        kf = rng.integers(0, N_KF, m_obs).astype(np.int32)
        lm = rng.integers(0, N_LM, m_obs).astype(np.int32)
        pc = np.einsum("mij,mj->mi", poses_gt[kf][:, :3, :3], pts_gt[lm]) \
            + poses_gt[kf][:, :3, 3]
        uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                       500 * pc[:, 1] / pc[:, 2] + 240], -1).astype(np.float32)
        wgt = (pc[:, 2] > 1).astype(np.float32)
        poses_init = poses_gt.copy()
        poses_init[1:, :3, 3] += rng.normal(size=(N_KF - 1, 3)).astype(np.float32) * 0.05
        pts_init = pts_gt + rng.normal(size=pts_gt.shape).astype(np.float32) * 0.2
        yield poses_init, pts_init, kf, lm, uv, wgt


def ba_worker(args) -> None:
    """One rank of the BA axis at ``args.nprocs`` processes: its landmark
    shard of problem ``args.index``, timed solves; rank 0 prints a JSON
    line."""
    import torch
    import torch.distributed as dist

    from ..ops.camera import Pinhole
    from ..parallel import dist_ba, multihost

    n, rank = args.nprocs, args.proc
    if args.platform == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    store = dist.FileStore(os.path.join(args.store, "store"), n)
    multihost.initialize(store=store, world_size=n, rank=rank,
                         backend="nccl" if args.platform == "cuda" else "gloo")
    try:
        dev = multihost.local_device()
        problems = ba_problems(args.devices, args.obs_per_device)
        poses, points, kf, lm, uv, w = next(p for i, p in enumerate(problems)
                                            if i == args.index)
        table = dist_ba.partition_obs_by_landmark(kf, lm, uv, w, n)
        cap = table[0].shape[0] // n
        local = [torch.as_tensor(a[rank * cap:(rank + 1) * cap], device=dev) for a in table]
        cam = Pinhole.create(500.0, 500.0, 320.0, 240.0, device=dev)
        solve = dist_ba.make_distributed_ba(cam, None, n_kf=N_KF, n_lm=N_LM, n_iters=6,
                                            gm_polish=False, device=dev)
        p0, x0 = torch.as_tensor(poses, device=dev), torch.as_tensor(points, device=dev)
        out = {}

        def run():
            out.update(solve(p0, x0, *local))
            float(out["cost_final"])  # waits for the solve

        dist.barrier()
        t = timed(run, args.reps, [dev])
        if rank == 0:
            print(json.dumps({"wall_s": t, "cost_initial": float(out["cost_initial"]),
                              "cost_final": float(out["cost_final"]),
                              "backend": dist.get_backend()}), flush=True)
    finally:
        dist.destroy_process_group()


def ba_axis(args) -> list[dict]:
    """The ``dist_ba`` rows: per n, n worker processes of this module."""
    rows, base = [], None
    for index, n in enumerate(args.devices):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", __spec__.name, "--platform", args.platform,
                   "--obs-per-device", str(args.obs_per_device), "--reps", str(args.reps),
                   "--devices", *map(str, args.devices), "--store", tmp, "--index",
                   str(index), "--nprocs", str(n)]
            procs = [subprocess.Popen(cmd + ["--proc", str(i)], cwd=PKG_ROOT,
                                      stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL)
                     for i in range(n)]
            try:
                out, _ = procs[0].communicate(timeout=WORKER_TIMEOUT_S)
                for p in procs[1:]:
                    p.wait(timeout=WORKER_TIMEOUT_S)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"a BA worker at n={n} failed: exit codes "
                               f"{[p.returncode for p in procs]}")
        got = json.loads(out.decode().strip().splitlines()[-1])
        m_obs = args.obs_per_device * n
        t = got.pop("wall_s")
        base = base or t
        rows.append({"devices": n, "obs": m_obs, "wall_s": t, "obs_per_s": m_obs / t,
                     "weak_efficiency": base / t, **got})
        print(f"[ba]  n={n}: {t * 1e3:.1f} ms/solve ({m_obs} obs) eff={base / t:.3f}",
              file=sys.stderr, flush=True)
    return rows


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--obs-per-device", type=int, default=8192)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--proc", type=int, default=None, help="(BA worker mode) rank")
    ap.add_argument("--nprocs", type=int, default=None, help="(BA worker mode)")
    ap.add_argument("--index", type=int, default=None, help="(BA worker mode) problem")
    ap.add_argument("--store", default=None, help="(BA worker mode) the FileStore's directory")
    return ap.parse_args(argv)


def measure(args: argparse.Namespace) -> dict:
    """The JSON result of both axes for ``args`` (``parse``'s)."""
    if args.platform == "cuda":
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if max(args.devices) > have:
            raise ValueError(f"--devices {max(args.devices)} on cuda needs as many GPUs (one "
                             f"per shard, one per NCCL rank), have {have}; --platform cpu "
                             "runs on CPU shards and gloo")
    result = {"platform": args.platform, "host_cores": os.cpu_count(), "note": NOTE,
              "device": cards(args.platform),
              "seq_sharding": seq_axis(args.devices, args.platform, args.frames, args.reps)}
    result["dist_ba"] = ba_axis(args)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    if args.proc is not None:
        ba_worker(args)
    else:
        print(json.dumps(measure(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
