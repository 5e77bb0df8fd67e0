"""One rank of a distributed BA solve on gloo, for ``test_torch_dist_ba.py``.

    python tests/torch_dist_worker.py PROBLEM.npz STORE_DIR RANK WORLD

Reads the problem (landmark-coherent shards from
``dist_ba.partition_obs_by_landmark`` and the solve's options), joins the
group through a ``FileStore`` in STORE_DIR, solves its shard with
``dist_ba.make_distributed_ba`` on the CPU, and (rank 0) writes the
replicated result and every rank's weights to STORE_DIR/out.npz. Imports
neither JAX nor the JAX package.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stereo_visual_odometry_tpu_torch.ops.camera import Pinhole  # noqa: E402
from stereo_visual_odometry_tpu_torch.parallel import dist_ba, multihost  # noqa: E402


def main(problem: str, store_dir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    p = dict(np.load(problem))
    multihost.initialize(store=dist.FileStore(str(Path(store_dir) / "store"), world),
                         world_size=world, rank=rank, backend="gloo")
    try:
        cap = len(p["obs_kf"]) // world
        rows = slice(rank * cap, (rank + 1) * cap)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        stereo = "obs_right" in p
        solve = dist_ba.make_distributed_ba(
            Pinhole.create(*p["cam"].tolist(), device="cpu"), None, n_kf=len(p["poses"]),
            n_lm=len(p["points"]), n_iters=int(p["n_iters"]), gm_polish=bool(p["gm_polish"]),
            prune_px=None if p["prune_px"] < 0 else float(p["prune_px"]), use_stereo=stereo,
            device="cpu")
        out = solve(t(p["poses"]), t(p["points"]),
                    *(t(p[k][rows]) for k in ("obs_kf", "obs_lm", "obs_uv", "obs_w")),
                    obs_right=t(p["obs_right"][rows]) if stereo else None,
                    T_rl=t(p["T_rl"]) if stereo else None)
        weights = [torch.empty_like(out["obs_w"]) for _ in range(world)]
        dist.all_gather(weights, out["obs_w"])
        if rank == 0:
            np.savez(Path(store_dir) / "out.npz", obs_w=torch.cat(weights).numpy(),
                     **{k: out[k].numpy() for k in ("poses", "points", "cost_initial",
                                                    "cost_final")})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
