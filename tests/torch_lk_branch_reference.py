"""Reference numbers for the kernel-free LK branches on the bench sequence
(``tests/test_torch_cuda.py::test_path_on_the_bench_sequence``, cases
``xla``, ``no_sweep`` and ``not_predictive``): the JAX package and the port
on the CPU, at half the bench resolution.

    JAX_PLATFORMS=cpu python tests/torch_lk_branch_reference.py

The bench sequence's generator (``bench.py:31-49``: seed 3, 9000
landmarks, 1.1 m/frame) at 188x620 edge-padded to 192x640, fx halved to
359.428, 512 features, 16 frames: half the width and height of the chip
run, so the CPU run stays small. The JAX ``System`` runs
``lk_backend='xla'`` as itself and the two prior branches on its dense path
with K1 in Pallas interpret mode (``torch_jax_kernels.jax_pallas_kernels``);
the port runs the plain versions. Prints, per branch, the ATE over all
frames, the ATE over frames 1.. (aligned after the first step: without the
sweep the first step has no prior and both packages reject it, which
leaves one frame's motion out of the chain) and the accept rate.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from stereo_visual_odometry_tpu.models.frontend import VOConfig as JVOConfig  # noqa: E402
from stereo_visual_odometry_tpu.models.system import System as JSystem  # noqa: E402
from stereo_visual_odometry_tpu.utils.config import CameraConfig as JCamera  # noqa: E402
from stereo_visual_odometry_tpu.utils.config import RunConfig as JRunConfig  # noqa: E402
from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig  # noqa: E402
from stereo_visual_odometry_tpu_torch.models.system import System  # noqa: E402
from stereo_visual_odometry_tpu_torch.utils import synthetic, trajectory  # noqa: E402
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig  # noqa: E402
from torch_jax_kernels import jax_pallas_kernels  # noqa: E402

H_RAW, W_RAW, H, W, FX, BASELINE = 188, 620, 192, 640, 718.856 / 2, 0.537
N_FRAMES, FEATURES = 16, 512
BRANCHES = [dict(lk_backend="xla"), dict(lk_sweep=False), dict(lk_predictive=False)]


def main() -> None:
    seq = synthetic.render_sequence(n_frames=N_FRAMES, h=H_RAW, w=W_RAW, fx=FX,
                                    baseline=BASELINE, n_points=9000, speed=1.1, seed=3)
    pad = lambda a: np.pad(a, ((0, 0), (0, H - H_RAW), (0, W - W_RAW)), mode="edge")
    frames = list(zip(pad(seq["images_l"]), pad(seq["images_r"])))
    gt = seq["poses_gt"]
    cam = dict(fx=FX, fy=FX, cx=W_RAW / 2, cy=H_RAW / 2, baseline=BASELINE)
    vo = dict(height=H, width=W, max_features=FEATURES)

    def summary(sys_, traj):
        acc = [m["accept"] for m in sys_.metrics if not m.get("init")]
        return (f"ATE {trajectory.ate_rmse(traj, gt):.4f} m, from frame 1 "
                f"{trajectory.ate_rmse(traj[1:], gt[1:]):.4f} m, accept "
                f"{np.mean(acc):.3f} (first step {acc[0]})")

    for kw in BRANCHES:
        jkw = dict(kw)
        jkw.setdefault("lk_backend", "pallas")
        with jax_pallas_kernels():
            j_sys = JSystem(JRunConfig(camera=JCamera(**cam), vo=JVOConfig(**vo, **jkw)))
            j_traj = j_sys.run(frames)
        t_sys = System(RunConfig(camera=CameraConfig(**cam), vo=VOConfig(**vo, **kw)),
                       device="cpu")
        t_traj = t_sys.run_chunked(frames, chunk=8)
        print(f"{kw}: JAX {summary(j_sys, j_traj)}; port {summary(t_sys, t_traj)}",
              flush=True)


if __name__ == "__main__":
    main()
