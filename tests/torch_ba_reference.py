"""Reference numbers for the BA backend: the JAX package and the port on the
CPU, frontend-only against the backend with and without marginalization.

    JAX_PLATFORMS=cpu python tests/torch_ba_reference.py CASE [jax|port_xla|port_dense] [SEED]

CASE ``drifty``: the drift sequence of the JAX package's own
``tests/test_backend.py::test_ba_improves_drifty_trajectory``: 100 frames
at 256x320 (fx 300, 14000 landmarks, 1 m/frame, yaw rate 0.008, seed 11,
cloud (40, 8, 180) m), LK at 256 features with persistent tracks,
``BackendConfig(window=6, kf_every=3, max_landmarks=512, max_obs=4096)``.
``jax`` is the JAX ``System`` as that test runs it on the CPU (its default
tracker there, the XLA formulation); ``port_xla`` the port with
``lk_backend='xla'``, the same tracker; ``port_dense`` the port's default.

CASE ``orb_bench``: ORB with persistent tracks on the 49 bench frames
(``probes/lk_timing.bench_sequence``: 376x1241 padded to 384x1280, 2048
features) with ``BackendConfig(window=6, kf_every=4)``, the path of
``tests/test_torch_cuda.py::test_ba_leg_on_the_card[orb]`` that the JAX
bench never ran (``jax`` or ``port_dense``).

CASE ``cli_ba``: what ``tests/test_torch_cuda.py::
test_cli_at_kitti_shape_counts_k1[ba]`` hands the command line with ``--ba
--window 6 --kf-every 4``: the 49 bench frames as 8-bit PNGs
(376x1241, truncated to uint8) edge-padded to the CLI's 384x1248, LK at
1024 features with persistent tracks (``--ba`` forces them),
frontend-only and ``BackendConfig(window=6, kf_every=4)``; ``jax`` is the
JAX CLI's path on the CPU (its default tracker there, the XLA
formulation).

CASE ``lk_bench``: LK on the bench scene of ``test_path_on_the_bench_sequence``
(seed 3, 9000 landmarks, 1.1 m/frame, 49 frames) at half resolution
(188x620 padded to 192x640, fx 359.428, 512 features: a full-size run is a
job for the card, not for a shared CPU), frontend-only, without and with
persistent tracks: ``jax`` (its CPU default tracker, the XLA formulation),
``port_xla`` (the same tracker) or ``port_dense``. The port's dense tracker
on the card loses ATE with the tracks at full size (PERF.md section 6); this
says whether the JAX package does too.

Each package draws its own RANSAC samples, from ``RunConfig.seed`` (SEED,
default 0). Prints one JSON line: per pass
the ATE not aligned (as the JAX tests and bench) and aligned.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stereo_visual_odometry_tpu_torch.utils import synthetic, trajectory  # noqa: E402


def _modules(which):
    if which == "jax":
        from stereo_visual_odometry_tpu.models.backend import BackendConfig
        from stereo_visual_odometry_tpu.models.frontend import VOConfig
        from stereo_visual_odometry_tpu.models.system import System
        from stereo_visual_odometry_tpu.utils.config import CameraConfig, RunConfig
        return BackendConfig, VOConfig, System, CameraConfig, RunConfig, {}
    from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
    from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
    from stereo_visual_odometry_tpu_torch.models.system import System
    from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig
    return BackendConfig, VOConfig, System, CameraConfig, RunConfig, {"device": "cpu"}


def main(case: str, which: str, seed: int = 0) -> None:
    BackendConfig, VOConfig, System, CameraConfig, RunConfig, kw = _modules(which)
    if case == "drifty":
        seq = synthetic.render_sequence(n_frames=100, h=256, w=320, fx=300.0, speed=1.0,
                                        n_points=14000, yaw_rate=0.008, seed=11,
                                        cloud_extent=(40.0, 8.0, 180.0))
        rp = seq["rig"]
        cam = CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"],
                           baseline=rp["baseline"])
        frames = list(zip(seq["images_l"], seq["images_r"]))
        vo = VOConfig(mode="lk", height=256, width=320, max_features=256,
                      num_hypotheses=128, min_features_track=8, min_inlier_rate=0.3,
                      persistent_tracks=True,
                      lk_backend="xla" if which == "port_xla" else "auto")
        window = dict(window=6, kf_every=3, max_landmarks=512, max_obs=4096)
    elif case == "lk_bench":
        h, w, fx = 188, 620, 718.856 / 2
        seq = synthetic.render_sequence(n_frames=49, h=h, w=w, fx=fx, baseline=0.537,
                                        n_points=9000, speed=1.1, seed=3)
        pad = lambda a: np.pad(a, ((0, 0), (0, 192 - h), (0, 640 - w)), mode="edge")
        frames = list(zip(pad(seq["images_l"]), pad(seq["images_r"])))
        cam = CameraConfig(fx=fx, fy=fx, cx=w / 2, cy=h / 2, baseline=0.537)
        lk = dict(height=192, width=640, max_features=512,
                  lk_backend="xla" if which == "port_xla" else "auto")
        passes = [(label, VOConfig(persistent_tracks=on, **lk), None)
                  for label, on in (("tracks_off", False), ("tracks_on", True))]
    elif case == "cli_ba":
        seq = synthetic.render_sequence(n_frames=49, h=376, w=1241, fx=718.856,
                                        baseline=0.537, n_points=9000, speed=1.1, seed=3)
        pad = lambda a: np.pad(a.astype(np.uint8), ((0, 0), (0, 8), (0, 7)), mode="edge")
        frames = list(zip(pad(seq["images_l"]), pad(seq["images_r"])))
        cam = CameraConfig(fx=718.856, fy=718.856, cx=1241 / 2, cy=376 / 2, baseline=0.537)
        vo = VOConfig(height=384, width=1248, persistent_tracks=True,
                      lk_backend="xla" if which == "port_xla" else "auto")
        passes = [("frontend_only", vo, None),
                  ("ba_marg", vo, BackendConfig(window=6, kf_every=4))]
    else:
        seq = synthetic.render_sequence(n_frames=49, h=376, w=1241, fx=718.856,
                                        baseline=0.537, n_points=9000, speed=1.1, seed=3)
        pad = lambda a: np.pad(a, ((0, 0), (0, 8), (0, 39)), mode="edge")
        frames = list(zip(pad(seq["images_l"]), pad(seq["images_r"])))
        cam = CameraConfig(fx=718.856, fy=718.856, cx=1241 / 2, cy=376 / 2, baseline=0.537)
        vo = VOConfig(mode="orb", height=384, width=1280, max_features=2048,
                      persistent_tracks=True)
        window = dict(window=6, kf_every=4)
    if case in ("drifty", "orb_bench"):
        passes = [(label, vo, bcfg) for label, bcfg in (
            ("frontend_only", None), ("ba_marg", BackendConfig(**window)),
            ("ba_drop_oldest", BackendConfig(**window, marginalize=False)))]
    out = {}
    for label, vo, bcfg in passes:
        sys_ = System(RunConfig(camera=cam, vo=vo, seed=seed), backend_cfg=bcfg, **kw)
        traj = sys_.run(frames)
        out[label] = {"ate": trajectory.ate_rmse(traj, seq["poses_gt"], align=False),
                      "ate_aligned": trajectory.ate_rmse(traj, seq["poses_gt"]),
                      "solves": sum("ba" in m for m in sys_.metrics)}
    print(json.dumps({case: {which: out, "seed": seed}}))


if __name__ == "__main__":
    torch.set_num_threads(3)
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "port_dense",
         int(sys.argv[3]) if len(sys.argv) > 3 else 0)
