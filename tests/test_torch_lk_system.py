"""The slice as a whole on K3 and K4: the port's ``System`` with
``lk_kernel='cell'`` and ``'v1'`` against the JAX ``System`` over one
synthetic sequence (6 frames, 192x256, 256 features).

The JAX ``System`` runs ``lk_backend='pallas'`` with its kernels in Pallas
interpret mode (``torch_jax_kernels.jax_pallas_kernels``; its CPU
``'auto'`` would take the XLA tracker); the port runs the plain versions
(CPU tensors) with the JAX RANSAC draws injected. Tolerances: accept flags
equal, poses within 1e-3 m and 1e-4 rad (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import frontend as jfront
from stereo_visual_odometry_tpu.models.system import System as JSystem
from stereo_visual_odometry_tpu.utils.config import CameraConfig as JCamera
from stereo_visual_odometry_tpu.utils.config import RunConfig as JRunConfig
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.ops import pnp as tpnp
from stereo_visual_odometry_tpu_torch.utils import synthetic
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig
from torch_jax_kernels import jax_draws, jax_pallas_kernels

H, W, FX = 192, 256, 300.0
SMALL = dict(height=H, width=W, max_features=256, num_hypotheses=128,
             min_features_track=8, min_inlier_rate=0.3)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq6():
    return synthetic.render_sequence(n_frames=6, h=H, w=W, fx=FX)


def _cam(seq):
    rp = seq["rig"]
    return dict(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"],
                baseline=rp["baseline"])


@pytest.mark.parametrize("kernel", ["cell", "v1"])
def test_system_matches_jax_with_same_draws(seq6, kernel, monkeypatch):
    """The slice as a whole: 6 frames through both ``System``s on K3 / K4."""
    frames = list(zip(seq6["images_l"], seq6["images_r"]))
    with jax_pallas_kernels():
        j_sys = JSystem(JRunConfig(camera=JCamera(**_cam(seq6)),
                                   vo=jfront.VOConfig(lk_backend="pallas",
                                                      lk_kernel=kernel, **SMALL)))
        j_traj = j_sys.run(frames)
    queue = [torch.from_numpy(u) for u in jax_draws(len(frames) - 1,
                                                    SMALL["num_hypotheses"])]
    orig = tpnp.ransac_pnp
    monkeypatch.setattr(tpnp, "ransac_pnp",
                        lambda *a, u=None, **kw: orig(*a, u=queue.pop(0), **kw))
    t_sys = System(RunConfig(camera=CameraConfig(**_cam(seq6)),
                             vo=tfront.VOConfig(lk_kernel=kernel, **SMALL)), device="cpu")
    t_traj = t_sys.run_chunked(frames, chunk=3)
    assert not queue
    assert t_traj.shape == j_traj.shape == (6, 4, 4)
    acc = [m["accept"] for m in t_sys.metrics]
    assert acc == [m["accept"] for m in j_sys.metrics] and sum(acc) == 5, acc
    np.testing.assert_allclose(t_traj[:, :3, 3], j_traj[:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_traj[:, :3, :3], j_traj[:, :3, :3], atol=1e-4, rtol=0)
