"""The port's batched frontend (``parallel/sequences.py``) against JAX's
``make_batched_frontend`` on the CPU, on LK dense, ``cell``, ``v1`` and ORB.

JAX's side is vmapped and jitted over 2 of the conftest's 8 CPU devices
with K1-K4 in interpret mode (``torch_jax_kernels.jax_pallas_kernels``),
K1's and K3's ``custom_vmap`` batch rules included; its LK runs the level
kernels (``lk_backend='pallas'``; its CPU default would run the XLA
tracker). Both packages step from the same JAX state, carried across by
``bridge.state_from_jax`` (every leaf S-leading), with JAX's own
per-sequence draws (``split(PRNGKey(0), S)``, one key per sequence). The
second step is compared: the first has no motion prior and sits on a knife
edge, where one point more or less tracked moves the pose by 0.1 m in
either package.

Tolerances, as the unbatched frontend tests (``test_torch_frontend.py``):
accept equal; T_21 translation within 1e-3 m and rotation within 1e-4; LK
n_tracked within 2% (an LK gate on its threshold flips with float32 sums in
another order, and JAX's vmapped K3 moves fractional rows by up to 2^-12 px,
``lk_pallas_cell.py:211-213``); ORB n_tracked equal (integer matching on
the same descriptors, on frames with 1 grey level of sensor noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models import frontend as jfront
from stereo_visual_odometry_tpu.parallel import sequences as jsequences
from stereo_visual_odometry_tpu.parallel.mesh import make_mesh as jmake_mesh
from stereo_visual_odometry_tpu_torch.models import frontend as tfront
from stereo_visual_odometry_tpu_torch.parallel import sequences
from stereo_visual_odometry_tpu_torch.utils import bridge
from test_torch_parallel import PATHS, SMALL, jax_rig, make_batch, port_rig
from torch_jax_kernels import jax_batch_draws, jax_pallas_kernels, with_sensor_noise


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", list(PATHS))
def test_batched_frontend_matches_jax(path):
    S = 2
    kw = dict(SMALL, **PATHS[path])
    orb = kw.get("mode") == "orb"
    il, ir, _, rp = make_batch(S, 3, kw["height"], kw["width"])
    if orb:  # flat regions leave BRIEF bits sign-less (torch_jax_kernels)
        il, ir = with_sensor_noise(il, seed=1), with_sensor_noise(ir, seed=2)
    jcfg = jfront.VOConfig(**(kw if orb else dict(kw, lk_backend="pallas")))
    with jax_pallas_kernels():
        binit, bstep, place = jsequences.make_batched_frontend(jcfg, jax_rig(rp),
                                                               jmake_mesh(S, axis="seq"))
        keys = jax.random.split(jax.random.PRNGKey(0), S)
        state = binit(place(jnp.asarray(il[:, 0])), place(jnp.asarray(ir[:, 0])), keys)
        state, _ = bstep(state, place(jnp.asarray(il[:, 1])), place(jnp.asarray(ir[:, 1])))
        state_np = jax.tree_util.tree_map(np.asarray, state)  # the step donates it
        _, m_j = bstep(state, place(jnp.asarray(il[:, 2])), place(jnp.asarray(ir[:, 2])))
        m_j = jax.tree_util.tree_map(np.asarray, m_j)
    u = jax_batch_draws(2, jcfg.num_hypotheses, S)[:, 1]  # the second step's draws
    _, t_step, _ = sequences.make_batched_frontend(tfront.VOConfig(**kw), port_rig(rp),
                                                   device="cpu")
    t_state = bridge.state_from_jax(state_np)
    assert t_state["status"].shape == (S,) and t_state["T_wc"].shape == (S, 4, 4)
    _, m_t = t_step(t_state, il[:, 2], ir[:, 2], u=torch.from_numpy(u))
    assert m_t["accept"].tolist() == m_j["accept"].tolist() == [True] * S
    T_t = m_t["T_21"].numpy()
    np.testing.assert_allclose(T_t[:, :3, 3], m_j["T_21"][:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(T_t[:, :3, :3], m_j["T_21"][:, :3, :3], atol=1e-4, rtol=0)
    n_t, n_j = m_t["n_tracked"].numpy(), m_j["n_tracked"]
    if orb:
        np.testing.assert_array_equal(n_t, n_j)
    else:
        assert np.all(np.abs(n_t - n_j) <= 0.02 * n_j), (n_t, n_j)
