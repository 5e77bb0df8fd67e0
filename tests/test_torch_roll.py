"""Port parity: K7 (``roll.roll``), the roll by an amount held in device
memory, against the JAX probe kernel ``probe_roll.make`` in Pallas
interpret mode, and the route and probe of the port's roll module.

``scripts/probe_roll.py`` runs its envelope on the TPU at import, so the
test executes only its ``make`` (``torch_jax_kernels.jax_roll``). The grid
is the probe's: axis 0 and 1, (rows, 256) float32 inputs for rows 16..128,
the amounts 0, 1, 3, 7 and 9 (axis 0) or 100 (axis 1), plus -1, the axis
length and the axis length + 5. Tolerance 0: a roll is a copy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.ops import roll as troll
from stereo_visual_odometry_tpu_torch.probes import roll as probe_roll
from torch_jax_kernels import jax_roll


@pytest.mark.parametrize("rows", probe_roll.ROWS)
@pytest.mark.parametrize("axis", [0, 1])
def test_roll_matches_jax_probe_kernel(axis, rows):
    x = np.random.default_rng(rows).random((rows, probe_roll.COLS)).astype(np.float32)
    run = jax_roll(rows, probe_roll.COLS, axis)
    for amt in probe_roll.amounts(axis, x.shape[axis], extended=True):
        want = np.asarray(run(jnp.asarray(x), jnp.asarray([[amt]], jnp.int32)))
        got = troll.roll(torch.from_numpy(x), torch.tensor([[amt]], dtype=torch.int32),
                         axis)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, np.roll(x, -amt, axis=axis))


def test_roll_routes_cpu_tensors_to_plain_version():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    amt = torch.tensor([[-5]], dtype=torch.int32)
    before = troll.roll.launches
    got = troll.roll(x, amt, 1)
    assert troll.roll.launches == before
    torch.testing.assert_close(got, troll.roll_reference(x, amt, 1), rtol=0, atol=0)
    torch.testing.assert_close(got, torch.roll(x, 5, 1), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["meta_device", "mixed_devices", "amt_dtype", "amt_shape",
                                 "x_dtype", "axis"])
def test_roll_checks_its_inputs(bad):
    x, amt, axis = torch.zeros(16, 256), torch.zeros((1, 1), dtype=torch.int32), 0
    if bad == "meta_device":  # neither the CPU nor a card: no route
        x, amt = x.to("meta"), amt.to("meta")
    elif bad == "mixed_devices":
        amt = amt.to("meta")
    elif bad == "amt_dtype":
        amt = amt.long()
    elif bad == "amt_shape":
        amt = amt.reshape(1)
    elif bad == "x_dtype":
        x = x.double()
    else:
        axis = 2
    with pytest.raises(ValueError):
        troll.roll(x, amt, axis)


def test_roll_probe_runs_on_the_cpu(capsys):
    assert probe_roll.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * len(probe_roll.ROWS)
    assert all(line.endswith("max_err=0.0000") for line in lines)


def test_roll_probe_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_roll.main([])
