"""Port parity: K7 (``roll.roll``), the roll by an amount held in device
memory, against the JAX probe kernel ``probe_roll.make`` in Pallas
interpret mode, and the route and probe of the port's roll module; and the
build of K7's binding (``csrc/roll_binding.cpp``, ``native.extension``) as
far as it goes without a card: its command, its key, no build at import or
on the CPU route, a failed compile that raises.

``scripts/probe_roll.py`` runs its envelope on the TPU at import, so the
test executes only its ``make`` (``torch_jax_kernels.jax_roll``). The grid
is the probe's: axis 0 and 1, (rows, 256) float32 inputs for rows 16..128,
the amounts 0, 1, 3, 7 and 9 (axis 0) or 100 (axis 1), plus -1, the axis
length and the axis length + 5. Tolerance 0: a roll is a copy.
"""
import subprocess
import sys
import sysconfig
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.ops import native
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


def test_importing_roll_builds_nothing():
    """A fresh interpreter imports the roll module (and the package) with
    every way to start a compiler blocked: nothing is built or loaded."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a build started at import')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import stereo_visual_odometry_tpu_torch\n"
        "from stereo_visual_odometry_tpu_torch.ops import native, roll\n"
        "assert roll._launch is None and native._lib is None and not native._extensions\n")
    root = Path(__file__).resolve().parents[1]
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr


def test_roll_on_the_cpu_builds_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route started a build")

    for name in ("build", "build_extension", "extension", "lib"):
        monkeypatch.setattr(native, name, refuse)
    x = torch.rand(16, 256)
    got = troll.roll(x, torch.tensor([[3]], dtype=torch.int32), 0)
    torch.testing.assert_close(got, torch.roll(x, -3, 0), rtol=0, atol=0)


@pytest.fixture
def fake_cuda(monkeypatch, tmp_path):
    """A CUDA home for the command (none here) and an empty build dir."""
    monkeypatch.setattr(native, "_nvcc", lambda: "/toolkit/cuda/bin/nvcc")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


def test_binding_command_uses_the_host_compiler(fake_cuda, monkeypatch):
    """The host compiler against PyTorch's, CUDA's and Python's headers,
    linked against PyTorch's libraries: no nvcc, no ninja."""
    from torch.utils import cpp_extension
    monkeypatch.delenv("CXX", raising=False)
    cmd = native.extension_command("roll_binding")
    assert Path(cmd[0]).name in ("g++", "c++") and "nvcc" not in cmd[0]
    assert not any("ninja" in part for part in cmd)
    assert "-shared" in cmd and "-fPIC" in cmd
    includes = {part[2:] for part in cmd if part.startswith("-I")}
    assert set(cpp_extension.include_paths()) <= includes
    assert {"/toolkit/cuda/include", sysconfig.get_paths()["include"]} <= includes
    assert {f"-l{lib}" for lib in native.TORCH_LIBS} <= set(cmd)
    src = native.CSRC_DIR / "roll_binding.cpp"
    assert str(src) in cmd and src.exists()
    monkeypatch.setenv("CXX", "clang++")
    assert native.extension_command("roll_binding")[0] == "clang++"


def test_binding_path_is_keyed_by_source_torch_and_python(fake_cuda, monkeypatch):
    path = native.extension_path("roll_binding")
    assert path.parent == fake_cuda
    assert path.name.startswith("roll_binding_")
    assert path.name.endswith(sysconfig.get_config_var("EXT_SUFFIX"))
    assert native.extension_path("roll_binding") == path
    monkeypatch.setattr(torch, "__version__", torch.__version__ + "+other")
    assert native.extension_path("roll_binding") != path


def test_build_extension_reuses_a_built_binding(fake_cuda, monkeypatch):
    fake_cuda.mkdir()
    path = native.extension_path("roll_binding")
    path.write_bytes(b"")

    def refuse(*args, **kwargs):
        raise AssertionError("rebuilt an existing binding")

    monkeypatch.setattr(native, "_run_all", refuse)
    assert native.build_extension("roll_binding") == path


def test_build_extension_raises_when_the_compiler_fails(fake_cuda, monkeypatch):
    """A compile that fails raises and leaves nothing behind: no fallback."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        native.build_extension("roll_binding")
    assert not native.extension_path("roll_binding").exists()
    assert not list(fake_cuda.glob("*.tmp"))
