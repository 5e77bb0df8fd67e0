"""Port parity: K7 (``roll.roll``), the roll by an amount held in device
memory, against the JAX probe kernel ``probe_roll.make`` in Pallas
interpret mode, and the route and probe of the port's roll module; and the
build of the kernel library (``native.build``: every ``csrc/*.cu`` with
nvcc into one library) as far as it goes without a card: its key, its
commands, a built library reused, a failed compile that raises and leaves
nothing behind, no build at import or on the CPU route.

``scripts/probe_roll.py`` runs its envelope on the TPU at import, so the
test executes only its ``make`` (``torch_jax_kernels.jax_roll``). The grid
is the probe's: axis 0 and 1, (rows, 256) float32 inputs for rows 16..128,
the amounts 0, 1, 3, 7 and 9 (axis 0) or 100 (axis 1), plus -1, the axis
length and the axis length + 5. Tolerance 0: a roll is a copy.
"""
import subprocess
import sys
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
                                 "x_dtype", "x_rows", "axis"])
def test_roll_checks_its_inputs(bad):
    x, amt, axis = torch.zeros(16, 256), torch.zeros((1, 1), dtype=torch.int32), 0
    if bad == "x_rows":  # more rows than the C entry's int takes (a view: no memory)
        x = torch.zeros(1, 1).expand(2 ** 31, 1)
    elif bad == "meta_device":  # neither the CPU nor a card: no route
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
        "assert native._lib is None and not native._entries\n")
    root = Path(__file__).resolve().parents[1]
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr


def test_roll_on_the_cpu_builds_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route started a build")

    for name in ("build", "lib", "entry"):
        monkeypatch.setattr(native, name, refuse)
    x = torch.rand(16, 256)
    got = troll.roll(x, torch.tensor([[3]], dtype=torch.int32), 0)
    torch.testing.assert_close(got, torch.roll(x, -3, 0), rtol=0, atol=0)


@pytest.fixture
def fake_cuda(monkeypatch, tmp_path):
    """A CUDA home for the commands (none here), an empty build dir and a
    copy of the kernel sources that a test may edit."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in native.CSRC_DIR.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(native, "_nvcc", lambda: "/toolkit/cuda/bin/nvcc")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "CSRC_DIR", src)
    return tmp_path / "_build"


@pytest.mark.parametrize("changed", sorted(p.name for p in native.CSRC_DIR.glob("*.cu*"))
                         + ["flags"])
def test_library_path_is_keyed_by_every_source_header_and_flag(fake_cuda, monkeypatch,
                                                                changed):
    """The library's name changes with any ``.cu`` source, any ``.cuh``
    header and the nvcc flags, and with nothing else."""
    path = native.library_path()
    assert path.parent == fake_cuda and path.name.startswith("libsvo_kernels_")
    assert native.library_path() == path
    (native.CSRC_DIR / "notes.txt").write_text("not a source")
    assert native.library_path() == path
    if changed == "flags":
        monkeypatch.setattr(native, "NVCC_FLAGS", native.NVCC_FLAGS + ("-lineinfo",))
    else:
        src = native.CSRC_DIR / changed
        src.write_bytes(src.read_bytes() + b"\n")
    assert native.library_path() != path


def test_build_reuses_a_built_library(fake_cuda, monkeypatch):
    fake_cuda.mkdir()
    path = native.library_path()
    path.write_bytes(b"")

    def refuse(*args, **kwargs):
        raise AssertionError("rebuilt an existing library")

    monkeypatch.setattr(native, "_run_all", refuse)
    assert native.build() == path


def test_build_raises_when_nvcc_fails_and_leaves_nothing(fake_cuda, monkeypatch):
    """A compile that fails raises and leaves no library, object or
    temporary file behind: no fallback."""
    monkeypatch.setattr(native, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="false failed"):
        native.build()
    assert not native.library_path().exists()
    assert list(fake_cuda.iterdir()) == []


def test_build_compiles_every_cu_source_and_nothing_else(fake_cuda, monkeypatch):
    """One nvcc per ``csrc/*.cu`` (with the flags, to an object of its
    own), then one nvcc link of exactly those objects; no host compiler and
    no other source. The library lands at ``library_path``, its log beside
    it, and the objects are removed."""
    (native.CSRC_DIR / "stray.cpp").write_text("int stray;")
    ran = []

    def fake_run_all(cmds):
        for cmd in cmds:
            ran.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return [" ".join(c) for c in cmds]

    monkeypatch.setattr(native, "_run_all", fake_run_all)
    out = native.build()
    sources = sorted(str(p) for p in native.CSRC_DIR.glob("*.cu"))
    *compiles, link = ran
    assert all(cmd[0] == "/toolkit/cuda/bin/nvcc" for cmd in ran)
    assert sorted(cmd[-1] for cmd in compiles) == sources and len(sources) >= 5
    objects = []
    for cmd in compiles:
        assert cmd[1:1 + len(native.NVCC_FLAGS)] == list(native.NVCC_FLAGS) and "-c" in cmd
        objects.append(cmd[cmd.index("-o") + 1])
    assert link[1] == "-shared" and link[4:] == objects
    assert not any(part.endswith(".cpp") for cmd in ran for part in cmd)
    assert out == native.library_path() and out.exists()
    assert sorted(p.name for p in fake_cuda.iterdir()) == sorted(
        [out.name, out.with_suffix(".log").name])
