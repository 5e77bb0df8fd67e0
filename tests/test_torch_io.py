"""The port's host I/O against the JAX package's: ``utils/logging.py``,
``utils/viz.py``, the native KITTI loader (``native/loader.py`` +
``loader.cpp``) and the dataset's decoder choice (``utils/kitti.py``).

Tolerances: none. Decoded frames are equal byte for byte (the JAX native
loader, the port's and PIL, padded too), the PPM trajectory fallback is
equal byte for byte, and ``MetricsRecorder`` writes the same JSON lines
apart from their ``ts``.
"""
import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from stereo_visual_odometry_tpu.native import loader as jloader
from stereo_visual_odometry_tpu.utils import kitti as jkitti
from stereo_visual_odometry_tpu.utils import logging as jlogging
from stereo_visual_odometry_tpu.utils import viz as jviz
from stereo_visual_odometry_tpu_torch.native import loader
from stereo_visual_odometry_tpu_torch.ops import native
from stereo_visual_odometry_tpu_torch.utils import kitti
from stereo_visual_odometry_tpu_torch.utils import logging as tlogging
from stereo_visual_odometry_tpu_torch.utils import viz

REPO = Path(__file__).resolve().parent.parent


def _write_seq(root, n, hw, seed):
    """A KITTI layout of ``n`` random 8-bit pairs of native size ``hw``;
    returns {(dir, i): image}."""
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    rng = np.random.default_rng(seed)
    imgs = {}
    for i in range(n):
        for d in ("image_0", "image_1"):
            imgs[(d, i)] = (rng.random(hw) * 255).astype(np.uint8)
            Image.fromarray(imgs[(d, i)]).save(root / d / f"{i:06d}.png")
    return imgs


# ---- logging -------------------------------------------------------------- #

def test_logger_hierarchy_and_format_match_jax():
    ours, theirs = tlogging.get_logger("system"), jlogging.get_logger("system")
    assert ours.name == "stereo_visual_odometry_tpu_torch.system"
    root = logging.getLogger(tlogging.ROOT)
    jroot = logging.getLogger("svo_tpu")
    assert not root.propagate and root.level == jroot.level == logging.INFO
    (h,), (jh,) = root.handlers, jroot.handlers  # one handler, however many calls
    tlogging.get_logger("again")
    assert len(root.handlers) == 1
    assert h.formatter._fmt == jh.formatter._fmt and h.formatter.datefmt == jh.formatter.datefmt
    # A module logger of the port (``logging.getLogger(__name__)``) prints
    # through the package's handler.
    module_log = logging.getLogger("stereo_visual_odometry_tpu_torch.models.system")
    rec = module_log.makeRecord(module_log.name, logging.WARNING, __file__, 1, "lost %d",
                                (3,), None)
    records = []
    h.addFilter(lambda r: records.append(r) or False)  # see it, print nothing
    try:
        module_log.handle(rec)
    finally:
        h.filters.clear()
    assert records == [rec]
    assert h.format(rec).endswith("W stereo_visual_odometry_tpu_torch.models.system] lost 3")


def test_metrics_recorder_writes_jax_lines(tmp_path):
    rows = [dict(frame=0, accept=True, ate=np.float32(0.25)), dict(frame=1, n=np.int64(7)),
            dict(frame=2, ts=123.5, note="given ts")]
    out = {}
    for name, mod in (("port", tlogging), ("jax", jlogging)):
        rec = mod.MetricsRecorder(str(tmp_path / f"{name}.jsonl"))
        for r in rows:
            rec.log(**r)
        rec.close()
        rec.close()  # idempotent
        out[name] = [json.loads(s) for s in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        assert len(rec.records) == 3 and all("ts" in r for r in rec.records)
    assert out["port"][2]["ts"] == out["jax"][2]["ts"] == 123.5
    strip = lambda lines: [{k: v for k, v in r.items() if k != "ts"} for r in lines]
    assert strip(out["port"]) == strip(out["jax"])
    assert tlogging.MetricsRecorder().log(a=1) is None  # no file: records only


# ---- viz ------------------------------------------------------------------ #

def _poses(n, seed):
    rng = np.random.default_rng(seed)
    p = np.tile(np.eye(4), (n, 1, 1))
    p[:, 0, 3] = np.cumsum(rng.normal(0, 0.3, n))
    p[:, 2, 3] = np.cumsum(rng.random(n) * 1.1)
    return p


@pytest.mark.parametrize("with_gt", [False, True])
def test_ppm_trajectory_bytes_equal_jax(tmp_path, with_gt):
    poses = _poses(40, 1)
    gt = _poses(40, 2) if with_gt else None
    viz._ppm_trajectory(str(tmp_path / "t.ppm"), poses, gt)
    jviz._ppm_trajectory(str(tmp_path / "j.ppm"), poses, gt)
    data = (tmp_path / "t.ppm").read_bytes()
    assert data == (tmp_path / "j.ppm").read_bytes()
    assert data.startswith(b"P6\n600 600\n255\n") and len(data) == 15 + 600 * 600 * 3


def test_viz_without_matplotlib(tmp_path, monkeypatch):
    """No matplotlib: the plot falls back to the PPM bytes, the overlay
    writes nothing (both as in JAX)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    poses, gt = _poses(12, 3), _poses(12, 4)
    viz.plot_trajectory(str(tmp_path / "t.png"), poses, gt)
    jviz.plot_trajectory(str(tmp_path / "j.png"), poses, gt)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    xy = np.array([[10.0, 10.0], [30.0, 40.0]])
    viz.draw_tracks(str(tmp_path / "trk.png"), np.zeros((64, 64), np.float32), xy, xy + 2,
                    np.array([True, False]))
    assert not (tmp_path / "trk.png").exists()


def test_viz_outputs_with_matplotlib(tmp_path):
    """JAX's ``test_viz_outputs``: with matplotlib both renders write a PNG."""
    poses = _poses(10, 5)
    viz.plot_trajectory(str(tmp_path / "traj.png"), poses, gt=poses)
    xy = np.array([[10.0, 10.0], [30.0, 40.0]])
    viz.draw_tracks(str(tmp_path / "trk.png"), np.zeros((64, 64), np.float32), xy, xy + 2,
                    np.array([True, True]))
    for name in ("traj.png", "trk.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---- the native loader ---------------------------------------------------- #

def test_loader_builds_into_build_dir():
    path = loader.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libsvoload_")
    assert loader.get_lib() is loader.get_lib()
    assert path.exists()
    cmd = loader.command()
    assert cmd[1:] == [*loader.CXX_FLAGS, str(loader.SRC), "-lpng", "-lpthread"]


def test_importing_builds_nothing():
    code = (
        "import subprocess, sys\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('a process started at import')\n"
        "subprocess.Popen = subprocess.run = boom\n"
        "from stereo_visual_odometry_tpu_torch.native import loader\n"
        "from stereo_visual_odometry_tpu_torch.utils import kitti\n"
        "from stereo_visual_odometry_tpu_torch import cli\n"
        "assert loader._lib is None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_failed_compile_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "loader.cpp"
    bad.write_text("#include <png.h>\nint broken( {\n")
    with pytest.raises(RuntimeError, match="error") as info:
        loader.build(bad)
    assert "broken" in str(info.value)  # the compiler's own message, naming the line
    assert not loader.library_path(bad).exists()


def test_failed_build_is_raised_again_without_a_rebuild(monkeypatch):
    builds = []

    def failing_build():
        builds.append(1)
        raise RuntimeError("g++ failed: png.h: No such file or directory")

    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_error", None)
    monkeypatch.setattr(loader, "build", failing_build)
    with pytest.raises(RuntimeError, match="png.h") as first:
        loader.get_lib()
    with pytest.raises(RuntimeError) as again:
        loader.get_lib()
    assert again.value is first.value and len(builds) == 1


def test_native_decode_equals_jax_and_pil(tmp_path):
    root = tmp_path / "seq"
    imgs = _write_seq(root, 3, (41, 53), seed=5)
    for i in range(3):
        path = str(root / "image_0" / f"{i:06d}.png")
        want = imgs[("image_0", i)]
        got = loader.decode_png_gray(path)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert np.array_equal(got, jloader.decode_png_gray(path))
        assert np.array_equal(got, np.asarray(Image.open(path).convert("L")))
        padded = loader.decode_png_gray(path, (48, 64))
        assert np.array_equal(padded, kitti.pad_to(want, 48, 64))
        assert np.array_equal(padded, jloader.decode_png_gray(path, (48, 64)))
    assert loader.png_size(path) == (41, 53)
    with pytest.raises(IOError, match="native png decode failed"):
        loader.decode_png_gray(path, (40, 64))  # smaller than the image
    paths = [(str(root / "image_0" / f"{i:06d}.png"), str(root / "image_1" / f"{i:06d}.png"))
             for i in range(3)]
    ours = list(loader.iter_stereo_prefetch(paths, (48, 64), depth=2))
    theirs = list(jloader.iter_stereo_prefetch(paths, (48, 64), depth=2))
    assert len(ours) == 3
    for (l, r), (jl, jr), i in zip(ours, theirs, range(3)):
        assert np.array_equal(l, jl) and np.array_equal(r, jr)
        assert np.array_equal(r, kitti.pad_to(imgs[("image_1", i)], 48, 64))


def test_png_size_refuses_other_files(tmp_path):
    (tmp_path / "x.png").write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(IOError, match="not a PNG"):
        loader.png_size(str(tmp_path / "x.png"))


def test_dataset_decoders_agree_with_jax(tmp_path):
    """JAX's ``test_kitti_loader_native`` on the port, and the native and PIL
    datasets (both packages) give the same frames; ``decoder`` says which
    one ran."""
    root = tmp_path / "seq"
    imgs = _write_seq(root, 4, (41, 53), seed=5)
    ds = kitti.KittiStereoDataset(str(root), static_hw=(48, 64))
    pil = kitti.KittiStereoDataset(str(root), static_hw=(48, 64), use_native=False)
    jds = jkitti.KittiStereoDataset(str(root), static_hw=(48, 64), use_native=True)
    assert (ds.decoder, pil.decoder) == ("native", "pil")
    assert ds.native_hw == pil.native_hw == jds.native_hw == (41, 53)
    l, r = ds[2]
    np.testing.assert_array_equal(l[:41, :53], imgs[("image_0", 2)])
    np.testing.assert_array_equal(r[:41, :53], imgs[("image_1", 2)])
    frames = list(ds.iter_prefetch(depth=2))
    assert len(frames) == 4
    for want in (list(pil.iter_prefetch()), list(jds.iter_prefetch(depth=2)),
                 [jds[i] for i in range(4)]):
        for (a, b), (c, d) in zip(frames, want):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    assert (kitti.KittiStereoDataset(str(root)).static_hw
            == jkitti.KittiStereoDataset(str(root), use_native=False).static_hw == (64, 64))


def test_dataset_falls_back_to_pil_when_the_build_fails(tmp_path, monkeypatch):
    root = tmp_path / "seq"
    _write_seq(root, 2, (30, 40), seed=6)
    native_ds = kitti.KittiStereoDataset(str(root), static_hw=(32, 40))
    want = list(native_ds.iter_prefetch())

    def no_build():
        raise RuntimeError("g++ failed: png.h: No such file or directory")

    monkeypatch.setattr(loader, "get_lib", no_build)
    ds = kitti.KittiStereoDataset(str(root), static_hw=(32, 40))
    assert (native_ds.decoder, ds.decoder) == ("native", "pil")
    for (a, b), (c, d) in zip(ds.iter_prefetch(), want, strict=True):
        assert np.array_equal(a, c) and np.array_equal(b, d)
