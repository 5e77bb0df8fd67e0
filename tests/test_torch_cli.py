"""The port's command line (``python -m stereo_visual_odometry_tpu_torch.cli``)
with ``--device cpu``: JAX's five ``tests/test_cli.py`` cases with their
bounds, the trajectory held to the port's ``System`` on the same decoded
frames, and the printed lines held to the JAX CLI's.

Tolerances: the CLI's trajectories equal ``System.run`` (``run_chunked``
with ``--chunked``) on the frames decoded from the same PNGs, bit for bit,
with and without overlays (the same steps on the same bytes with the same
seed). The JAX CLI on the CPU runs another LK tracker (its
``lk_backend='auto'`` takes ``_level_track``, ROADMAP Queue 3), so its lines
are compared by format, numbers masked.
"""
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_visual_odometry_tpu import cli as jcli
from stereo_visual_odometry_tpu_torch import cli
from stereo_visual_odometry_tpu_torch.models import system as system_mod
from stereo_visual_odometry_tpu_torch.utils import synthetic, trajectory
from stereo_visual_odometry_tpu_torch.utils.config import load_reference_yaml
from stereo_visual_odometry_tpu_torch.utils.kitti import KittiStereoDataset

LK_YAML = """%YAML:1.0
camera1.fx: 300.0
camera1.fy: 300.0
camera1.cx: 128.0
camera1.cy: 96.0
t_lr0: -0.54
track_mode: LK_stereof2f_pnp
nFeatures: 256
iterationsCount: 128
inlier_rate: 0.3
num_features_tracking: 8
"""


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


def make_kitti_dir(tmp_path, n_frames=6, h=192, w=256):
    """JAX's helper: a synthetic sequence as 8-bit PNGs and a pose file."""
    seq = synthetic.render_sequence(n_frames=n_frames, h=h, w=w, fx=300.0, speed=1.0)
    root = tmp_path / "seq00"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    for i in range(n_frames):
        Image.fromarray(seq["images_l"][i].astype(np.uint8)).save(
            root / "image_0" / f"{i:06d}.png")
        Image.fromarray(seq["images_r"][i].astype(np.uint8)).save(
            root / "image_1" / f"{i:06d}.png")
    gt_file = tmp_path / "gt.txt"
    trajectory.save_kitti(str(gt_file), seq["poses_gt"])
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text(LK_YAML)
    return root, gt_file, seq, yaml


@pytest.fixture
def systems(monkeypatch):
    """Each ``System`` the CLI builds, with the trajectory its run returned."""
    made = []
    for name in ("run", "run_chunked"):
        orig = getattr(system_mod.System, name)

        def spy(self, *a, _orig=orig, **kw):
            traj = _orig(self, *a, **kw)
            made.append((self, traj))
            return traj
        monkeypatch.setattr(system_mod.System, name, spy)
    return made


def reference(yaml, root, method="run", **kw):
    """The port's ``System`` on the CPU over the frames decoded from
    ``root`` (the CLI's config, sized to the images); its trajectory."""
    import dataclasses
    cfg = load_reference_yaml(str(yaml))
    hw = KittiStereoDataset(str(root)).static_hw
    cfg = dataclasses.replace(cfg, vo=dataclasses.replace(cfg.vo, height=hw[0], width=hw[1]))
    ds = KittiStereoDataset(str(root), static_hw=hw, use_native=False)
    frames = [ds[i] for i in range(len(ds))]
    return getattr(system_mod.System(cfg, device="cpu"), method)(frames, **kw)


def test_cli_runs_end_to_end(tmp_path, capsys, systems):
    root, gt_file, seq, yaml = make_kitti_dir(tmp_path)
    out = tmp_path / "traj.txt"
    plot = tmp_path / "traj.png"
    rc = cli.main([str(yaml), "--dataset", str(root), "--out", str(out),
                   "--gt", str(gt_file), "--plot", str(plot), "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "fps=" in printed and "ATE=" in printed
    traj = trajectory.load_kitti(str(out))
    assert traj.shape[0] == 6
    ate = trajectory.ate_rmse(traj, seq["poses_gt"], align=False)
    assert ate < 0.5, ate
    assert os.path.getsize(plot) > 0
    (sys_, got), = systems
    assert sys_.device.type == "cpu" and sys_.graph is None
    assert "tracked_prev" not in sys_.metrics[2]  # no overlay: the lean copy
    np.testing.assert_array_equal(got, reference(yaml, root))


def test_cli_dump_overlays(tmp_path, systems):
    """--dump-overlays writes the displayTracking-equivalent PNGs
    (``tracking.cpp:354-382``, offline) and leaves the trajectory as it is."""
    root, gt_file, seq, yaml = make_kitti_dir(tmp_path)
    ovl = tmp_path / "overlays"
    rc = cli.main([str(yaml), "--dataset", str(root),
                   "--dump-overlays", str(ovl), "--every", "2", "--device", "cpu"])
    assert rc == 0
    pngs = sorted(os.listdir(ovl))
    assert pngs == ["tracks_000002.png", "tracks_000004.png"]  # not the init frame 0
    assert all(os.path.getsize(ovl / p) > 0 for p in pngs)
    (sys_, got), = systems
    m = sys_.metrics[2]
    assert m["tracked_prev"].shape == m["tracked_cur"].shape == (256, 2)
    assert m["tracked_valid"].shape == (256,) and m["tracked_valid"].dtype == bool
    np.testing.assert_array_equal(got, reference(yaml, root))


def test_cli_ba(tmp_path, capsys):
    """--ba runs config 3 (sliding-window BA backend) from the command line."""
    root, gt_file, seq, yaml = make_kitti_dir(tmp_path, n_frames=10)
    out = tmp_path / "traj.txt"
    rc = cli.main([str(yaml), "--dataset", str(root), "--ba",
                   "--window", "4", "--kf-every", "2",
                   "--out", str(out), "--gt", str(gt_file), "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "ba:" in printed and "window solves" in printed
    traj = trajectory.load_kitti(str(out))
    assert traj.shape[0] == 10
    ate = trajectory.ate_rmse(traj, seq["poses_gt"], align=False)
    assert ate < 0.6, ate


def test_cli_chunked(tmp_path, capsys, systems):
    """--chunked N runs the offline-throughput loop: ``run_chunked``'s
    trajectory on the same frames."""
    root, gt_file, seq, yaml = make_kitti_dir(tmp_path, n_frames=9)
    out = tmp_path / "traj.txt"
    rc = cli.main([str(yaml), "--dataset", str(root), "--chunked", "4",
                   "--out", str(out), "--gt", str(gt_file), "--device", "cpu"])
    assert rc == 0
    assert "ATE=" in capsys.readouterr().out
    traj = trajectory.load_kitti(str(out))
    assert traj.shape[0] == 9
    ate = trajectory.ate_rmse(traj, seq["poses_gt"], align=False)
    assert ate < 0.5, ate
    (_, got), = systems
    np.testing.assert_array_equal(got, reference(yaml, root, "run_chunked", chunk=4))


def test_cli_batch(tmp_path, capsys):
    """--batch runs config 4 (multi-sequence batched VO) with per-sequence
    ATE."""
    root1, gt1, _, yaml = make_kitti_dir(tmp_path, n_frames=6)
    sub = tmp_path / "second"
    sub.mkdir()
    root2, gt2, _, _ = make_kitti_dir(sub, n_frames=6)
    out = tmp_path / "btraj"
    rc = cli.main([str(yaml), "--batch", str(root1), str(root2),
                   "--batch-gt", str(gt1), str(gt2), "--out", str(out), "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "sequences=2" in printed
    assert printed.count("ATE=") == 2
    for s in range(2):
        traj = trajectory.load_kitti(f"{out}.{s:02d}")
        assert traj.shape[0] == 6


def test_cli_lines_match_jax(tmp_path, capsys):
    """The same arguments print the JAX CLI's lines, numbers masked."""
    root, gt_file, _, yaml = make_kitti_dir(tmp_path)
    args = [str(yaml), "--dataset", str(root), "--out", str(tmp_path / "traj.txt"),
            "--gt", str(gt_file), "--plot", str(tmp_path / "traj.png")]
    mask = lambda text: re.sub(r"\d+(\.\d+)?", "#", text).splitlines()
    assert jcli.main(args) == 0
    theirs = mask(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    ours = mask(capsys.readouterr().out)
    assert ours == theirs and len(ours) == 3, (ours, theirs)
    assert ours[0] == "frames=# fps=# accept_rate=#%" and ours[1].startswith("ATE=#m")


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    root, _, _, yaml = make_kitti_dir(tmp_path, n_frames=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main([str(yaml), "--dataset", str(root)])
    with pytest.raises(SystemExit):
        cli.main([str(yaml), "--dataset", str(root), "--ba", "--chunked", "2",
                  "--device", "cpu"])
