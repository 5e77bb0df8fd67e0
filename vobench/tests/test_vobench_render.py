"""The frame source: the device renderer against the program's numpy
generator, the closed circuit, and frames that are a function of the seed."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu_torch.utils import synthetic
from vobench import render
from vobench.tests.tiny import CIRCUIT, SENSOR

CIRCUITS = Path(__file__).resolve().parents[1] / "circuits"


def test_render_frames_is_the_generators_scene():
    """The generator's cloud, stamps and trajectory through ``render_frames``
    give its images, to float32 rounding of the splat's sums."""
    n, h, w, fx, baseline, points, seed = 3, 72, 120, 90.0, 0.54, 600, 5
    seq = synthetic.render_sequence(n_frames=n, h=h, w=w, fx=fx, baseline=baseline,
                                    n_points=points, speed=0.8, seed=seed)
    pts, intens = synthetic.make_cloud(points, seed=seed)
    stamps = synthetic._make_stamps(points, render.RADIUS, seed)
    left, right = render.render_frames(torch.as_tensor(pts), torch.as_tensor(intens).float(),
                                       torch.as_tensor(stamps).float(), seq["poses_gt"], fx,
                                       baseline, h, w)
    assert (seq["images_l"] > render.BACKGROUND + 1).mean() > 0.2
    np.testing.assert_allclose(left.numpy(), seq["images_l"], atol=5e-3, rtol=0)
    np.testing.assert_allclose(right.numpy(), seq["images_r"], atol=5e-3, rtol=0)


@pytest.mark.parametrize("path", sorted(CIRCUITS.glob("*.json")), ids=lambda p: p.stem)
def test_circuit_closes(path):
    """Every circuit's lap ends where it began, turns by at most ~0.01 rad a
    frame, and its true motions differ from frame to frame."""
    lap = json.loads(path.read_text())
    poses = render.circuit_poses(lap)
    n = lap["lap_frames"]
    rel = np.linalg.inv(poses[:-1]) @ poses[1:]
    yaw = np.arctan2(rel[:, 0, 2], rel[:, 0, 0])
    last = np.linalg.inv(poses[-1])                   # the step from frame N-1 to frame N = 0
    f = n - 1
    c = 2 * np.pi / n * (1 + lap["yaw_swing"] * np.sin(2 * np.pi * lap["yaw_waves"] * f / n))
    speed = lap["speed_m"] * (1 + lap["speed_swing"]
                              * np.cos(2 * np.pi * lap["speed_waves"] * f / n))
    step = np.array([[np.cos(c), 0, np.sin(c), 0], [0, 1, 0, 0],
                     [-np.sin(c), 0, np.cos(c), speed], [0, 0, 0, 1]])
    assert np.abs(last - step).max() < 1e-9
    assert np.abs(yaw).max() <= 0.0099 and np.ptp(yaw) > 0.005
    assert np.ptp(np.linalg.norm(rel[:, :3, 3], axis=1)) > 0.3


def test_frames_are_the_scene_seeds():
    """One scene seed gives the same frames bit for bit; another seed other
    ones. Frames are whole grey levels, edge-padded, the ``extra`` frames the
    lap's first ones again."""
    circuit = dict(CIRCUIT, lap_frames=240, points=3000, scene_seed=2**33 + 1)
    a = render.render_lap(circuit, SENSOR, "cpu", extra=3)
    b = render.render_lap(circuit, SENSOR, "cpu", extra=3)
    c = render.render_lap(dict(circuit, scene_seed=2**33 + 2), SENSOR, "cpu", extra=3)
    assert a["left"].shape == (243, 128, 416) and a["left"].dtype == np.float32
    assert np.array_equal(a["left"], b["left"]) and np.array_equal(a["right"], b["right"])
    assert not np.array_equal(a["left"], c["left"])
    assert np.array_equal(a["left"], np.round(a["left"]))
    assert a["left"].min() >= 0 and a["left"].max() <= 255
    h, w = SENSOR["raw_hw"]
    assert np.array_equal(a["left"][:, h:], np.repeat(a["left"][:, h - 1:h], 128 - h, 1))
    assert np.array_equal(a["left"][:, :, w:], np.repeat(a["left"][:, :, w - 1:w], 416 - w, 2))
    assert np.array_equal(a["left"][240:], a["left"][:3])
    assert (a["left"][:240] > render.BACKGROUND + 1).mean() > 0.2


def test_a_part_of_the_lap_is_the_same_frames():
    """Rendering only the frames a feed reaches (past the lap's end, lap
    after lap) gives those frames bit for bit, and no others."""
    circuit = dict(CIRCUIT, lap_frames=240, points=3000)
    whole = render.render_lap(circuit, SENSOR, "cpu")
    part = render.render_lap(circuit, SENSOR, "cpu", frames=235 + np.arange(8))
    assert part["left"].shape[0] == 8 and (part["row"] >= 0).sum() == 8
    for f in 235 + np.arange(8):
        k = f % 240
        assert np.array_equal(part["left"][part["row"][k]], whole["left"][k])
        assert np.array_equal(part["right"][part["row"][k]], whole["right"][k])
    assert part["row"][100] == -1
