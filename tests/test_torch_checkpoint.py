"""Checkpoint / resume (``utils/checkpoint.py``): a resumed port run
continues bit for bit, before and after the BA window's first slide.

The runs: LK at 192x256, 256 features, persistent tracks and
``BackendConfig(window=3, kf_every=2)`` (JAX's ``tests/test_checkpoint.py``)
over 12 frames on the CPU. Keyframes fall on frames 1, 3, 5, 7, ...; the
fourth (frame 7) slides the window and builds the marginalization prior.
The straight run saves after frames 4 and 8; a fresh ``System`` steps one
frame (the state's structure), loads, and runs the rest.

Tolerances: the port's resumed poses equal the straight run's exactly (the
CPU sums in a fixed order; the generator, the state, the backend and its
prior come back as they were), as do the keyframe count and the prior.
JAX's own test holds its resume from frame 4 to 1e-5; from frame 8 the JAX
checkpoint, which drops the prior, moves a later keyframe's pose by more
than 1e-4 (the reference defect ROADMAP Queue 3 records).
"""
import copy

import numpy as np
import pytest
import torch

from stereo_visual_odometry_tpu.models.backend import BackendConfig as JBackendConfig
from stereo_visual_odometry_tpu.models.frontend import VOConfig as JVOConfig
from stereo_visual_odometry_tpu.models.system import System as JSystem
from stereo_visual_odometry_tpu.utils import checkpoint as jcheckpoint
from stereo_visual_odometry_tpu.utils.config import CameraConfig as JCamera
from stereo_visual_odometry_tpu.utils.config import RunConfig as JRunConfig
from stereo_visual_odometry_tpu_torch.models.backend import BackendConfig
from stereo_visual_odometry_tpu_torch.models.frontend import VOConfig
from stereo_visual_odometry_tpu_torch.models.system import System
from stereo_visual_odometry_tpu_torch.utils import checkpoint, synthetic
from stereo_visual_odometry_tpu_torch.utils.config import CameraConfig, RunConfig
from stereo_visual_odometry_tpu_torch.utils.tree import tree_leaves, tree_pairs

N_FRAMES = 12
SAVES = (4, 8)  # after these many frames; 8 is after the first slide (frame 7)
VO = dict(mode="lk", height=192, width=256, max_features=256, num_hypotheses=128,
          min_features_track=8, min_inlier_rate=0.3, persistent_tracks=True)
BACKEND = dict(window=3, kf_every=2, max_landmarks=128, max_obs=1024, ba_iters=4)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.render_sequence(n_frames=N_FRAMES, h=192, w=256, fx=300.0, speed=1.0)
    rp = seq["rig"]
    cam = dict(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"], baseline=rp["baseline"])
    return list(zip(seq["images_l"], seq["images_r"])), cam


def _port(cam):
    return System(RunConfig(camera=CameraConfig(**cam), vo=VOConfig(**VO)), device="cpu",
                  backend_cfg=BackendConfig(**BACKEND))


def _jax(cam):
    return JSystem(JRunConfig(camera=JCamera(**cam), vo=JVOConfig(**VO)),
                   backend_cfg=JBackendConfig(**BACKEND))


def _straight(make, save, frames, cam, tmp):
    """Run every frame, saving after each of ``SAVES``; returns the system,
    the checkpoint paths and a copy of what each save held."""
    sys_ = make(cam)
    paths, snaps = {}, {}
    for i, (il, ir) in enumerate(frames):
        sys_.step(il, ir)
        if i + 1 in SAVES:
            paths[i + 1] = str(tmp / f"{make.__name__}_{i + 1}.npz")
            save(paths[i + 1], sys_)
            snaps[i + 1] = copy.deepcopy({
                "backend": sys_.backend, "state": sys_.state,
                "rng": sys_.generator.get_state() if hasattr(sys_, "generator") else None,
                "status": (sys_.frame_idx, sys_.status, sys_.lost_count)})
    return sys_, paths, snaps


def _resume(make, load, path, start, frames, cam):
    sys_ = make(cam)
    sys_.step(*frames[0])  # builds the state structure
    load(path, sys_)
    assert len(sys_.poses) == start
    for il, ir in frames[start:]:
        sys_.step(il, ir)
    return sys_


@pytest.fixture(scope="module")
def port_straight(frames, tmp_path_factory):
    fr, cam = frames
    return _straight(_port, checkpoint.save, fr, cam, tmp_path_factory.mktemp("ckpt"))


@pytest.mark.parametrize("start", SAVES)
def test_checkpoint_resume_exact(frames, port_straight, start):
    """JAX's ``test_checkpoint_resume_exact`` (``start=4``), and the resume
    after the window's first slide (``start=8``) that the JAX checkpoint
    gets wrong."""
    fr, cam = frames
    full, paths, snaps = port_straight
    prior = snaps[start]["backend"].prior
    assert (prior is not None) == (start == 8), "8 must come after the first slide, 4 before"
    resumed = _resume(_port, checkpoint.load, paths[start], start, fr, cam)
    np.testing.assert_array_equal(np.stack(resumed.poses), np.stack(full.poses))
    assert resumed.backend.frame_of_kf == full.backend.frame_of_kf
    assert len(resumed.backend.kf_poses) == len(full.backend.kf_poses)
    assert sum("ba" in m for m in resumed.metrics) == sum(
        "ba" in m for m in full.metrics[start:])
    for k in full.backend.prior:
        np.testing.assert_array_equal(resumed.backend.prior[k], full.backend.prior[k])


def test_checkpoint_restores_every_field(frames, port_straight):
    """What ``load`` writes back, field by field, against the saving run at
    frame 8: the generator, the state's leaves, the backend's tables,
    ``_last_kf_n_tracked`` and the prior."""
    fr, cam = frames
    _, paths, snaps = port_straight
    ref = snaps[8]
    got = _port(cam)
    got.step(*fr[0])
    checkpoint.load(paths[8], got)
    assert (got.frame_idx, got.status, got.lost_count) == ref["status"]
    assert torch.equal(got.generator.get_state(), ref["rng"])
    pairs = tree_pairs(ref["state"], got.state)
    assert len(pairs) == len(tree_leaves(got.state)) > 10
    for path, want, have in pairs:
        assert want.dtype == have.dtype and torch.equal(want, have), path
    rb, gb = ref["backend"], got.backend
    assert gb._last_kf_n_tracked == rb._last_kf_n_tracked > 0
    assert gb._frames_since_kf == rb._frames_since_kf
    assert gb.frame_of_kf == rb.frame_of_kf
    np.testing.assert_array_equal(np.stack(gb.kf_poses), np.stack(rb.kf_poses))
    assert gb.landmarks.keys() == rb.landmarks.keys()
    for t in rb.landmarks:
        np.testing.assert_array_equal(gb.landmarks[t], rb.landmarks[t])
    assert [list(o) for o in gb.kf_obs] == [list(o) for o in rb.kf_obs]
    for go, ro in zip(gb.kf_obs, rb.kf_obs):
        for t, (uv, uv_r) in ro.items():
            np.testing.assert_array_equal(go[t][0], uv)
            assert (go[t][1] is None) == (uv_r is None)
    assert sorted(gb.prior) == ["H", "T_lin", "b", "mask"]
    for k, v in rb.prior.items():
        assert gb.prior[k].dtype == v.dtype
        np.testing.assert_array_equal(gb.prior[k], v)
    with pytest.raises(ValueError, match="step one frame"):
        checkpoint.load(paths[8], _port(cam))


def test_jax_checkpoint_drops_the_prior(frames, port_straight, tmp_path):
    """The reference defect: the JAX checkpoint keeps neither the prior nor
    ``_last_kf_n_tracked``, so its resume from frame 8 leaves the straight
    run's trajectory at the next solve; the port's keys are JAX's plus the
    prior's."""
    fr, cam = frames
    full, paths, snaps = _straight(_jax, jcheckpoint.save, fr, cam, tmp_path)
    assert snaps[8]["backend"].prior is not None
    resumed = _resume(_jax, jcheckpoint.load, paths[8], 8, fr, cam)
    gap = np.abs(np.stack(resumed.poses) - np.stack(full.poses)).max(axis=(1, 2))
    assert gap[:8].max() == 0.0
    assert gap[8:].max() > 1e-4, gap
    # The state's leaves are each package's own (``leaf_0`` ... in pytree
    # order); every other key is JAX's, plus the prior.
    ours, theirs = ({k for k in np.load(p).files if not k.startswith("leaf_")}
                    for p in (port_straight[1][8], paths[8]))
    assert ours - theirs == {"prior_H", "prior_b", "prior_T_lin", "prior_mask"}
    assert theirs <= ours
