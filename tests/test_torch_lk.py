"""Port parity: the dense LK level tracker, ``track`` and ``circular_track``
against the JAX dense path with its Pallas window kernel in interpret mode.

The JAX CPU default (``lk_backend='auto'``) runs another tracker (the XLA
``_level_track``), so the JAX side here is forced onto the dense path and
its ``extract_windows_int`` is patched to interpret mode for the test.

Inputs: the port's synthetic frames (seeded, 192x256), pyramids built by
the JAX package, FAST/top-K keypoints; both sides get the same arrays.
Tolerances: flow within 1e-3 px where both sides keep a point, and the ok
masks agreeing on >= 99% of points. The dots and sums run in another order
(float32 ulps), which can move a point across a pixel-cell boundary at a
different inner iteration, or flip a gate that sits on its threshold.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_visual_odometry_tpu.ops import camera as jcam
from stereo_visual_odometry_tpu.ops import fast as jfast
from stereo_visual_odometry_tpu.ops import lk as jlk
from stereo_visual_odometry_tpu.ops import lk_dense as jlkd
from stereo_visual_odometry_tpu.ops import patch_pallas
from stereo_visual_odometry_tpu.ops import pyramid as jpyr
from stereo_visual_odometry_tpu.ops import se3 as jse3
from stereo_visual_odometry_tpu.ops import select as jsel
from stereo_visual_odometry_tpu.ops import stereo_sweep as jsweep
from stereo_visual_odometry_tpu_torch.ops import camera as tcam
from stereo_visual_odometry_tpu_torch.ops import lk as tlk
from stereo_visual_odometry_tpu_torch.ops import lk_dense as tlkd
from stereo_visual_odometry_tpu_torch.utils import synthetic

H, W, FX = 192, 256, 300.0
FLOW_ATOL = 1e-3
OK_AGREE = 0.99


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))  # the suite runs several workers at once
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = patch_pallas.extract_windows_int
    monkeypatch.setattr(
        patch_pallas, "extract_windows_int",
        lambda img, corners, S, interpret=False: orig(img, corners, S, interpret=True))


@pytest.fixture(scope="module")
def scene():
    seq = synthetic.render_sequence(n_frames=2, h=H, w=W, fx=FX, speed=1.0, seed=2)
    pyr = {name: [np.array(p) for p in jpyr.build_pyramid(jnp.asarray(img), 4)]
           for name, img in (("t1l", seq["images_l"][0]), ("t1r", seq["images_r"][0]),
                             ("t2l", seq["images_l"][1]), ("t2r", seq["images_r"][1]))}
    score = jfast.detect(jnp.asarray(seq["images_l"][0]), 20.0)
    xy, _, valid = jsel.grid_top_k(score, 256, cell=32, k_per_cell=8)
    xy = jsel.subpixel_refine(score, xy, valid, use_pallas=False)
    return seq, pyr, np.array(xy), np.array(valid)


def to_t(levels):
    return tuple(torch.from_numpy(a) for a in levels)


def to_j(levels):
    return tuple(jnp.asarray(a) for a in levels)


def assert_tracks_agree(pt, okt, pj, okj):
    pt, okt = pt.numpy(), okt.numpy()
    pj, okj = np.asarray(pj), np.asarray(okj)
    assert (okt == okj).mean() >= OK_AGREE, (okt == okj).mean()
    both = okt & okj
    assert both.sum() > 0.3 * len(both), both.sum()
    np.testing.assert_allclose(pt[both], pj[both], atol=FLOW_ATOL, rtol=0)


def pad_level(img, win=21):
    pad = (win - 1) // 2 + 2
    eh = (-(img.shape[0] + 2 * pad)) % 8
    ew = (-(img.shape[1] + 2 * pad)) % 128
    return np.pad(img, ((pad, pad + eh), (pad, pad + ew)), mode="edge"), pad


@pytest.mark.parametrize("level,rounds,radius", [(0, 4, 6), (1, 8, 20)])
def test_level_track_dense(scene, level, rounds, radius):
    _, pyr, xy, valid = scene
    ip, pad = pad_level(pyr["t1l"][level])
    inx, _ = pad_level(pyr["t2l"][level])
    pts = xy / 2.0 ** level
    guess = np.zeros_like(pts)
    fj, okj = jlkd.level_track_dense(
        jnp.asarray(ip), jnp.asarray(inx), jnp.asarray(pts), jnp.asarray(guess),
        search_radius=radius, pad=pad, rounds=rounds, interpret=True,
        active=jnp.asarray(valid))
    ft, okt = tlkd.level_track_dense(
        torch.from_numpy(ip), torch.from_numpy(inx), torch.from_numpy(pts),
        torch.from_numpy(guess), search_radius=radius, pad=pad, rounds=rounds,
        active=torch.from_numpy(valid))
    assert_tracks_agree(ft, okt, fj, okj)
    assert not okt.numpy()[~valid].any()


def test_track_two_levels_with_prior(scene, pallas_interpret):
    _, pyr, xy, valid = scene
    prior = np.tile(np.array([[0.5, 2.0]], np.float32), (len(xy), 1))
    nj, okj = jlk.track(to_j(pyr["t1l"]), to_j(pyr["t2l"]), jnp.asarray(xy),
                        levels=2, use_pallas=True, pallas_kernel="dense",
                        init_flow=jnp.asarray(prior), active=jnp.asarray(valid),
                        rounds_coarse=4, rounds_refine=2)
    nt, okt = tlk.track(to_t(pyr["t1l"]), to_t(pyr["t2l"]), torch.from_numpy(xy),
                        levels=2, use_pallas=True, pallas_kernel="dense",
                        init_flow=torch.from_numpy(prior),
                        active=torch.from_numpy(valid), rounds_coarse=4,
                        rounds_refine=2)
    assert_tracks_agree(nt, okt, nj, okj)


def test_circular_track_sweep_and_motion_prior(scene, pallas_interpret):
    seq, pyr, xy, valid = scene
    rp = seq["rig"]
    jrig = jcam.StereoRig.kitti(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"],
                                baseline=rp["baseline"])
    trig = tcam.StereoRig.kitti(fx=FX, fy=FX, cx=rp["cx"], cy=rp["cy"],
                                baseline=rp["baseline"])
    # Motion-model prior: the true inter-frame motion, slightly off.
    T_gt = np.linalg.inv(seq["poses_gt"][1]) @ seq["poses_gt"][0]
    T_pred = (np.array(jse3.se3_exp(jnp.asarray([0.01, 0.0, -0.02, 0.0, 0.001, 0.0])))
              @ T_gt).astype(np.float32)
    dmap = np.array(jsweep.disparity_sweep(jnp.asarray(pyr["t1l"][2]),
                                           jnp.asarray(pyr["t1r"][2]), d_max=48))
    pyrs = ("t1l", "t1r", "t2r", "t2l")
    qj = jlk.circular_track(
        tuple(to_j(pyr[k]) for k in pyrs), jnp.asarray(xy), jnp.asarray(valid),
        use_pallas=True, pallas_kernel="dense", rig=jrig,
        T_pred=jnp.asarray(T_pred), use_sweep=True, sweep_d_max=48,
        stereo_levels=1, temporal_levels=2, dmap_prev=jnp.asarray(dmap),
        rounds_prior=4, rounds_coarse=8, rounds_refine=2)
    qt = tlk.circular_track(
        tuple(to_t(pyr[k]) for k in pyrs), torch.from_numpy(xy),
        torch.from_numpy(valid), use_pallas=True, pallas_kernel="dense", rig=trig,
        T_pred=torch.from_numpy(T_pred), use_sweep=True, sweep_d_max=48,
        stereo_levels=1, temporal_levels=2, dmap_prev=torch.from_numpy(dmap),
        rounds_prior=4, rounds_coarse=8, rounds_refine=2)
    np.testing.assert_array_equal(qt["dmap"].numpy(), np.asarray(qj["dmap"]))
    okt, okj = qt["valid"].numpy(), np.asarray(qj["valid"])
    assert (okt == okj).mean() >= OK_AGREE
    both = okt & okj
    assert both.sum() > 0.3 * valid.sum(), both.sum()
    for k in ("t1r", "t2r", "t2l"):
        np.testing.assert_allclose(qt[k].numpy()[both], np.asarray(qj[k])[both],
                                   atol=FLOW_ATOL, rtol=0)
