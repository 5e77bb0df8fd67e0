"""Synthetic stereo sequences with exact ground-truth ego-motion.

A numpy copy of ``stereo_visual_odometry_tpu/utils/synthetic.py`` (the JAX
package pulls in ``jax`` on any import, so the port keeps its own; a test
holds the two outputs equal). The frames render on a pool of threads
(``np.add.at`` releases the GIL), each with the sequential arithmetic, so
the images are the JAX package's bit for bit.

The reference has no test data and no tests (SURVEY.md §4); this generator
provides the "short synthetic sequences with known ego-motion" its test plan
calls for, and stands in for KITTI when the dataset is absent. A static 3-D
blob cloud is splatted into both cameras of a rectified rig along a smooth
trajectory — enough texture for FAST/ORB/LK, with analytically known poses
for ATE/RPE assertions.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def smooth_trajectory(n_frames: int, speed: float = 0.8, yaw_rate: float = 0.004,
                      ) -> np.ndarray:
    """(n_frames, 4, 4) world_from_camera poses: forward motion + gentle yaw.

    Camera convention: +z forward, +x right, +y down (KITTI). ``yaw_rate``
    is the per-frame yaw amplitude (rad); raise it for yaw-heavy stress
    sequences (VERDICT r4 next #7).
    """
    poses = [np.eye(4)]
    for i in range(1, n_frames):
        yaw = yaw_rate * np.sin(i * 0.05)
        c, s = np.cos(yaw), np.sin(yaw)
        dR = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        dT = np.eye(4)
        dT[:3, :3] = dR
        dT[:3, 3] = [0.0, 0.0, speed]
        poses.append(poses[-1] @ dT)
    return np.stack(poses)


def make_cloud(n_points: int, extent=(40.0, 8.0, 120.0), z_min: float = 3.0,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    pts = np.stack([
        rng.uniform(-extent[0], extent[0], n_points),
        rng.uniform(-extent[1] * 0.25, extent[1], n_points),  # mostly below horizon
        rng.uniform(z_min, extent[2], n_points),
    ], axis=-1)
    intens = rng.uniform(60.0, 255.0, n_points)
    return pts, intens


def _make_stamps(n_points: int, radius: int, seed: int) -> np.ndarray:
    """Per-point random texture stamps (Gaussian envelope x random pattern).

    Distinct appearance per landmark makes descriptor matching well-posed;
    identical blobs would alias under Hamming matching.
    """
    rng = np.random.default_rng(seed + 77)
    size = 2 * radius + 1
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    envelope = np.exp(-(xs ** 2 + ys ** 2) / (2.0 * (radius * 0.55) ** 2))
    patterns = 0.15 + 0.85 * rng.random((n_points, size, size))
    return envelope[None] * patterns


def _splat(img: np.ndarray, uv: np.ndarray, z: np.ndarray, intens: np.ndarray,
           stamps: np.ndarray, idx: np.ndarray, radius: int = 3) -> None:
    """Accumulate per-point stamps with bilinear subpixel placement.

    Vectorized: one ``np.add.at`` scatter per bilinear corner.
    """
    h, w = img.shape
    size = 2 * radius + 1
    iu = np.floor(uv[:, 0]).astype(int)
    iv = np.floor(uv[:, 1]).astype(int)
    keep = ((iu >= radius + 1) & (iu < w - radius - 2) &
            (iv >= radius + 1) & (iv < h - radius - 2))
    if not np.any(keep):
        return
    iu, iv = iu[keep], iv[keep]
    fu = (uv[keep, 0] - iu)[:, None, None]
    fv = (uv[keep, 1] - iv)[:, None, None]
    st = stamps[idx[keep]] * intens[keep, None, None]  # (M, size, size)
    oy, ox = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    rows = iv[:, None, None] + oy[None]
    cols = iu[:, None, None] + ox[None]
    for dy, dx, wgt in ((0, 0, (1 - fv) * (1 - fu)), (0, 1, (1 - fv) * fu),
                        (1, 0, fv * (1 - fu)), (1, 1, fv * fu)):
        np.add.at(img, (rows + dy, cols + dx), wgt * st)


def render_sequence(n_frames: int = 30, h: int = 240, w: int = 320,
                    fx: float = 250.0, baseline: float = 0.54,
                    n_points: int = 3000, speed: float = 0.8,
                    seed: int = 0, yaw_rate: float = 0.004,
                    flicker: float = 0.0, dropout: float = 0.0,
                    cloud_extent: tuple | None = None):
    """Render a synthetic rectified stereo sequence.

    Stress knobs (VERDICT r4 next #7 — adversarial variants):
      yaw_rate: per-frame yaw amplitude (rad); 0.004 = the default gentle
        curve, ~0.02 = yaw-heavy (rotation-dominant optical flow).
      flicker: photometric gain modulation amplitude; frame f is scaled by
        1 + flicker*sin(1.3 f) with an additive offset — breaks brightness
        constancy the way auto-exposure does.
      dropout: fraction of the landmark cloud removed inside a moving
        angular sector — large textureless regions sweep through the view.
      cloud_extent: (x, y, z_max) landmark-cloud bounds; MUST cover the
        trajectory (z_max > n_frames*speed + ~60) for long sequences or
        the camera drives past the last landmarks and tracking starves.
        None = the default (40, 8, 120), fine for <= ~60 frames.

    Returns dict(images_l, images_r: (n, h, w) float32 in [0, 255];
    poses_gt: (n, 4, 4) world_from_camera; rig_params for StereoRig).
    """
    cx, cy = w / 2.0, h / 2.0
    poses = smooth_trajectory(n_frames, speed=speed, yaw_rate=yaw_rate)
    if cloud_extent is not None:
        pts_w, intens = make_cloud(n_points, extent=cloud_extent, seed=seed)
    else:
        pts_w, intens = make_cloud(n_points, seed=seed)
    radius = 6
    stamps = _make_stamps(n_points, radius, seed)

    imgs_l = np.zeros((n_frames, h, w), np.float32)
    imgs_r = np.zeros((n_frames, h, w), np.float32)
    ids = np.arange(n_points)
    # Textureless sector: points whose world azimuth falls in a slowly
    # rotating wedge are dropped for the whole run-through of the wedge.
    az = np.arctan2(pts_w[:, 0], pts_w[:, 2])

    def render_frame(f):
        T_cw = np.linalg.inv(poses[f])
        pc = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        vis = pc[:, 2] > 0.5
        if dropout > 0.0:
            width_rad = dropout * np.pi  # wedge angular width
            center = -np.pi / 2 + (f / max(n_frames - 1, 1)) * np.pi
            in_wedge = np.abs(np.angle(np.exp(1j * (az - center)))) < width_rad / 2
            vis &= ~in_wedge
        p = pc[vis]
        it = intens[vis]
        idx = ids[vis]
        ul = np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], -1)
        ur = np.stack([fx * (p[:, 0] - baseline) / p[:, 2] + cx,
                       fx * p[:, 1] / p[:, 2] + cy], -1)
        left = np.full((h, w), 64.0, np.float32)
        right = np.full((h, w), 64.0, np.float32)
        _splat(left, ul, p[:, 2], it, stamps, idx, radius)
        _splat(right, ur, p[:, 2], it, stamps, idx, radius)
        if flicker > 0.0:
            gain = 1.0 + flicker * np.sin(1.3 * f)
            offset = 8.0 * flicker * np.cos(0.7 * f)
            left = left * gain + offset
            right = right * gain + offset
        imgs_l[f] = np.clip(left, 0, 255)
        imgs_r[f] = np.clip(right, 0, 255)

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1, n_frames))) as pool:
        list(pool.map(render_frame, range(n_frames)))
    return {
        "images_l": imgs_l,
        "images_r": imgs_r,
        "poses_gt": poses.astype(np.float64),
        "rig": dict(fx=fx, fy=fx, cx=cx, cy=cy, baseline=baseline),
    }
