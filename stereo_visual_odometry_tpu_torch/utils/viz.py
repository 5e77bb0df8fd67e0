"""Offline visualization: trajectory plots + feature-track overlays.

Port of ``stereo_visual_odometry_tpu/utils/viz.py`` (numpy; matplotlib
where it imports). Replaces the reference's two live OpenCV windows — the
(Px, Pz) trajectory canvas (``reference/src/tracking.cpp:345-353``) and the
green/red keypoint + match-line overlay (``tracking.cpp:354-382``) — with
offline renders: PNG via matplotlib when available, else a pure-numpy PPM
for the trajectory and nothing for the overlay, as in JAX.
"""
from __future__ import annotations

import numpy as np


def plot_trajectory(path: str, poses: np.ndarray,
                    gt: np.ndarray | None = None) -> None:
    """Top-down (x, z) trajectory plot — the reference canvas, offline."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        _ppm_trajectory(path, poses, gt)
        return
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(poses[:, 0, 3], poses[:, 2, 3], "-", lw=1.2, label="estimate")
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def _ppm_trajectory(path: str, poses: np.ndarray, gt=None,
                    size: int = 600) -> None:
    """Dependency-free fallback: dot plot on a canvas, like the reference."""
    canvas = np.full((size, size, 3), 255, np.uint8)
    xs = poses[:, 0, 3]
    zs = poses[:, 2, 3]
    allx = np.concatenate([xs, gt[:, 0, 3]]) if gt is not None else xs
    allz = np.concatenate([zs, gt[:, 2, 3]]) if gt is not None else zs
    span = max(allx.max() - allx.min(), allz.max() - allz.min(), 1e-6)
    scale = (size - 40) / span

    def draw(pxs, pzs, color):
        u = ((pxs - allx.min()) * scale + 20).astype(int)
        v = (size - 20 - (pzs - allz.min()) * scale).astype(int)
        ok = (u >= 0) & (u < size) & (v >= 0) & (v < size)
        canvas[v[ok], u[ok]] = color

    if gt is not None:
        draw(gt[:, 0, 3], gt[:, 2, 3], (0, 160, 0))
    draw(xs, zs, (200, 0, 0))
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (size, size))
        f.write(canvas.tobytes())


def draw_tracks(path: str, img: np.ndarray, prev_xy: np.ndarray,
                cur_xy: np.ndarray, valid: np.ndarray) -> None:
    """Feature overlay (green=prev, red=cur, lines between), offline; writes
    nothing without matplotlib.

    The ``displayTracking`` equivalent (``tracking.cpp:354-382``).
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(img, cmap="gray")
    p = prev_xy[valid]
    c = cur_xy[valid]
    for (x0, y0), (x1, y1) in zip(p, c):
        ax.plot([x0, x1], [y0, y1], "-", color="lime", lw=0.6)
    ax.plot(p[:, 0], p[:, 1], ".", color="lime", ms=2)
    ax.plot(c[:, 0], c[:, 1], ".", color="red", ms=2)
    ax.set_axis_off()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
