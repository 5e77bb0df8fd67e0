"""The frame source: a closed circuit through a seeded cloud of textured
points, rendered on the device at set-up.

The scene model is the repository's synthetic generator
(``stereo_visual_odometry_tpu_torch/utils/synthetic.py``: a static cloud of
points, each with its own random stamp, splatted with bilinear weights into
both cameras of a rectified rig over a 64.0 background, clipped to
[0, 255]), copied here in PyTorch so that the yardstick does not move with
the program. ``render_frames`` is that model for any poses; a test holds it
to the numpy generator.

The drive is one closed lap (``circuit_poses``) whose speed and turn rate
vary smoothly along it, so that every frame's true motion is its own; a lap
ends exactly where it started, and a run continues lap after lap with
smooth motion. The points line the track (``make_scene``). Frames are
rendered at the sensor's raw size, rounded to whole grey levels (as decoded
PNGs are) and edge-padded to the padded size, then handed over as float32
host arrays.

The scene is one per traffic mix (its ``scene_seed``): a run's ``--seed``
sets where on the lap its sequences start and its RANSAC draws, so every
run does the same work in another order (scenes drawn per run made ATE
differ by 11–29% from run to run). Accumulation is exact: each stamp tap is
added in 2**-20 fixed point as a 64-bit integer, so the frames are the same
bit for bit whatever order the device adds in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RADIUS = 6                     # stamp radius (px), the generator's
BACKGROUND = 64.0
_FIXED = float(1 << 20)


def circuit_poses(lap: dict) -> np.ndarray:
    """(lap_frames, 4, 4) float64 world_from_camera poses of one lap: +z
    forward, +x right, +y down. Frame f moves ``speed_m * (1 + speed_swing *
    cos(2 pi speed_waves f / N))`` along its heading and then yaws by
    ``2 pi / N * (1 + yaw_swing * sin(2 pi yaw_waves f / N))`` (N the lap's
    frames; the generator's step, with a varying rate). The yaws sum to
    2 pi over a lap, and with the traffic files' wave counts (5 for the
    yaw, 3 for the speed) the positions close to rounding (a test holds
    it): the lap ends where it started, so frame N is frame 0 again, and
    every frame's true motion is its own."""
    n = lap["lap_frames"]
    f = np.arange(n)
    speed = lap["speed_m"] * (1.0 + lap["speed_swing"]
                              * np.cos(2 * np.pi * lap["speed_waves"] * f / n))
    yaw = 2 * np.pi / n * (1.0 + lap["yaw_swing"] * np.sin(2 * np.pi * lap["yaw_waves"] * f / n))
    poses = [np.eye(4)]
    for k in range(n - 1):
        c, s = math.cos(yaw[k]), math.sin(yaw[k])
        step = np.array([[c, 0.0, s, 0.0], [0.0, 1.0, 0.0, 0.0], [-s, 0.0, c, speed[k]],
                         [0.0, 0.0, 0.0, 1.0]])
        poses.append(poses[-1] @ step)
    return np.stack(poses)


def make_scene(poses: np.ndarray, lap: dict, generator: torch.Generator, device) -> dict:
    """The seeded cloud along the lap ``poses``: points (n, 3) float64,
    intensities (n,) in [60, 255) and stamps (n, 13, 13) float32, drawn on
    ``device`` from ``generator`` in a few calls. Point i sits at arc length
    (i + u) / n of the closed track (one per stratum: uniform along it), up
    to ``half_width_m`` to either side of it and at a height in
    ``heights_m`` (the generator's cloud: mostly below the horizon)."""
    n = lap["points"]
    pos = torch.as_tensor(np.concatenate([poses[:, :3, 3], poses[:1, :3, 3]]), device=device)
    side = torch.as_tensor(np.concatenate([poses[:, :3, 0], poses[:1, :3, 0]]), device=device)
    arc = torch.cat([torch.zeros(1, device=device, dtype=torch.float64),
                     torch.cumsum(torch.linalg.norm(pos[1:] - pos[:-1], dim=1), 0)])
    u = torch.rand((4, n), generator=generator, device=device, dtype=torch.float64)
    s = arc[-1] * (torch.arange(n, device=device) + u[0]) / n
    k = torch.searchsorted(arc, s, right=True).clamp(1, len(arc) - 1) - 1
    a = ((s - arc[k]) / (arc[k + 1] - arc[k]))[:, None]
    centre = pos[k] + a * (pos[k + 1] - pos[k])
    across = side[k] + a * (side[k + 1] - side[k])
    lo, hi = lap["heights_m"]
    pts = centre + lap["half_width_m"] * (2.0 * u[1] - 1.0)[:, None] * across
    pts[:, 1] = lo + u[2] * (hi - lo)
    intens = (60.0 + 195.0 * u[3]).to(torch.float32)
    size = 2 * RADIUS + 1
    ys, xs = torch.meshgrid(torch.arange(-RADIUS, RADIUS + 1, device=device),
                            torch.arange(-RADIUS, RADIUS + 1, device=device), indexing="ij")
    envelope = torch.exp(-(xs ** 2 + ys ** 2) / (2.0 * (RADIUS * 0.55) ** 2)).to(torch.float32)
    patterns = 0.15 + 0.85 * torch.rand((n, size, size), generator=generator, device=device)
    return {"points": pts, "intens": intens, "stamps": envelope * patterns}


def render_frames(points: torch.Tensor, intens: torch.Tensor, stamps: torch.Tensor,
                  poses: np.ndarray, fx: float, baseline: float, h: int, w: int,
                  max_depth: float = math.inf) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, h, w) float32 left and right images of the scene seen from
    ``poses`` (F world_from_camera), on the points' device: each point with
    0.5 < depth < ``max_depth`` splats its stamp times its intensity with
    bilinear weights where the whole stamp lands inside the image (the
    generator's rule), over the background, clipped to [0, 255]."""
    dev = points.device
    cx, cy = w / 2.0, h / 2.0
    T_cw = torch.as_tensor(np.linalg.inv(poses), device=dev)          # (F, 4, 4)
    pc = torch.einsum("fij,pj->fpi", T_cw[:, :3, :3], points) + T_cw[:, None, :3, 3]
    n_f = len(poses)
    f_idx, p_idx = torch.nonzero((pc[..., 2] > 0.5) & (pc[..., 2] < max_depth), as_tuple=True)
    p = pc[f_idx, p_idx]
    v = fx * p[:, 1] / p[:, 2] + cy
    out = []
    for shift in (0.0, baseline):
        u = fx * (p[:, 0] - shift) / p[:, 2] + cx
        img = torch.zeros(n_f * h * w, dtype=torch.int64, device=dev)
        _splat(img, torch.stack([u, v], -1), f_idx, p_idx, intens, stamps, h, w)
        img = img.view(n_f, h, w).to(torch.float64) / _FIXED + BACKGROUND
        out.append(img.clamp(0.0, 255.0).to(torch.float32))
    return out[0], out[1]


def _splat(img: torch.Tensor, uv: torch.Tensor, f_idx: torch.Tensor, p_idx: torch.Tensor,
           intens: torch.Tensor, stamps: torch.Tensor, h: int, w: int) -> None:
    """Add each point's stamp into the flat (F*h*w) fixed-point images at
    its bilinear corners (the generator's ``_splat``)."""
    iu, iv = torch.floor(uv[:, 0]).long(), torch.floor(uv[:, 1]).long()
    keep = ((iu >= RADIUS + 1) & (iu < w - RADIUS - 2) &
            (iv >= RADIUS + 1) & (iv < h - RADIUS - 2))
    iu, iv, f, pi = iu[keep], iv[keep], f_idx[keep], p_idx[keep]
    fu = (uv[keep, 0] - iu).to(torch.float32)[:, None, None]
    fv = (uv[keep, 1] - iv).to(torch.float32)[:, None, None]
    st = stamps[pi] * intens[pi, None, None]
    off = torch.arange(-RADIUS, RADIUS + 1, device=img.device)
    base = f[:, None, None] * (h * w) + (iv[:, None, None] + off[None, :, None]) * w \
        + iu[:, None, None] + off[None, None, :]
    for dy, dx, wgt in ((0, 0, (1 - fv) * (1 - fu)), (0, 1, (1 - fv) * fu),
                        (1, 0, fv * (1 - fu)), (1, 1, fv * fu)):
        vals = torch.round((wgt * st).to(torch.float64) * _FIXED).long()
        img.index_add_(0, (base + dy * w + dx).reshape(-1), vals.reshape(-1))


def render_lap(circuit: dict, sensor: dict, device, frames=None, extra: int = 0,
               batch: int = 16) -> dict:
    """Render the circuit's lap for the sensor on ``device``, its scene drawn
    from the circuit's ``scene_seed``: the lap's ``poses`` (float64); host
    float32 arrays ``left`` and ``right`` of the lap frames ``frames`` (lap
    after lap; all of them where None), whole grey levels, edge-padded from
    the raw to the padded size; and ``row``, each lap frame's row in them
    (-1 where not rendered). With every frame rendered, ``extra`` more rows
    repeat the first ones, so that a sequence may run past the lap's end in
    one strided view. A frame is the same bit for bit whichever others are
    rendered with it."""
    poses = circuit_poses(circuit)
    gen = torch.Generator(device=device).manual_seed(circuit["scene_seed"])
    scene = make_scene(poses, circuit, gen, device)
    (h, w), (hp, wp) = sensor["raw_hw"], sensor["padded_hw"]
    n = len(poses)
    idx = np.arange(n) if frames is None else np.unique(np.asarray(frames) % n)
    extra = extra if frames is None else 0
    left = np.empty((len(idx) + extra, hp, wp), np.float32)
    right = np.empty_like(left)
    for start in range(0, len(idx), batch):
        stop = min(start + batch, len(idx))
        pair = render_frames(scene["points"], scene["intens"], scene["stamps"],
                             poses[idx[start:stop]], sensor["fx"], sensor["baseline_m"], h, w,
                             circuit["max_depth_m"])
        for dst, img in zip((left, right), pair):
            img = torch.nn.functional.pad(torch.round(img)[:, None], (0, wp - w, 0, hp - h),
                                          mode="replicate")[:, 0]
            dst[start:stop] = img.cpu().numpy()
    left[len(idx):] = left[:extra]
    right[len(idx):] = right[:extra]
    row = np.full(n, -1, np.int64)
    row[idx] = np.arange(len(idx))
    return {"left": left, "right": right, "poses": poses, "row": row}
