"""Typed configuration + reference-format YAML ingestion.

Port of ``stereo_visual_odometry_tpu/utils/config.py``: ``RunConfig`` =
dataset/runtime settings + the port's ``VOConfig`` + camera calibration;
``load_reference_yaml`` reads the reference's OpenCV FileStorage YAML key
schema (pure Python).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from ..models.frontend import VOConfig


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Calibration block (``default.yaml:33-47`` / ``parameter.cpp:10-45``)."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    fx2: float | None = None   # right camera; None -> same as left
    fy2: float | None = None
    cx2: float | None = None
    cy2: float | None = None
    baseline: float = 0.537
    t_rl: tuple[float, float, float] | None = None
    R_rl: tuple[float, ...] | None = None  # row-major 3x3


@dataclasses.dataclass(frozen=True)
class RunConfig:
    dataset_dir: str = ""
    camera: CameraConfig = CameraConfig()
    vo: VOConfig = VOConfig()
    max_frames: int = -1
    trajectory_out: str = ""
    seed: int = 0
    overlay_dir: str = ""
    overlay_every: int = 10


def _parse_opencv_yaml(path: str) -> dict[str, Any]:
    """Minimal parser for the reference's flat OpenCV FileStorage YAML."""
    out: dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or line.startswith("---"):
                continue
            m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
            if not m:
                continue
            key, val = m.group(1), m.group(2).strip().strip('"')
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


_TRACK_MODE_MAP = {
    "LK_stereof2f_pnp": "lk",
    "ORB_stereof2f_pnp": "orb",
}


def load_reference_yaml(path: str) -> RunConfig:
    """Build a RunConfig from a reference-format YAML file (same key mapping
    and fallbacks as the JAX package's reader)."""
    kv = _parse_opencv_yaml(path)
    g = kv.get

    def pick(*keys, default=None):
        for k in keys:
            if k in kv:
                return kv[k]
        return default

    vo_default = {f.name: f.default for f in dataclasses.fields(VOConfig)}
    cam = CameraConfig(
        fx=pick("camera_l.fx", "camera1.fx", default=718.856),
        fy=pick("camera_l.fy", "camera1.fy", default=718.856),
        cx=pick("camera_l.cx", "camera1.cx", default=607.1928),
        cy=pick("camera_l.cy", "camera1.cy", default=185.2157),
        fx2=pick("camera_r.fx", "camera2.fx"),
        fy2=pick("camera_r.fy", "camera2.fy"),
        cx2=pick("camera_r.cx", "camera2.cx"),
        cy2=pick("camera_r.cy", "camera2.cy"),
        baseline=abs(g("t_lr0", -0.537)),
        t_rl=(g("t_lr0", -0.537), g("t_lr1", 0.0), g("t_lr2", 0.0)),
        R_rl=tuple(g(f"R_lr{i}", 1.0 if i in (0, 4, 8) else 0.0) for i in range(9)),
    )
    mode = _TRACK_MODE_MAP.get(str(g("track_mode", "ORB_stereof2f_pnp")), "orb")
    ini_th = pick("fIniThFAST", "iniThFAST", default=20)
    vo = VOConfig(
        mode=mode,
        max_features=int(g("nFeatures", 1024)),
        fast_threshold=float(ini_th),
        orb_levels=int(g("nLevels", 8)),
        orb_scale=float(pick("fScaleFactor", "scaleFactor", default=1.2)),
        orb_ini_th=float(ini_th),
        orb_min_th=float(pick("fMinThFAST", "minThFAST", default=7)),
        feature_match_error=float(g("feature_match_error", 2.0)),
        num_hypotheses=int(g("iterationsCount", 512)),
        inlier_px=(float(kv["reprojectionError"])
                   if "reprojectionError" in kv else None),
        min_features_detect=int(g("num_features_init", 30)),
        min_features_track=int(g("num_features_tracking", 10)),
        min_inlier_rate=float(g("inlier_rate", vo_default["min_inlier_rate"])),
        min_move=float(g("minmove", 0.0005)),
        max_move=float(g("maxmove", 10.0)),
    )
    return RunConfig(dataset_dir=str(pick("dataset_path", "dataset_dir", default="")),
                     camera=cam, vo=vo)


def rig_from_config(cam: CameraConfig, device=None, dtype=torch.float32):
    """CameraConfig -> ops.camera.StereoRig on ``device``."""
    from ..ops.camera import Pinhole, StereoRig

    left = Pinhole.create(cam.fx, cam.fy, cam.cx, cam.cy, dtype=dtype, device=device)
    right = Pinhole.create(cam.fx2 or cam.fx, cam.fy2 or cam.fy,
                           cam.cx2 or cam.cx, cam.cy2 or cam.cy,
                           dtype=dtype, device=device)
    R = [list(cam.R_rl[i:i + 3]) for i in (0, 3, 6)] if cam.R_rl else None
    t = list(cam.t_rl) if cam.t_rl else [-cam.baseline, 0.0, 0.0]
    return StereoRig.create(left, right, R_rl=R, t_rl=t)
