"""Tiny rehearsal sizes for the CPU tests: every cell's driver, on the CPU,
at a 128x416 sensor and a 240-frame lap (widths of the step kept in
proportion: fx scaled with the image)."""
from __future__ import annotations

import torch

from vobench import run

SEED = 3_000_000_123          # above 2**31, as the driver's are
SENSOR = {"raw_hw": [120, 400], "padded_hw": [128, 416], "fx": 232.0, "baseline_m": 0.537}
CIRCUIT = {"scene_seed": 2012, "lap_frames": 240, "speed_m": 1.1, "speed_swing": 0.2,
           "speed_waves": 3, "yaw_swing": 0.5, "yaw_waves": 5, "points": 8000,
           "half_width_m": 15.0, "heights_m": [-2.0, 8.0], "max_depth_m": 60.0}
TRAFFIC = {
    "lk_dense.offline_s11": {"sequences": 2, "frames_per_sequence": 9, "chunk": 4},
    "orb.offline_s1": {"chunk": 4, "segment_frames": 5},
    "lk_dense.online_10hz": {"segment_frames": 6, "rate_hz": 6.0},
}
SECONDS = {"orb.offline_s1": 4.0}      # ORB's eager step is the slowest on the CPU
# The tiny sensor's own limits: its sound runs read up to about half of the
# pose numbers' (K1 is a gather: exact; K2 a float32 blend: to rounding).
LIMITS = {"ate_max_m": 0.6, "step_rot_max_rad": 0.05, "step_trans_max_m": 0.9,
          "rejected_share": 0.0, "k1_err": 0.0}
ORB_LIMITS = {"k2_err": 1e-3}


def overrides(workload: str) -> dict:
    orb = workload.startswith("orb")
    return {"config": {"sensor": SENSOR, "vo": {"height": 128, "width": 416,
                                                "max_features": 512 if orb else 256}},
            "traffic": dict(TRAFFIC[workload], circuit=CIRCUIT),
            "limits": dict(LIMITS, **(ORB_LIMITS if orb else {}))}


def run_tiny(workload: str, seconds: float | None = None, seed: int = SEED, shards: int = 1,
             calls=None) -> dict:
    """One run of ``workload`` at the tiny size on the CPU (over a mesh of
    ``shards`` CPU shards for a batch), on two threads; ``calls``: a
    ``trace.KernelCalls`` with a kernel swapped."""
    torch.set_num_threads(2)
    devices = [torch.device("cpu")] * shards
    return run.run_cell(workload, seed, seconds or SECONDS.get(workload, 2.0), False, devices,
                        overrides(workload), calls=calls)
