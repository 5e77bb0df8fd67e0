"""KITTI odometry dataset ingestion.

Port of ``stereo_visual_odometry_tpu/utils/kitti.py`` (numpy + PIL, no
torch needed). Replaces ``System::NextFrame_kitti`` (``reference/src/System.cpp:
75-104``): grayscale stereo pairs from ``dataset_dir/image_0/%06d.png`` and
``image_1/%06d.png``. (The reference computes a 0.5x resize and then throws
it away — ``System.cpp:93-101`` — a bug we do not reproduce; images are used
at native resolution, padded to static shapes.)

Decoding is PIL's, the JAX package's own path when its native C++ loader
(``native/loader.py``) is absent (``kitti.py:62-68``); the port's native
loader comes with slice 5 (ROADMAP.md Queue 1). Images are padded
(bottom/right, edge-replicated) to the static shape the step's CUDA graph
was captured for.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-pad (bottom/right) to the static (h, w). Asserts img fits."""
    ih, iw = img.shape
    assert ih <= h and iw <= w, (img.shape, h, w)
    return np.pad(img, ((0, h - ih), (0, w - iw)), mode="edge")


def static_shape_for(h: int, w: int, cell: int = 32, pyr: int = 8) -> tuple[int, int]:
    """Smallest (H, W) >= (h, w) divisible by both ``cell`` and ``2**pyr_levels-ish``."""
    m = np.lcm(cell, pyr)
    H = int(-(-h // m) * m)
    W = int(-(-w // m) * m)
    return H, W


def _decode_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


class KittiStereoDataset:
    """Indexed access to a KITTI odometry sequence directory.

    Layout: ``root/image_0/%06d.png`` (left gray), ``root/image_1/%06d.png``
    (right gray), same as the reference expects (``System.cpp:80-86``).
    """

    def __init__(self, root: str, static_hw: tuple[int, int] | None = None):
        self.root = root
        self.dir_l = os.path.join(root, "image_0")
        self.dir_r = os.path.join(root, "image_1")
        if not os.path.isdir(self.dir_l):
            raise FileNotFoundError(f"no image_0/ under {root}")
        self.n_frames = len([f for f in os.listdir(self.dir_l) if f.endswith(".png")])
        first = _decode_png(self._path(self.dir_l, 0))
        self.native_hw = first.shape
        self.static_hw = static_hw or static_shape_for(*first.shape)

    @staticmethod
    def _path(d: str, i: int) -> str:
        return os.path.join(d, f"{i:06d}.png")

    def __len__(self) -> int:
        return self.n_frames

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        h, w = self.static_hw
        l = _decode_png(self._path(self.dir_l, i))
        r = _decode_png(self._path(self.dir_r, i))
        return pad_to(l, h, w), pad_to(r, h, w)

    def iter_prefetch(self, depth: int = 4) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Iterate frames with background prefetching (a thread pool) so
        decode overlaps device compute."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(self.__getitem__, i)
                    for i in range(min(depth, self.n_frames))]
            nxt = len(futs)
            for i in range(self.n_frames):
                yield futs.pop(0).result()
                if nxt < self.n_frames:
                    futs.append(ex.submit(self.__getitem__, nxt))
                    nxt += 1


def load_calib(calib_path: str) -> dict:
    """Parse a KITTI ``calib.txt`` (P0/P1 rows) into rig parameters."""
    vals = {}
    with open(calib_path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                vals[k.strip()] = np.fromstring(v, sep=" ")
    P0 = vals["P0"].reshape(3, 4)
    P1 = vals["P1"].reshape(3, 4)
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    baseline = -P1[0, 3] / P1[0, 0]
    return dict(fx=fx, fy=fy, cx=cx, cy=cy, baseline=float(baseline))
