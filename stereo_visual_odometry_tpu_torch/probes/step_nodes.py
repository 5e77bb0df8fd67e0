"""Probe: where a frontend step's device work comes from.

Counts the aten ops of one eager step (``System.step_fn``, the ops the
step's CUDA graph replays, ``models/step_graph.py``) that launch device
work, by the stage of the step that called them (the line of
``frontend.step_fn``) and by the innermost function of ``ops/`` or
``models/``. Views and allocations launch nothing and are left out; the
hand-written kernels (K1-K4, RANSAC-PnP's three on the card) go through
their own entry points and are counted by their wrappers instead:
``kernels`` gives each wrapper's launches in the step (``launches``, the
step graph's counters). On the card nearly every counted op is one kernel,
so the split, with ``kernels``, is that of the graph's nodes per replay: it
says which stage a fused kernel would take nodes from.

    python -m stereo_visual_odometry_tpu_torch.probes.step_nodes               # dense LK, cuda:0
    python -m stereo_visual_odometry_tpu_torch.probes.step_nodes --lk-kernel cell
    python -m stereo_visual_odometry_tpu_torch.probes.step_nodes --mode orb
    python -m stereo_visual_odometry_tpu_torch.probes.step_nodes --device cpu --height 96 --width 256
"""
from __future__ import annotations

import argparse
import json
import linecache
import sys
from collections import Counter
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PKG = str(Path(__file__).resolve().parent.parent)
_SILENT = ("empty", "empty_like", "new_empty", "empty_strided", "detach", "lift_fresh",
           "alias", "_local_scalar_dense")


def _sites() -> tuple[str, str]:
    """(stage, function) of the op being dispatched: the line of
    ``frontend.step_fn`` it came from and the innermost port function."""
    f, stage, inner = sys._getframe(2), "outside step_fn", None
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(PKG):
            rel = path[len(PKG) + 1:]
            if inner is None and rel.startswith(("ops/", "models/")):
                inner = f"{rel}:{f.f_code.co_name}"
            if rel == "models/frontend.py" and f.f_code.co_name == "step_fn":
                stage = f"frontend.py:{f.f_lineno} {linecache.getline(path, f.f_lineno).strip()}"
        f = f.f_back
    return stage, inner or "?"


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_stage, self.by_function = Counter(), Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if not (func.is_view or name in _SILENT):
            stage, inner = _sites()
            self.by_stage[stage] += 1
            self.by_function[inner] += 1
        return func(*args, **(kwargs or {}))


def count(step_fn, state, img_l, img_r) -> dict:
    """The counted ops of one ``step_fn(state, img_l, img_r)`` (the state
    is read, not replaced): ``total``, ``by_stage`` and ``by_function``,
    each most frequent first, and ``kernels``, the hand-written kernels'
    launches by wrapper (those that launched)."""
    from ..models.step_graph import KERNELS
    mode = _Count()
    before = [fn.launches for fn in KERNELS]
    with mode:
        step_fn(state, img_l, img_r)
    if img_l.is_cuda:
        torch.cuda.synchronize(img_l.device)
    kernels = {fn.__name__: fn.launches - n for fn, n in zip(KERNELS, before)
               if fn.launches != n}
    return {"total": sum(mode.by_stage.values()),
            "by_stage": dict(mode.by_stage.most_common()),
            "by_function": dict(mode.by_function.most_common()), "kernels": kernels}


def main(argv=None) -> int:
    from ..models.frontend import VOConfig
    from ..models.system import System
    from ..utils import synthetic
    from ..utils.config import CameraConfig, RunConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="lk", choices=("lk", "orb"))
    ap.add_argument("--lk-kernel", default="dense", choices=("dense", "cell", "v1"))
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--features", type=int, default=None,
                    help="max_features (default 1024 for LK, 2048 for ORB)")
    args = ap.parse_args(argv)
    features = args.features or (1024 if args.mode == "lk" else 2048)
    seq = synthetic.render_sequence(n_frames=3, h=args.height, w=args.width, fx=718.856,
                                    baseline=0.537, n_points=9000, speed=1.1, seed=3)
    rp = seq["rig"]
    cam = CameraConfig(fx=rp["fx"], fy=rp["fy"], cx=rp["cx"], cy=rp["cy"],
                       baseline=rp["baseline"])
    vo = VOConfig(mode=args.mode, lk_kernel=args.lk_kernel, height=args.height,
                  width=args.width, max_features=features)
    sys_ = System(RunConfig(camera=cam, vo=vo), device=args.device, graph=False)
    frames = list(zip(seq["images_l"], seq["images_r"]))
    sys_.step(*frames[0])
    sys_.step(*frames[1])  # builds the kernels
    img_l, img_r = (torch.as_tensor(a, device=sys_.device) for a in frames[2])
    print(json.dumps({"device": str(sys_.device), "config": vars(args),
                      **count(sys_.step_fn, sys_.state, img_l, img_r)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
