"""stereo_visual_odometry_tpu_torch — the PyTorch/CUDA port of the stereo VO.

A second package beside ``stereo_visual_odometry_tpu`` (the JAX reference,
which stays as it is). It mirrors the JAX layout and names, so each
function's counterpart is found by name:

  ops/     batched geometry + vision ops on tensors; ``patch.py`` holds the
           wrappers of the hand-written CUDA patch kernels (K1, K2),
           ``lk_cell.py`` and ``lk_v1.py`` those of the LK level kernels
           (K3, K4), ``lk_block.py`` and ``lk_v2.py`` those of the archived
           block LK kernels and their timing split (K5, K6, K8), ``roll.py``
           the dynamic roll (K7)
  models/  the LK and ORB frontend steps and the ``System`` runtime
  utils/   config, synthetic sequences, trajectory metrics, JAX-state bridge
  probes/  the JAX package's kernel probes, ``python -m``-runnable, and the
           patch kernels' timing against their library calls
  csrc/    CUDA C++ sources, built with nvcc at first use

The port imports ``torch`` and never ``jax``.

Numerics policy (one place, applied on import): float32 throughout, and no
TF32 anywhere — the JAX reference computes the pyramid, the sweep and the
pose composition at ``Precision.HIGHEST``, and cuDNN would otherwise run
float32 convolutions in TF32.
"""
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import ops, models, utils  # noqa: E402,F401
