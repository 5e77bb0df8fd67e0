"""Scale-out: S sequences in one step (``sequences``, ``evaluate``) and the
bundle adjustment over ``torch.distributed`` (``dist_ba``, ``multihost``),
on device meshes (``mesh``). Port of ``stereo_visual_odometry_tpu/parallel``."""
from . import mesh, sequences, dist_ba, evaluate, multihost  # noqa: F401
