"""The benchmark of the PyTorch/CUDA port of the stereo VO (``vobench.run``).

It imports the port (``stereo_visual_odometry_tpu_torch``) and never JAX or
the JAX package. See README.md.
"""
