"""Probes: the JAX package's kernel probes (``scripts/probe_*.py``) ported,
each runnable with ``python -m stereo_visual_odometry_tpu_torch.probes.<name>``
on the card (``--device cpu`` runs the plain versions at a small size).

  ba_leg        the JAX bench's BA leg through System, over RANSAC seeds or
                given draws
  bench         the JAX package's bench.py on the card: the bench rows, the
                kernel parity block and the BA leg as one JSON line
  lk_block      K5/K6 against K3/K4: parity and time per level call
  lk_breakdown  K8: an LK level call split into template, reloads, iterations
  roll          K7: the dynamic-roll envelope
  step_nodes    the aten ops of one frontend step by stage and function: where
                the nodes of the step's CUDA graph come from
  timing        CUDA-event and CUDA-graph timers shared by the timing probes
"""
