"""Multi-process bootstrap: the process group, the global mesh and data
placement over ``torch.distributed``.

Port of ``stereo_visual_odometry_tpu/parallel/multihost.py``. Each process
drives one device (its rank's card, or the CPU) and:

  1. joins the group with ``initialize`` (``init_process_group`` with an
     ``init_method`` URL or a ``Store``; a ``FileStore`` needs no port, a
     ``HashStore`` serves one process);
  2. names the ranks' devices with ``global_mesh``;
  3. feeds its own shard with ``host_local_array`` (equal shards, checked by
     an ``all_gather`` of the shapes) and takes shared values from rank 0
     with ``replicated_array`` (a ``broadcast``);
  4. runs the same program as one process would (``dist_ba``), whose
     all-reduces cross the ranks.

Nothing on a machine announces a cluster: the caller gives the address or
store, the world size and its rank. No DTensor is needed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def initialize(init_method: str | None = None, store=None, world_size: int = 1,
               rank: int = 0, backend: str = "nccl") -> None:
    """Join the process group; a second call in the same process with the
    same world size and rank does nothing. ``backend`` is NCCL, one card per
    process, and raises without a GPU; ``backend="gloo"`` runs on the CPU.
    With neither ``init_method`` nor ``store``, a single process joins
    through a ``HashStore``."""
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise RuntimeError(f"already in a group of {dist.get_world_size()} as rank "
                               f"{dist.get_rank()}, asked for {world_size} / {rank}")
        return
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend='nccl' needs an NVIDIA GPU and torch.cuda.is_available() "
                           "is False; pass backend='gloo' to run on the CPU")
    if init_method is None and store is None:
        if world_size != 1:
            raise ValueError("several processes need an init_method or a store")
        store = dist.HashStore()
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank)


def local_device() -> torch.device:
    """This rank's device: ``cuda:<rank % count>`` under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def global_mesh(axis: str = "ba", n_devices: int | None = None) -> Mesh:
    """Mesh over the ranks' devices, in rank order (one per process)."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(local_device()))
    n = n_devices or len(names)
    return Mesh(tuple(torch.device(d) for d in names[:n]), axis)


def host_local_array(mesh: Mesh, axis: str, local: np.ndarray) -> torch.Tensor:
    """THIS rank's shard of an array split over ``axis`` along its leading
    dim, on its device. Every rank must hand an equal shard (the global
    leading dim is ``world_size * local.shape[0]``): the shapes are checked
    across ranks."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    dev = local_device()
    shape = torch.tensor(local.shape, dtype=torch.int64, device=dev)
    shapes = [torch.empty_like(shape) for _ in range(dist.get_world_size())]
    dist.all_gather(shapes, shape)
    if any(not torch.equal(s, shape) for s in shapes):
        raise ValueError(f"unequal shards: {[tuple(s.tolist()) for s in shapes]}")
    return torch.as_tensor(np.ascontiguousarray(local), device=dev)


def replicated_array(mesh: Mesh, value: np.ndarray) -> torch.Tensor:
    """Rank 0's ``value`` on every rank's device (a ``broadcast``)."""
    out = torch.as_tensor(np.ascontiguousarray(value), device=local_device()).clone()
    dist.broadcast(out, src=0)
    return out
