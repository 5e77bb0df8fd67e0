"""Device meshes: where a leading-axis batch goes.

Port of ``stereo_visual_odometry_tpu/parallel/mesh.py``. A mesh is an
ordered tuple of ``torch.device``s with one axis name: ``seq`` for
sequences advanced together (``parallel/sequences.py``), ``ba`` for the
distributed bundle adjustment (``parallel/dist_ba.py``).

A ``seq`` mesh of n splits an S-leading sequence batch in one process, as
JAX's ``NamedSharding(mesh, P('seq'))`` does: shard i takes sequences
``[i*S/n, (i+1)*S/n)`` on ``mesh.devices[i]``, and no collective is needed.
Each position is a shard of its own, so a mesh may name a device more than
once (two shards on one card, each with its own step graph). Across
devices the BA runs one process per device over ``torch.distributed``
(``parallel/multihost.py``). The platforms are ``cuda`` (the default; at
most ``torch.cuda.device_count()`` devices) and ``cpu``, where a mesh of n
is n shards of the CPU: the counterpart of JAX's virtual host devices.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in shard order on one axis; a device may appear more than
    once."""

    devices: tuple[torch.device, ...]
    axis: str

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor goes on ``mesh``: split over its leading axis along
    ``axis``, or replicated (``axis`` None)."""

    mesh: Mesh
    axis: str | None


def _devices(platform: str, n: int | None) -> list[torch.device]:
    if platform == "cpu":
        return [torch.device("cpu")] * (n or 1)
    if platform == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    raise ValueError(f"unknown platform {platform!r} (expected 'cuda' or 'cpu')")


def make_mesh(n_devices: int | None = None, axis: str = "seq",
              platform: str | None = None) -> Mesh:
    """Mesh over the first ``n_devices`` devices of ``platform`` (default
    ``cuda``; all of them when ``n_devices`` is None). Raises when fewer
    exist, as JAX's does. On ``cpu`` it is ``n_devices`` shards of the CPU
    (one when None)."""
    devs = _devices(platform or "cuda", n_devices)
    n = n_devices or len(devs)
    if len(devs) < n or n == 0:
        raise ValueError(f"need {n or 1} devices on platform={platform or 'default'}, "
                         f"have {len(devs)}")
    return Mesh(tuple(devs[:n]), axis)


def shard_leading(mesh: Mesh, axis: str = "seq") -> Sharding:
    """A leading-axis batch split over the mesh axis."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_devices(mesh: Mesh | None, device) -> tuple[torch.device, ...]:
    """The devices a sequence batch runs on, one per shard: ``mesh``'s, or
    ``device`` alone without a mesh; ``cuda`` without an index is the
    current card. Raises without a GPU for a ``cuda`` device."""
    out = []
    for dev in (mesh.devices if mesh is not None else (torch.device(device),)):
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"a sequence batch on {str(dev)!r} needs an NVIDIA GPU and "
                                   "torch.cuda.is_available() is False; pass device='cpu' to "
                                   "run on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return tuple(out)


def single_device(mesh: Mesh | None, device) -> torch.device:
    """The one device of a run that takes one (``System``, the command
    line's single sequence): ``mesh``'s, or ``device`` without a mesh. A
    mesh of several devices raises; a sequence batch splits over one
    (``shard_devices``)."""
    if mesh is None:
        return torch.device(device)
    if mesh.size != 1:
        raise ValueError(f"this run takes one device; the mesh has {mesh.size} "
                         f"({[str(d) for d in mesh.devices]})")
    return mesh.devices[0]
