"""Device meshes: where a leading-axis batch goes.

Port of ``stereo_visual_odometry_tpu/parallel/mesh.py``. A mesh is an
ordered tuple of ``torch.device``s with one axis name: ``seq`` for
sequences advanced together (``parallel/sequences.py``), ``ba`` for the
distributed bundle adjustment (``parallel/dist_ba.py``). In the port a
process drives one device; across devices the BA runs one process per
device over ``torch.distributed`` (``parallel/multihost.py``), and a
sequence batch runs on one device. The platforms are ``cuda`` (the
default) and ``cpu``, which has one device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``len(devices)`` devices of a platform, on one axis."""

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


def _devices(platform: str) -> list[torch.device]:
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    raise ValueError(f"unknown platform {platform!r} (expected 'cuda' or 'cpu')")


def make_mesh(n_devices: int | None = None, axis: str = "seq",
              platform: str | None = None) -> Mesh:
    """Mesh over the first ``n_devices`` devices of ``platform`` (default
    ``cuda``; all of them when ``n_devices`` is None). Raises when fewer
    exist, as JAX's does."""
    devs = _devices(platform or "cuda")
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


def single_device(mesh: Mesh | None, device) -> torch.device:
    """The one device a batch runs on: ``mesh``'s, or ``device`` without a
    mesh. A mesh of several devices raises: S sequences run on one device
    in the port (one process per device; ROADMAP.md)."""
    if mesh is None:
        return torch.device(device)
    if mesh.size != 1:
        raise ValueError(f"a sequence batch runs on one device; the mesh has {mesh.size} "
                         f"({[str(d) for d in mesh.devices]})")
    return mesh.devices[0]
