"""One run of one cell: what a driver is handed (``Cell``) and small helpers."""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


def derived_seed(seed: int, tag) -> int:
    """A 63-bit seed for ``tag`` (a pass number, "warm", ...) of run ``seed``."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def start_frame(seed: int, lap_frames: int) -> int:
    """The lap frame where run ``seed``'s drive begins."""
    return derived_seed(seed, "start") % lap_frames


def sync(devices) -> None:
    """Wait for every card of ``devices`` (nothing on the CPU)."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Cell:
    """A cell as a driver runs it: the program's configuration (``vo``,
    ``cam``), the traffic's parameters, the rendered lap (``lap``: host
    frames and poses), the run's seed, window and trace flag, and the
    devices it uses (its cards, or the CPU in a rehearsal)."""

    vo: object
    cam: object
    traffic: dict
    lap: dict
    seed: int
    seconds: float
    trace: bool
    devices: list
    calls: object = None           # trace.KernelCalls: K1's and K2's calls
    kernels: dict = dataclasses.field(default_factory=dict)

    @property
    def start(self) -> int:
        """The lap frame this run's drive begins at, from its seed."""
        return start_frame(self.seed, len(self.lap["poses"]))

    def frame(self, f: int) -> tuple[np.ndarray, np.ndarray]:
        """Lap frame ``f`` (lap after lap): the (left, right) host arrays."""
        k = self.lap["row"][f % len(self.lap["poses"])]
        if k < 0:
            raise IndexError(f"lap frame {f % len(self.lap['poses'])} was not rendered")
        return self.lap["left"][k], self.lap["right"][k]

    def check_kernels(self, graphs) -> None:
        """Hold K1's and K2's calls in the last replay of the window to the
        plain kernels (``reference.kernel_errors``), skipping those that read
        the step graphs' carried state. Called by a driver once the window
        has closed and the memory peak is read, before anything else runs."""
        from .reference import kernel_errors
        sync(self.devices)
        self.kernels = kernel_errors(self.calls, [g.state for g in graphs])

    def memory_peak(self) -> int:
        """The peak of allocated device memory on the fullest card used."""
        cards = [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
        return max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)
