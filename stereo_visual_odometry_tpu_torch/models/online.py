"""Online (streaming) frame-feed API — the ROS-wrapper equivalent.

Port of ``stereo_visual_odometry_tpu/models/online.py``, with its pairing,
queue and drop policy: a thread-safe feed pairs asynchronously arriving
left/right frames by timestamp (the ApproximateTime policy of the
reference's ROS node, ``robust_vslam_ros.cpp:36-94``) and drives
``System.step_online`` on a worker thread, so producers never block on
device compute; a pair that finds the queue full is dropped.

The worker is the only thread that touches the ``System`` and the card: it
makes the ``System``'s device current for itself before its first step, and
that first step captures the step's CUDA graph there (``torch.cuda.graph``
captures in global mode, so producers must hand frames as host arrays and
make no CUDA calls of their own). A step that raises ends the worker, and
``poll`` and ``close`` raise its error. ``close`` stops the worker after
the step it is in (pairs still queued are not stepped) and waits for it
to exit, so no thread is left inside CUDA. While a span recorder is on
(``utils/profiling``), a pair's wait in the queue is an ``online.queue``
span, from the put to the worker's get, whose request id its step shares.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .system import System
from ..utils import profiling
from ..utils.logging import get_logger


@dataclass
class _PendingFrames:
    """Timestamp-keyed buffers for each camera (ApproximateTime pairing)."""

    left: dict = field(default_factory=dict)
    right: dict = field(default_factory=dict)


class OnlineVO:
    """Asynchronous stereo feed: ``push_left``/``push_right`` from any
    thread; matched pairs are processed in arrival order on a worker."""

    def __init__(self, system: System, slop: float = 0.05, maxlen: int = 16):
        self.system = system
        self.slop = slop
        self.maxlen = maxlen
        self._pending = _PendingFrames()
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=maxlen)
        self._results: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._error: Exception | None = None
        self.log = get_logger("online")
        self.dropped = 0
        dev = system.device  # "cuda" without an index: this thread's current card
        self._cuda_index = (None if dev.type != "cuda" else
                            torch.cuda.current_device() if dev.index is None else dev.index)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -------------------------- producers ----------------------------- #

    def push_left(self, ts: float, img: np.ndarray) -> None:
        self._push("left", ts, img)

    def push_right(self, ts: float, img: np.ndarray) -> None:
        self._push("right", ts, img)

    def push_pair(self, ts: float, img_l: np.ndarray, img_r: np.ndarray) -> None:
        self._enqueue(ts, img_l, img_r)

    def _push(self, side: str, ts: float, img: np.ndarray) -> None:
        with self._lock:
            mine = getattr(self._pending, side)
            other = getattr(self._pending, "right" if side == "left" else "left")
            # ApproximateTime: pair with the closest other-side frame
            # within slop (robust_vslam_ros.cpp:38-42's policy, queue 10).
            best, best_dt = None, self.slop
            for ots in other:
                dt = abs(ots - ts)
                if dt <= best_dt:
                    best, best_dt = ots, dt
            if best is not None:
                oimg = other.pop(best)
                pair = (ts, img, oimg) if side == "left" else (ts, oimg, img)
                self._enqueue(*pair)
            else:
                mine[ts] = img
                while len(mine) > self.maxlen:
                    mine.pop(min(mine))

    def _enqueue(self, ts, img_l, img_r) -> None:
        queued = profiling.begin("online.queue")  # ends at the worker's get
        try:
            self._q.put_nowait((ts, img_l, img_r, queued))
        except queue.Full:
            self.dropped += 1  # drop-oldest-producer policy: skip this frame

    # --------------------------- worker ------------------------------- #

    def _run(self) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while not self._stop.is_set():
                try:
                    ts, il, ir, queued = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                profiling.end(queued)
                with profiling.within(queued):  # the step shares the pair's request id
                    m = self.system.step_online(il, ir)
                m["ts"] = ts
                self._results.put(m)
        except Exception as e:  # handed to the caller by poll / close
            self._error = e
            self.log.error("online worker stopped: %r", e)

    def _raise_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("the online worker stopped on an error") from self._error

    def poll(self, timeout: float = 0.0):
        """Fetch the next per-frame result dict, or None."""
        try:
            return self._results.get(timeout=timeout) if timeout else self._results.get_nowait()
        except queue.Empty:
            self._raise_error()
            return None

    def close(self) -> None:
        """Stop the worker after its current step and wait for it to exit."""
        self._stop.set()
        self._worker.join()
        self._raise_error()
