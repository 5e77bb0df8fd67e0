"""Structured logging + metrics.

Port of ``stereo_visual_odometry_tpu/utils/logging.py``: one stdlib logger
hierarchy plus a tiny metrics recorder that can dump JSON lines for offline
analysis. The hierarchy is the port's package, so the
``logging.getLogger(__name__)`` loggers of its modules print through the
handler ``get_logger`` installs.
"""
from __future__ import annotations

import json
import logging
import sys
import time

ROOT = "stereo_visual_odometry_tpu_torch"

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    """The logger ``<package>.<name>``; the first call puts a stderr handler
    (JAX's format) on the package's logger."""
    global _CONFIGURED
    if not _CONFIGURED:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s] %(message)s", "%H:%M:%S"))
        root = logging.getLogger(ROOT)
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(f"{ROOT}.{name}")


class MetricsRecorder:
    """Append-only metric stream; optionally mirrored to a JSONL file."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []
        self._fh = open(path, "a") if path else None

    def log(self, **kv) -> None:
        kv.setdefault("ts", time.time())
        self.records.append(kv)
        if self._fh:
            self._fh.write(json.dumps(kv, default=float) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
