"""ctypes bindings + lazy build for the native C++ image loader.

Port of ``stereo_visual_odometry_tpu/native/loader.py``. ``loader.cpp``
(libpng grayscale decode, threaded stereo prefetch; the JAX package's code)
is compiled with g++ at first use, never at import, into the package's
``_build/`` (listed in ``.gitignore``), keyed by a hash of the source and
the compile command, so an edited source is rebuilt. Each build writes its
own temporary file and renames it into place, so concurrent processes do
not see half a library. A failed build raises with the compiler's output,
and ``get_lib`` raises that error again on later calls without compiling
again; the KITTI dataset (``utils/kitti.py``) then decodes with PIL, as
the JAX one does without its loader. Sizes are read from the PNG header,
so the loader needs no PIL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from ..ops.native import BUILD_DIR, _run_all

SRC = Path(__file__).resolve().parent / "loader.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-lpthread")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_lock = threading.Lock()
_lib = None
_error: Exception | None = None  # the failed build or load, raised again


def command(src: Path = SRC) -> list[str]:
    """The compile command for ``src``, without its output path."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (set CXX or put g++ on PATH); the "
                           "native loader is built from native/loader.cpp at first use")
    return [cxx, *CXX_FLAGS, str(src), *LIBS]


def library_path(src: Path = SRC) -> Path:
    """Where the library of ``src`` is built."""
    h = hashlib.sha256(Path(src).read_bytes())
    h.update(" ".join([Path(command(src)[0]).name, *CXX_FLAGS, *LIBS]).encode())
    return BUILD_DIR / f"libsvoload_{h.hexdigest()[:16]}.so"


def build(src: Path = SRC) -> Path:
    """Compile ``src`` unless its library exists; raises RuntimeError with
    the compiler's output when the compile fails."""
    out = library_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        _run_all([[*command(src), "-o", str(tmp)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library (built on the first call); raises RuntimeError
    (a failed build) or OSError (a failed load), and the same error on every
    later call."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _error = e
            raise
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.svo_decode_png_gray.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.svo_decode_png_gray.restype = ctypes.c_int
        lib.svo_prefetch_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.svo_prefetch_create.restype = ctypes.c_void_p
        lib.svo_prefetch_next.argtypes = [ctypes.c_void_p, u8p, u8p]
        lib.svo_prefetch_next.restype = ctypes.c_int
        lib.svo_prefetch_destroy.argtypes = [ctypes.c_void_p]
        lib.svo_prefetch_destroy.restype = None
        _lib = lib
        return _lib


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise IOError(f"not a PNG file: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def decode_png_gray(path: str, static_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Decode a PNG to (H, W) uint8, optionally edge-padded to static_hw."""
    lib = get_lib()
    h, w = png_size(path) if static_hw is None else static_hw
    out = np.empty((h, w), np.uint8)
    ih = ctypes.c_int()
    iw = ctypes.c_int()
    rc = lib.svo_decode_png_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, ctypes.byref(ih), ctypes.byref(iw))
    if rc != 0:
        raise IOError(f"native png decode failed ({rc}): {path}")
    return out


def iter_stereo_prefetch(paths: list[tuple[str, str]], static_hw: tuple[int, int],
                         depth: int = 4, n_threads: int = 2,
                         ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Iterate decoded (left, right) pairs with background prefetch."""
    lib = get_lib()
    h, w = static_hw
    n = len(paths)
    left_arr = (ctypes.c_char_p * n)(*[p[0].encode() for p in paths])
    right_arr = (ctypes.c_char_p * n)(*[p[1].encode() for p in paths])
    handle = lib.svo_prefetch_create(left_arr, right_arr, n, h, w, depth, n_threads)
    if not handle:
        raise RuntimeError("prefetcher creation failed")
    try:
        for _ in range(n):
            out_l = np.empty((h, w), np.uint8)
            out_r = np.empty((h, w), np.uint8)
            rc = lib.svo_prefetch_next(
                handle, out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out_r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc == -1:
                return
            if rc == -2:
                raise IOError("native decode failed during prefetch")
            yield out_l, out_r
    finally:
        lib.svo_prefetch_destroy(handle)
