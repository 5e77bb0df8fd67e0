"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each kernel source is compiled with ``nvcc`` for Hopper (``sm_90a``) into an
object, all sources at once in parallel, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. It builds
at first use (never at import), into ``_build/`` beside the package (listed
in ``.gitignore``), keyed by a hash of the kernel sources, their shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt.
There is no fallback: a failed build raises.

The lean launch path of the ctypes wrappers: ``entry`` resolves a C entry
point once (later calls are a dict lookup, without ``lib``'s lock; ``lib``
is only its loader); the wrappers take the raw stream from
``cuda_stream.current_stream``. Importing this module imports nothing of
torch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The LK level kernels K3-K6 finish the level in the kernel and take: prev,
# next, hp, wp, pts, guess, active (bool bytes, or null), n, win, iters,
# eps^2, min_eig, pad, search radius, flow (guess + delta), ok (bool), stats
# (or null), device, stream.
_LK_LEVEL = [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _P, _P, _P, _I, _P]
# K3/K4 on a sequence axis: the same with the batch B after n; every pointer
# then addresses B contiguous per-sequence blocks.
_LK_LEVEL_BATCHED = _LK_LEVEL[:8] + [_I] + _LK_LEVEL[8:]
# C entry points of csrc/: name -> argtypes (all return a cudaError_t as int).
_SIGNATURES = {
    # img, hp, wp, corners, n, Sh, Sw, out, device, stream
    "svo_extract_windows_int": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    # B images, hp, wp, B x n corners, n, B, Sh, Sw, out, device, stream
    "svo_extract_windows_int_batched": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _I, _P],
    # img, h, w (unpadded), centers, n, P, pad, out, device, stream
    "svo_extract_patches": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    # B images, h, w, B x n centers, n, B, P, pad, out, device, stream
    "svo_extract_patches_batched": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _I, _P],
    "svo_lk_level_cell": _LK_LEVEL,
    "svo_lk_level_v1": _LK_LEVEL,
    "svo_lk_level_cell_batched": _LK_LEVEL_BATCHED,
    "svo_lk_level_v1_batched": _LK_LEVEL_BATCHED,
    "svo_lk_level_block": _LK_LEVEL,
    "svo_lk_level_v2": _LK_LEVEL,
    # prev, next, hp, wp, pts, guess (or null: zero), n, win, iters, eps^2,
    # min_eig, pad, flow, ok (float32), mode, rounds, dots, device, stream
    "svo_lk_block_split": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _I, _I,
                           _P, _I, _P],
    # x, rows, cols, amt, axis, out, device, stream
    "svo_roll": [_P, _I, _I, _P, _I, _P, _I, _P],
    # pts, px, valid, weights (or null), T_init (or null), u, fx, fy, cx, cy,
    # n, h, B, huber, thr^2, refine iters, samples, duplicate flags,
    # hypotheses, scores, best, T, inliers, num_inliers, ratio, ok, device,
    # stream
    "svo_ransac_pnp_batched": [_P] * 10 + [_I] * 3 + [_F, _F, _I] + [_P] * 10 + [_I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict[str, ctypes._CFuncPtr] = {}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from csrc/ at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsvo_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise if any fails. Returns each one's
    command line and output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        output = proc.communicate()[0]
        logs.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{output}")
    if failed:
        raise RuntimeError(f"{Path(cmds[0][0]).name} failed:\n" + "\n".join(failed))
    return logs


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    srcs = _sources()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out.with_suffix(f".{tag}")
    log = out.with_suffix(".log")
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                         for s, o in zip(srcs, objs)])
        logs += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        log.write_text("\n".join(logs))
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def entry(name: str) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the library (built and loaded on the
    first call), resolved once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries.setdefault(name, getattr(lib(), name))
    return fn

