"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into an object,
all sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use (never at import), into ``_build/`` beside the package (listed in
``.gitignore``), and is keyed by a hash of the sources so an edited kernel
is rebuilt. There is no fallback: a failed build raises.
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
# The LK level kernels K3-K6 share one argument list: prev, next, hp, wp,
# pts, guess, active, n, win, iters, eps^2, min_eig, pad, flow, ok, stats,
# device, stream.
_LK_LEVEL = [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P, _I, _P]
# C entry points of csrc/: name -> argtypes (all return a cudaError_t as int).
_SIGNATURES = {
    # img, hp, wp, corners, n, Sh, Sw, out, device, stream
    "svo_extract_windows_int": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    # img, hp, wp, centers, n, P, pad, out, device, stream
    "svo_extract_patches": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    "svo_lk_level_cell": _LK_LEVEL,
    "svo_lk_level_v1": _LK_LEVEL,
    "svo_lk_level_block": _LK_LEVEL,
    "svo_lk_level_v2": _LK_LEVEL,
    # the LK level arguments up to stats, then mode, rounds, dots, device, stream
    "svo_lk_block_split": _LK_LEVEL[:-2] + [_I, _I, _P, _I, _P],
    # x, rows, cols, amt, axis, out, device, stream
    "svo_roll": [_P, _I, _I, _P, _I, _P, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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
    for src in _sources():
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
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
