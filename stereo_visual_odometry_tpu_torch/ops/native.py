"""Build and load the package's CUDA kernels (``csrc/*.cu``) and C++
bindings (``csrc/*_binding.cpp``).

Each kernel source is compiled with ``nvcc`` for Hopper (``sm_90a``) into an
object, all sources at once in parallel, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. A binding is
a Python extension module compiled with the host compiler (``$CXX`` or
``g++``; no ``nvcc``, no ``ninja``, no ``torch.utils.cpp_extension.load``)
against PyTorch's headers (``cpp_extension.include_paths()``), CUDA's and
Python's, and linked against PyTorch's libraries; ``extension`` hands it the
addresses of the library's C entries it launches, so it does not link
against that library. Both build at first use (never at import), into
``_build/`` beside the package (listed in ``.gitignore``): the library keyed
by a hash of the kernel sources and their shared headers (``csrc/*.cuh``),
a binding by a hash of its source, the torch and Python versions and its
compile command, so an edited source is rebuilt. There is no fallback: a
failed build raises.

The lean launch path of the ctypes wrappers: ``entry`` resolves a C entry
point once (later calls are a dict lookup, without ``lib``'s lock; ``lib``
is only its loader); the wrappers take the raw stream from
``cuda_stream.current_stream``. Importing this module imports nothing of
torch; only building a binding does.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from types import ModuleType

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# A binding: C++20 (what recent PyTorch headers take), optimised, shared.
CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC", "-shared", "-w")
# PyTorch's libraries a binding links against: the dispatcher and the CUDA
# stream (c10, c10_cuda, torch_cpu) and the tensor type caster (torch_python).
TORCH_LIBS = ("c10", "c10_cuda", "torch_cpu", "torch_python")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The LK level kernels K3-K6 finish the level in the kernel and take: prev,
# next, hp, wp, pts, guess, active (bool bytes, or null), n, win, iters,
# eps^2, min_eig, pad, search radius, flow (guess + delta), ok (bool), stats
# (or null), device, stream.
_LK_LEVEL = [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _P, _P, _P, _I, _P]
# C entry points of csrc/: name -> argtypes (all return a cudaError_t as int).
_SIGNATURES = {
    # img, hp, wp, corners, n, Sh, Sw, out, device, stream
    "svo_extract_windows_int": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    # img, h, w (unpadded), centers, n, P, pad, out, device, stream
    "svo_extract_patches": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    "svo_lk_level_cell": _LK_LEVEL,
    "svo_lk_level_v1": _LK_LEVEL,
    "svo_lk_level_block": _LK_LEVEL,
    "svo_lk_level_v2": _LK_LEVEL,
    # prev, next, hp, wp, pts, guess (or null: zero), n, win, iters, eps^2,
    # min_eig, pad, flow, ok (float32), mode, rounds, dots, device, stream
    "svo_lk_block_split": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _I, _I,
                           _P, _I, _P],
    # x, rows, cols, amt, axis, out, device, stream
    "svo_roll": [_P, _I, _I, _P, _I, _P, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict[str, ctypes._CFuncPtr] = {}
_extensions: dict[str, ModuleType] = {}


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


def _cuda_home() -> Path:
    return Path(_nvcc()).resolve().parent.parent


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


def extension_command(name: str) -> list[str]:
    """The host compiler's command for the binding ``csrc/<name>.cpp``,
    without its output path."""
    import torch
    from torch.utils import cpp_extension
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (set CXX or put g++ on PATH); the "
                           "bindings are built from csrc/ at first use")
    torch_lib = Path(torch.__file__).resolve().parent / "lib"
    includes = [*cpp_extension.include_paths(), str(_cuda_home() / "include"),
                sysconfig.get_paths()["include"]]
    return [cxx, *CXX_FLAGS,
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{p}" for p in includes), str(CSRC_DIR / f"{name}.cpp"),
            f"-L{torch_lib}", *(f"-l{lib}" for lib in TORCH_LIBS),
            f"-Wl,-rpath,{torch_lib}"]


def extension_path(name: str) -> Path:
    """Where the binding ``csrc/<name>.cpp`` is built for this torch and
    Python."""
    import torch
    cmd = extension_command(name)
    h = hashlib.sha256((CSRC_DIR / f"{name}.cpp").read_bytes())
    for part in (torch.__version__, sys.version, sysconfig.get_config_var("EXT_SUFFIX"),
                 *cmd[1:]):
        h.update(str(part).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}{sysconfig.get_config_var('EXT_SUFFIX')}"


def build_extension(name: str) -> Path:
    """Compile the binding ``csrc/<name>.cpp`` unless it is built already;
    its log (command, output, seconds) goes beside it."""
    out = extension_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        logs = _run_all([[*extension_command(name), "-o", str(tmp)]])
        (BUILD_DIR / f"{out.name}.log").write_text(
            "\n".join(logs) + f"\nbuilt in {time.perf_counter() - t0:.1f} s\n")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def extension(name: str, entries: tuple[str, ...]) -> ModuleType:
    """The binding ``csrc/<name>.cpp``, built and imported on the first call
    and handed the addresses of the library's C entries ``entries`` (its
    ``bind``)."""
    mod = _extensions.get(name)
    if mod is None:
        addresses = [ctypes.cast(entry(e), ctypes.c_void_p).value for e in entries]
        with _lock:
            mod = _extensions.get(name)
            if mod is None:
                spec = importlib.util.spec_from_file_location(name, build_extension(name))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                mod.bind(*addresses)
                _extensions[name] = mod
    return mod
