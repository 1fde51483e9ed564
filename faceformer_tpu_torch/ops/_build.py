"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc, for sm_90a, into its own shared
library with a plain C interface under ``build/faceformer_tpu_torch/`` at the
repository root (seconds per source; nothing includes PyTorch's headers).
``build_all`` starts one nvcc per source at once. A library is rebuilt when
any source or header is newer than it. A missing nvcc or a failed build
raises; nothing falls back. Several processes may build at once (the
ranks of a multi-rank run start cold together): an exclusive lock on
``BUILD_DIR/build.lock`` covers the stale check, the compile into a file
named with the process id and the rename, so each library is built once
and no process loads a partial file.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` as an int; ``check`` raises on non-zero.

The host library ``HOST`` (the threaded JSON loader and the geometry
kernel, ``csrc/host/*.cc``) is built the same way, by g++ with the flags
``GXX_FLAGS``, into ``BUILD_DIR/libfaceformer_host.so``; it is stale when
any of its sources is newer, and a missing g++ or a failed compile raises
with the compiler's output. ``geometry/native.py`` binds it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "faceformer_tpu_torch")
SOURCES = ("pointer", "flash", "flash_bwd", "decode_step")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST = "faceformer_host"
GXX = "g++"
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def gxx() -> str:
    path = shutil.which(GXX)
    if path is None:
        raise RuntimeError(f"{GXX} not found on PATH: the host library "
                           "(csrc/host/*.cc) cannot be built")
    return path


def lib_path(name: str) -> str:
    """The built shared library of ``csrc/<name>.cu`` (or of ``HOST``)."""
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    """The compiler's output for ``name`` (nvcc's -Xptxas -v register/spill
    lines)."""
    return os.path.join(BUILD_DIR, f"{name}.log")


def _deps(name: str) -> List[str]:
    if name == HOST:
        return sorted(glob.glob(os.path.join(CSRC, "host", "*.cc")))
    return [os.path.join(CSRC, f"{name}.cu")] + glob.glob(os.path.join(CSRC, "*.cuh"))


def _command(name: str, out: str) -> List[str]:
    if name == HOST:
        return [gxx(), *GXX_FLAGS, "-o", out, *_deps(name), "-lpthread"]
    return [nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    return any(os.path.getmtime(d) > os.path.getmtime(lib) for d in _deps(name))


@contextlib.contextmanager
def _build_lock():
    """Hold the build directory's lock file exclusively (released when the
    process exits, whatever way it does)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Compile every stale library, one compiler process each, all at once.
    Returns the names that this process built (none where another process
    built them first)."""
    with _build_lock():
        todo = [n for n in names if _stale(n)]
        if not todo:
            return []
        tmps = {name: f"{lib_path(name)}.{os.getpid()}.tmp" for name in todo}
        cmds = {name: _command(name, tmps[name]) for name in todo}
        procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                 for name, cmd in cmds.items()}
        failed = []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            with open(log_path(name), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name} ({os.path.basename(cmds[name][0])} exit "
                              f"{proc.returncode}):\n{out}")
            else:
                os.replace(tmps[name], lib_path(name))
        if failed:
            raise RuntimeError("build failed:\n" + "\n".join(failed))
        return todo


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (or ``HOST``), building it
    if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
        if name != HOST:
            lib.ff_error_string.argtypes = [ctypes.c_int]
            lib.ff_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``fn`` of library ``name`` with its argument types set
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(name: str, status: int, what: str) -> None:
    if status != 0:
        msg = _LIBS[name].ff_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

