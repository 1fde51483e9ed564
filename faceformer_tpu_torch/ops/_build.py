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

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> str:
    """The built shared library of ``csrc/<name>.cu``."""
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    """nvcc's output for ``name`` (the -Xptxas -v register/spill lines)."""
    return os.path.join(BUILD_DIR, f"{name}.log")


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(d) > os.path.getmtime(lib) for d in deps)


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
    """Compile every stale source, one nvcc process each, all at once.
    Returns the names that this process built (none where another process
    built them first)."""
    with _build_lock():
        todo = [n for n in names if _stale(n)]
        if not todo:
            return []
        exe = nvcc()
        procs = {}
        for name in todo:
            tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
            cmd = [exe, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            with open(log_path(name), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib_path(name))
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
        return todo


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
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

