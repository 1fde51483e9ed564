"""ctypes bridge to the port's C++ host library (csrc/host/; PyTorch
port's counterpart of faceformer_tpu/geometry/native.py).

The library carries the host-side hot loops: per-sample edge resampling in
the data pipeline, batch face-enclosedness in eval post-processing, and the
threaded JSON loader of ``data/native_loader.py``. ``ops/_build.py``
compiles it with g++ at first use, never at import. There is no fallback:
a missing g++, a failed compile or a library of another ABI raises.

Ragged inputs use the flat-buffer + offsets convention of the C side:
points (total_points, 2) float64; offsets (num_edges + 1,) int64, edge i
spanning points[offsets[i]:offsets[i+1]].
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from faceformer_tpu_torch.geometry.loops import canonicalize_loops
from faceformer_tpu_torch.ops import _build
from faceformer_tpu_torch.post_processing import filter_faces_by_encloseness

# must match faceformer_abi_version() in csrc/host/dataloader.cc: bumped
# together whenever an extern "C" signature changes, so a stale library
# built from older sources is never called with the new argument layout
FACEFORMER_NATIVE_ABI = 2
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The host library, built if stale, with every entry's types set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(_build.HOST)
    lib.faceformer_abi_version.restype = ctypes.c_int64
    abi = int(lib.faceformer_abi_version())
    if abi != FACEFORMER_NATIVE_ABI:
        raise RuntimeError(
            f"host library ABI {abi} != expected {FACEFORMER_NATIVE_ABI} "
            f"({_build.lib_path(_build.HOST)}): its sources and "
            "geometry/native.py disagree")
    c = ctypes
    i64p, f64p = c.POINTER(c.c_int64), c.POINTER(c.c_double)
    f32p, i32p, u8p = c.POINTER(c.c_float), c.POINTER(c.c_int32), c.POINTER(c.c_uint8)
    lib.resample_edges.argtypes = [f64p, i64p, c.c_int64, c.c_int64, f32p]
    lib.resample_edges.restype = None
    lib.check_faces_enclosed.argtypes = [
        f64p, i64p, c.c_int64, i64p, i64p, c.c_int64, c.c_double, u8p, i64p, i64p]
    lib.check_faces_enclosed.restype = None
    lib.load_pack_files.argtypes = [
        c.POINTER(c.c_char_p), c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32,
        f32p, u8p, i32p, i32p, i32p, u8p,
        c.c_char_p, c.c_int64,
    ]
    lib.load_pack_files.restype = c.c_int64
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def flatten_edges(edges: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged polylines -> (points (N,2) float64, offsets (E+1,) int64).

    One conversion of all points where every edge has points of one width;
    otherwise edge by edge (which raises on an empty edge, as the JAX
    package's loop does)."""
    lens = np.fromiter(map(len, edges), dtype=np.int64, count=len(edges))
    offsets = np.zeros(len(edges) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if len(edges) and lens.min() > 0:
        try:
            points = np.asarray(list(itertools.chain.from_iterable(edges)), dtype=np.float64)
        except ValueError:  # points of more than one width
            points = None
        if points is not None and points.ndim == 2 and points.shape[1] >= 2:
            return np.ascontiguousarray(points[:, :2]), offsets
    points = np.empty((int(offsets[-1]), 2), dtype=np.float64)
    for i, e in enumerate(edges):
        points[offsets[i]: offsets[i + 1]] = np.asarray(e, dtype=np.float64)[:, :2]
    return points, offsets


def resample_edges_native(points: np.ndarray, offsets: np.ndarray,
                          num_samples: int) -> np.ndarray:
    """Every edge resampled to ``num_samples`` points: (E, P, 2) float32."""
    lib = load()
    num_edges = len(offsets) - 1
    out = np.empty((num_edges, num_samples, 2), dtype=np.float32)
    lib.resample_edges(_ptr(points, ctypes.c_double), _ptr(offsets, ctypes.c_int64),
                       num_edges, num_samples, _ptr(out, ctypes.c_float))
    return out


def check_faces_enclosed_native(
    points: np.ndarray, offsets: np.ndarray,
    faces: Sequence[Sequence[int]], tol: float,
) -> List[Optional[List[int]]]:
    """Batch enclosedness. Per face: None when not enclosed, else the list
    of loop ends (counting only in-range indices, matching the Python
    predicate's skip rule)."""
    lib = load()
    num_edges = len(offsets) - 1
    lens = np.fromiter(map(len, faces), dtype=np.int64, count=len(faces))
    face_offsets = np.zeros(len(faces) + 1, dtype=np.int64)
    np.cumsum(lens, out=face_offsets[1:])
    flat = np.fromiter(itertools.chain.from_iterable(faces), dtype=np.int64,
                       count=int(face_offsets[-1]))
    if flat.size == 0:
        flat = np.zeros(1, dtype=np.int64)
    enclosed = np.zeros(len(faces), dtype=np.uint8)
    loop_ends = np.zeros(max(int(face_offsets[-1]), 1), dtype=np.int64)
    num_loops = np.zeros(len(faces), dtype=np.int64)
    lib.check_faces_enclosed(
        _ptr(points, ctypes.c_double), _ptr(offsets, ctypes.c_int64), num_edges,
        _ptr(flat, ctypes.c_int64), _ptr(face_offsets, ctypes.c_int64), len(faces), tol,
        _ptr(enclosed, ctypes.c_uint8), _ptr(loop_ends, ctypes.c_int64),
        _ptr(num_loops, ctypes.c_int64))
    return [loop_ends[face_offsets[i]: face_offsets[i] + num_loops[i]].tolist()
            if enclosed[i] else None for i in range(len(faces))]


def filter_faces_by_encloseness_batch(edges: Sequence, faces, tol: float,
                                      flat: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """post_processing.filter_faces_by_encloseness in one C call for all
    faces of a sample, with the same output. ``flat`` is
    ``flatten_edges(edges)`` where the caller has it already. Faces whose
    indices carry orientation tuples (the direction-token flavour) go to
    the Python predicate: the C kernel takes plain edge ids."""
    plain = all(
        all(isinstance(i, (int, np.integer)) for i in face) for _, face in faces)
    if not plain:
        return filter_faces_by_encloseness(edges, faces, tol)

    points, offsets = flat if flat is not None else flatten_edges(edges)
    n_edges = len(edges)

    def norm(i):
        # Python-indexing parity: in-range negatives wrap (edges[-1] is the
        # last edge in the Python predicate); out-of-range ids stay as they
        # are, so the C kernel skips them as the Python path does
        i = int(i)
        return i % n_edges if -n_edges <= i < 0 else i

    index_lists = [[norm(i) for i in face] for _, face in faces]
    outcomes = check_faces_enclosed_native(points, offsets, index_lists, tol)
    filtered = []
    for norm_face, (face_type, face), loop_ends in zip(index_lists, faces, outcomes):
        # zero loops == not enclosed (the Python predicate returns a falsy
        # [] when every index was skipped, dropping the face)
        if not loop_ends:
            continue
        # the normalized ids are C-side only; output loops carry the
        # ORIGINAL ids, as the Python predicate's do (it keeps in-range
        # negatives verbatim and skips ids >= n_edges)
        valid = [int(orig) for orig, j in zip(face, norm_face) if 0 <= j < n_edges]
        loops, pos = [], 0
        for end in loop_ends:
            loops.append(valid[pos:end])
            pos = end
        filtered.append((face_type, canonicalize_loops(loops)))
    return filtered
