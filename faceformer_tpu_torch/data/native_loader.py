"""ctypes bridge to the port's C++ data loader (csrc/host/dataloader.cc;
PyTorch port's counterpart of faceformer_tpu/data/native_loader.py).

One threaded C++ pass turns a list of sample JSON files into the final
static-shape arrays (input grids + packed label grids), in place of the
Python json.load preload plus per-sample packing the reference does in
DataLoader worker processes (reference faceformer/datasets/data.py:48-51,
trainer.py:33). Its packing is the one of ``data/packing.py``
(tests/test_torch_native_loader.py holds the two equal).

A file the pass rejects is named in a warning and listed in ``failed``;
the dataset re-packs it through the Python path, so the error it raises
(which exception, for which sample) stays the reference's.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Dict, Optional, Sequence

import numpy as np

from faceformer_tpu_torch.config import ModelConfig
from faceformer_tpu_torch.geometry import native as _geometry_native


def load_pack_files(
    paths: Sequence[str],
    cfg: ModelConfig,
    parallel: bool,
    n_threads: int = 0,
) -> Optional[Dict[str, np.ndarray]]:
    """Parse + resample + pack ``paths`` in C++ threads (``n_threads`` 0:
    one a host core).

    Returns dict(input (N,L,P,2) f32, input_mask (N,L) bool,
    num_input (N,) i32, label (N,T)|(N,L,T) i32, num_label|num_faces (N,) i32,
    failed: tuple of indices that must re-pack through the Python path),
    or None where the C side cannot pack the layout (``point_dim`` != 2)
    or EVERY file failed. Individual bad files don't revert the whole
    corpus to the Python preload: the warning names them and the dataset
    re-packs them one by one.
    """
    if cfg.point_dim != 2:
        return None
    lib = _geometry_native.load()

    n = len(paths)
    tok = cfg.token
    L, P = cfg.num_lines, cfg.num_points_per_line
    T = cfg.max_face_length if parallel else cfg.label_seq_length

    inp = np.empty((n, L, P, 2), dtype=np.float32)
    mask = np.empty((n, L), dtype=np.uint8)
    num_input = np.empty(n, dtype=np.int32)
    label = np.empty((n, L, T) if parallel else (n, T), dtype=np.int32)
    num_label = np.empty(n, dtype=np.int32)
    ok = np.zeros(n, dtype=np.uint8)
    err = ctypes.create_string_buffer(1024)
    path_arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])

    c = ctypes
    failures = lib.load_pack_files(
        path_arr, n, n_threads, 1 if parallel else 0,
        L, P, T,
        tok.length, tok.PAD, tok.SOS, tok.SEP, tok.EOS,
        tok.face_type_offset, tok.DIR0,
        inp.ctypes.data_as(c.POINTER(c.c_float)),
        mask.ctypes.data_as(c.POINTER(c.c_uint8)),
        num_input.ctypes.data_as(c.POINTER(c.c_int32)),
        label.ctypes.data_as(c.POINTER(c.c_int32)),
        num_label.ctypes.data_as(c.POINTER(c.c_int32)),
        ok.ctypes.data_as(c.POINTER(c.c_uint8)),
        err, len(err))
    failed = tuple(int(i) for i in np.nonzero(ok == 0)[0])
    if failures:
        first = err.value.decode(errors="replace")
        if len(failed) == n:
            warnings.warn(f"native loader: all {n} files failed (first: {first}); "
                          "falling back to the Python packer")
            return None
        shown = ", ".join(paths[i] for i in failed[:5])
        more = f" (+{len(failed) - 5} more)" if len(failed) > 5 else ""
        warnings.warn(
            f"native loader: {failures}/{n} files failed, re-packing them "
            f"through the Python path: {shown}{more} (first error: {first})")

    out = {
        "input": inp,
        "input_mask": mask.astype(bool),
        "num_input": num_input,
        "label": label,
        "failed": failed,
    }
    out["num_faces" if parallel else "num_label"] = num_label
    return out
