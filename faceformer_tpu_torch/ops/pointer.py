"""K1 pointer argmax: logits = rows @ memory^T, mask, argmax — one kernel.

Replaces faceformer_tpu/ops/pointer.py::pointer_argmax (pl.pallas_call at
pointer.py:48), which ``masked_argmax`` calls once per decode step in the
``reference`` and ``causal_cache`` engines. Kernel: csrc/pointer.cu, whose
header says what bounds it on the card and how its design answers that.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from faceformer_tpu_torch import ops
from faceformer_tpu_torch.ops import _build

NEG = float(np.finfo(np.float32).min)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pointer_argmax_plain(rows: torch.Tensor, memory: torch.Tensor,
                         padding_mask: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 logits, padded rows at the
    float32 minimum, torch.argmax (first index on ties)."""
    logits = torch.einsum("nre,nse->nrs", rows.float(), memory.float())
    logits = logits.masked_fill(padding_mask[:, None, :], NEG)
    return logits.argmax(dim=-1).to(torch.int32)


def pointer_argmax(rows: torch.Tensor, memory: torch.Tensor, padding_mask: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """rows (N, R, E), memory (N, S, E) of one dtype (float32 or bfloat16),
    padding_mask (N, S) bool (True = padded) -> (N, R) int32 argmax over S.

    CUDA tensors launch the kernel; CPU tensors (or impl="plain") run
    ``pointer_argmax_plain``."""
    n, r, e = rows.shape
    s = memory.shape[1]
    if memory.shape != (n, s, e) or padding_mask.shape != (n, s):
        raise ValueError(f"shapes rows {tuple(rows.shape)}, memory {tuple(memory.shape)}, "
                         f"mask {tuple(padding_mask.shape)} do not match")
    if rows.dtype != memory.dtype or rows.dtype not in _DTYPES:
        raise ValueError(f"rows/memory dtypes {rows.dtype}/{memory.dtype}: "
                         "need one of float32, bfloat16")
    if padding_mask.dtype != torch.bool:
        raise ValueError("padding_mask must be bool")
    if not ops.use_kernel(impl, rows, memory, padding_mask):
        return pointer_argmax_plain(rows, memory, padding_mask)
    for t in (rows, memory, padding_mask):
        if not t.is_contiguous():
            raise ValueError("pointer_argmax needs contiguous tensors")
    out = torch.empty((n, r), dtype=torch.int32, device=rows.device)
    fn = _build.bind("pointer", "pointer_argmax", [ctypes.c_int] + [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    status = fn(_DTYPES[rows.dtype], _build.ptr(rows), _build.ptr(memory),
                _build.ptr(padding_mask), n, r, s, e, _build.ptr(out),
                _build.stream_ptr(rows.device))
    _build.check("pointer", status, "pointer_argmax launch")
    ops.LAUNCHES["pointer_argmax"] += 1
    return out


def pointer_argmax_gather_plain(rows: torch.Tensor, memory: torch.Tensor,
                                padding_mask: Optional[torch.Tensor] = None,
                                bias: Optional[torch.Tensor] = None):
    """K4's last phase in plain PyTorch: fp32 logits, padded rows at the
    float32 minimum, then + bias, argmax (first index on ties), and the
    winning memory rows."""
    logits = torch.einsum("nre,nse->nrs", rows.float(), memory.float())
    if padding_mask is not None:
        logits = logits.masked_fill(padding_mask[:, None, :], NEG)
    if bias is not None:
        logits = logits + bias[:, None, :]
    idx = logits.argmax(dim=-1)
    gathered = torch.gather(memory, 1, idx[..., None].expand(-1, -1, memory.shape[-1]))
    return idx.to(torch.int32), gathered


def pointer_argmax_gather(rows: torch.Tensor, memory: torch.Tensor,
                          padding_mask: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None, impl: str = "auto"):
    """The tensor-core pointer kernel as the fused decode step (K4) runs it,
    exposed alone for tests: rows (N, R, E) float32 or bfloat16, memory
    (N, S, E) bfloat16, an optional padding_mask (N, S) bool and an optional
    additive bias (N, S) float32 -> (tokens (N, R) int32, gathered (N, R, E),
    the winning memory rows). No main path calls it; the step calls the
    kernel from C."""
    n, r, e = rows.shape
    s = memory.shape[1]
    if memory.shape != (n, s, e) or memory.dtype != torch.bfloat16:
        raise ValueError(f"memory {tuple(memory.shape)} {memory.dtype}: want ({n}, S, {e}) "
                         "bfloat16")
    if rows.dtype not in _DTYPES:
        raise ValueError(f"rows dtype {rows.dtype}: need float32 or bfloat16")
    if padding_mask is not None and (padding_mask.shape != (n, s)
                                     or padding_mask.dtype != torch.bool):
        raise ValueError("padding_mask must be (N, S) bool")
    if bias is not None and (bias.shape != (n, s) or bias.dtype != torch.float32):
        raise ValueError("bias must be (N, S) float32")
    given = [t for t in (rows, memory, padding_mask, bias) if t is not None]
    if not ops.use_kernel(impl, *given):
        return pointer_argmax_gather_plain(rows, memory, padding_mask, bias)
    if not all(t.is_contiguous() for t in given):
        raise ValueError("pointer_argmax_gather needs contiguous tensors")
    out = torch.empty((n, r), dtype=torch.int32, device=rows.device)
    gathered = torch.empty((n, r, e), dtype=memory.dtype, device=rows.device)
    fn = _build.bind("pointer", "pointer_argmax_gather", [ctypes.c_int] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    null = ctypes.c_void_p(None)
    status = fn(_DTYPES[rows.dtype], _build.ptr(rows), _build.ptr(memory),
                null if padding_mask is None else _build.ptr(padding_mask),
                null if bias is None else _build.ptr(bias), n, r, s, e, _build.ptr(out),
                _build.ptr(gathered), _build.stream_ptr(rows.device))
    _build.check("pointer", status, "pointer_argmax_gather launch")
    ops.LAUNCHES["pointer_argmax_gather"] += 1
    return out, gathered
