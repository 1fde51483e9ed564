"""K2 and K3, flash attention forward and backward:
softmax(q k^T / sqrt(hd) + bias) v with (out, logsumexp) residuals only.

Replaces faceformer_tpu/ops/flash.py::flash_attention: the forward
(pl.pallas_call at flash.py:252), its custom VJP (flash.py:293, kernel
``_bwd_kernel``) and the attention-probability dropout both run inside the
kernel (``_keep_mask``). Every ``multihead_attention`` call reaches it: in
serving the encoder's self-attention and the ``reference`` engine's decoder;
in training also the causal decoder self-attention and the anchor-broadcast
cross-attention, forward and backward. Kernels: csrc/flash.cu (+
csrc/attention.cuh, csrc/attention_tiled_tc.cuh) and csrc/flash_bwd.cu (+
csrc/flash_bwd_tc.cuh, csrc/flash_bwd_tiled_tc.cuh), whose headers say what
bounds them on the card and how their designs answer that.

Dropout cannot reproduce the TPU PRNG's bits. The keep mask here is
counter-based (Philox4x32-10 keyed on the call's seed, counter = key index
/ 4, query index, head, sequence), so the forward and the backward kernel
regenerate the same mask whatever their tilings, and ``philox_keep_mask``
computes the very same bits in integer tensor ops for the plain versions.
The head word is the model's head index: a call on heads ``head_offset``
.. ``head_offset + H - 1`` (a tensor-parallel rank's, parallel/tensor.py)
draws the bits one call on every head draws for them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from faceformer_tpu_torch import ops
from faceformer_tpu_torch.ops import _build

NEG = float(np.finfo(np.float32).min)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
# keys a tile of the tensor-core key-tiled kernels: the forward
# (csrc/attention_tiled_tc.cuh) and the backward's dq (csrc/flash_bwd_tiled_tc.cuh)
TILED_TC_KEYS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def padding_mask_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(N, Sk) bool (True = padded) -> additive fp32 bias (0 or NEG)."""
    zero = torch.zeros((), dtype=torch.float32, device=key_padding_mask.device)
    return torch.where(key_padding_mask, torch.full_like(zero, NEG), zero)


# ---------------------------------------------------------------------------
# the keep mask
# ---------------------------------------------------------------------------


def dropout_scale(rate: float) -> float:
    """What a kept probability is multiplied by: 1 / (1 - rate), which the
    kernels and the plain versions both round to fp32 once. (JAX divides by
    1 - rate; the two differ by an ulp at most.)"""
    return 1.0 / (1.0 - rate)


def dropout_threshold(rate: float) -> int:
    """keep <=> random bits < uint32((1 - rate) * 2^32) (flash.py:100-101)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return int((1.0 - rate) * 4294967296.0)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32 bits of m * x for 0 <= m, x < 2^32, in int64 tensors
    without overflow: x is split into 16-bit halves."""
    a = (x & 0xFFFF) * m
    b = (x >> 16) * m
    mid = (a >> 16) + b
    return mid >> 16, ((mid & 0xFFFF) << 16) | (a & 0xFFFF)


def philox4x32_10(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32 with 10 rounds on int64 tensors holding uint32 values:
    four counter words (broadcastable tensors) and two key words (ints)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return c0, c1, c2, c3


def philox_keep_mask(seed: int, n: int, h: int, sq: int, sk: int, rate: float,
                     device=None, head0: int = 0) -> torch.Tensor:
    """(n, h, sq, sk) bool keep mask of attention dropout, bit for bit the
    mask the CUDA kernels apply for this seed: one Philox call per (sequence,
    head, query, group of 4 keys) yields the bits of those four keys. The
    h heads are the model's heads head0 .. head0 + h - 1."""
    seed = int(seed)
    groups = -(-sk // 4)

    def ar(count, shape):
        return torch.arange(count, dtype=torch.int64, device=device).reshape(shape)

    words = philox4x32_10(
        (ar(groups, (1, 1, 1, groups)), ar(sq, (1, 1, sq, 1)), ar(h, (1, h, 1, 1)) + head0,
         ar(n, (n, 1, 1, 1))), (seed & _U32, (seed >> 32) & _U32))
    bits = torch.stack([w.expand(n, h, sq, groups) for w in words], dim=-1)
    return bits.reshape(n, h, sq, groups * 4)[..., :sk] < dropout_threshold(rate)


def keep_mask_on_card(seed: int, n: int, h: int, sq: int, sk: int, rate: float,
                      device, head0: int = 0) -> torch.Tensor:
    """The same mask written by the card, through the device function both
    flash kernels call; for comparisons with ``philox_keep_mask``."""
    out = torch.empty((n, h, sq, sk), dtype=torch.uint8, device=device)
    fn = _build.bind("flash", "flash_keep_mask", [ctypes.c_uint64, ctypes.c_uint32,
                                                  ctypes.c_uint32]
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    with torch.cuda.device(out.device):
        status = fn(int(seed), dropout_threshold(rate), int(head0), n, h, sq, sk,
                    _build.ptr(out),
                    _build.stream_ptr(out.device))
        _build.check("flash", status, "flash_keep_mask launch")
    return out.bool()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, bias, causal: bool) -> torch.Tensor:
    """(N, H, Sq, Sk) fp32 scores (q.k)*scale + bias, NEG above the diagonal
    when causal (flash.py::_head_scores)."""
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    s = s + bias[:, None, None, :]
    if causal:
        sq, sk = s.shape[-2:]
        above = torch.ones((sq, sk), dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, NEG)
    return s


def flash_attention_plain(q, k, v, bias, causal: bool = False, dropout_rate: float = 0.0,
                          seed: int = 0, head0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, with the Pallas kernel's rounding
    points: fp32 scores, fp32 softmax, then the keep mask (p * 1/(1 - rate)
    where kept, else 0), probabilities cast to v's dtype before the product.
    Returns (out (N, Sq, H, hd), lse (N, Sq, H) fp32 of the scores)."""
    s = _scores(q, k, bias, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom
    if dropout_rate > 0.0:
        keep = philox_keep_mask(seed, *p.shape, dropout_rate, device=p.device, head0=head0)
        p = torch.where(keep, p * dropout_scale(dropout_rate), torch.zeros_like(p))
    out = torch.einsum("nhqk,nkhd->nqhd", p.to(v.dtype).float(), v.float()).to(q.dtype)
    lse = (m + torch.log(denom))[..., 0].permute(0, 2, 1).contiguous()
    return out, lse


def flash_attention_bwd_plain(q, k, v, bias, lse, dout, causal: bool = False,
                              dropout_rate: float = 0.0, seed: int = 0, head0: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward written out in plain PyTorch with ``_bwd_kernel``'s
    formulas and rounding points (flash.py:140-186): everything in fp32
    after the loads, probabilities recomputed from lse, dq/dk/dv cast to
    their inputs' dtypes at the end. Returns (dq, dk, dv)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, causal)
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])  # pre-dropout; masked -> 0
    dp = torch.einsum("nqhd,nkhd->nhqk", dof, vf)
    p_used = p
    if dropout_rate > 0.0:
        keep = philox_keep_mask(seed, *p.shape, dropout_rate, device=p.device, head0=head0)
        zero = torch.zeros_like(p)
        p_used = torch.where(keep, p * dropout_scale(dropout_rate), zero)
        dp = torch.where(keep, dp * dropout_scale(dropout_rate), zero)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, kf).to(q.dtype)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, qf).to(k.dtype)
    dv = torch.einsum("nhqk,nqhd->nkhd", p_used, dof).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, bias) -> None:
    n, _, h, hd = q.shape
    sk = k.shape[1]
    if k.shape != (n, sk, h, hd) or v.shape != k.shape or bias.shape != (n, sk):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, bias {tuple(bias.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: "
                         "need one of float32, bfloat16")
    if bias.dtype != torch.float32:
        raise ValueError("bias must be float32")


def _check_smem(lib: str, entry: str, dt: int, sk: int, hd: int) -> None:
    """Raise unless the kernel that takes (dtype, Sk, hd) fits a block's
    shared memory. Key sides past the whole-row kernels' reach run their
    key-tiled kernels, so only a head dim whose single key tile does not
    fit is refused."""
    smem_fn = getattr(_build.load(lib), entry)
    smem_fn.argtypes = [ctypes.c_int] * 3
    smem_fn.restype = ctypes.c_size_t
    need = smem_fn(dt, sk, hd)
    if need > SMEM_LIMIT:
        raise ValueError(f"key length {sk} at head dim {hd}: even one key tile needs {need} B "
                         f"of shared memory, above the {SMEM_LIMIT} B a block may use on sm_90")


def key_tile(kernel: str, dtype: torch.dtype, sk: int, hd: int) -> int:
    """Keys a tile of the kernel that takes this call ("fwd": K2; "bwd":
    K3's dq kernel), or 0 where the whole key side is staged at once."""
    lib, entry = {"fwd": ("flash", "flash_key_tile"), "bwd": ("flash_bwd", "flash_bwd_key_tile")}[
        kernel]
    fn = getattr(_build.load(lib), entry)
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return int(fn(_DTYPES[dtype], sk, hd))


_DROPOUT_ARGS = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32]


def flash_attention_fwd(q, k, v, bias, causal: bool = False, impl: str = "auto",
                        dropout_rate: float = 0.0, seed: int = 0, head0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (N, Sq, H, hd), k/v (N, Sk, H, hd) of one dtype (float32 or
    bfloat16), bias (N, Sk) fp32 additive -> (out (N, Sq, H, hd), lse
    (N, Sq, H) fp32). ``dropout_rate`` > 0 drops attention probabilities
    with the keep mask of ``seed`` for the model's heads head0 .. head0 + H - 1.

    CUDA tensors launch the kernel (a key-tiled form past 256 keys or where
    the key side does not fit a block's shared memory: for bf16 at hd = 64
    the tensor-core one); CPU tensors (or impl="plain") run
    ``flash_attention_plain``."""
    _check(q, k, v, bias)
    n, sq, h, hd = q.shape
    sk = k.shape[1]
    threshold = dropout_threshold(dropout_rate) if dropout_rate > 0.0 else 0
    if not ops.use_kernel(impl, q, k, v, bias):
        return flash_attention_plain(q, k, v, bias, causal, dropout_rate, seed, head0)
    for t in (q, k, v, bias):
        if not t.is_contiguous():
            raise ValueError("flash_attention needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs q, k and v on 16-byte boundaries")
    dt = _DTYPES[q.dtype]
    _check_smem("flash", "flash_smem_bytes", dt, sk, hd)
    tiled_tc = key_tile("fwd", q.dtype, sk, hd) == TILED_TC_KEYS
    out = torch.empty_like(q)
    lse = torch.empty((n, sq, h), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash", "flash_fwd", [ctypes.c_int] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int] + _DROPOUT_ARGS
                     + [ctypes.c_void_p] * 3)
    with ops.launching("flash_fwd", q.device):
        status = fn(dt, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(bias),
                    n, sq, sk, h, hd, hd ** -0.5, int(causal), int(seed), threshold,
                    dropout_scale(dropout_rate), int(head0), _build.ptr(out), _build.ptr(lse),
                    _build.stream_ptr(q.device))
        _build.check("flash", status, "flash_fwd launch")
    if tiled_tc:
        ops.LAUNCHES["flash_fwd_tiled_tc"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, bias, lse, dout, causal: bool = False, impl: str = "auto",
                        dropout_rate: float = 0.0, seed: int = 0, head0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention_fwd``'s out with respect
    to q, k, v, given its lse (N, Sq, H) and the cotangent dout of out's
    shape and dtype. The bias is a mask and the seed is RNG material:
    neither has a gradient.

    CUDA tensors launch the kernels (bf16 at hd = 64 past 256 keys: the
    tensor-core key-tiled pair; elsewhere a key-tiled dq kernel where the
    key side does not fit a block's shared memory); CPU tensors (or
    impl="plain") run ``flash_attention_bwd_plain``."""
    _check(q, k, v, bias)
    n, sq, h, hd = q.shape
    sk = k.shape[1]
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (n, sq, h) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(n, sq, h)}, not {lse.dtype} "
                         f"{tuple(lse.shape)}")
    threshold = dropout_threshold(dropout_rate) if dropout_rate > 0.0 else 0
    if not ops.use_kernel(impl, q, k, v, bias, lse, dout):
        return flash_attention_bwd_plain(q, k, v, bias, lse, dout, causal, dropout_rate, seed,
                                         head0)
    for t in (q, k, v, bias, lse, dout):
        if not t.is_contiguous():
            raise ValueError("flash_attention_bwd needs contiguous tensors")
    dt = _DTYPES[q.dtype]
    lib = _build.load("flash_bwd")
    lib.flash_bwd_max_head_dim.argtypes = []
    lib.flash_bwd_max_head_dim.restype = ctypes.c_int
    if hd > lib.flash_bwd_max_head_dim() or (dt == 1 and hd % 8):
        raise ValueError(f"head dim {hd} is not supported by the backward kernel")
    _check_smem("flash_bwd", "flash_bwd_smem_bytes", dt, sk, hd)
    tiled_tc = key_tile("bwd", q.dtype, sk, hd) == TILED_TC_KEYS
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((n, sq, h), dtype=torch.float32, device=q.device)
    # the keep bits the dq kernel draws and the dk/dv kernel reads
    lib.flash_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 7
    lib.flash_bwd_workspace_bytes.restype = ctypes.c_size_t
    ws_bytes = lib.flash_bwd_workspace_bytes(dt, n, sq, sk, h, hd, int(threshold != 0))
    keep_bits = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device) if ws_bytes else None
    fn = _build.bind("flash_bwd", "flash_bwd", [ctypes.c_int] + [ctypes.c_void_p] * 6
                     + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int] + _DROPOUT_ARGS
                     + [ctypes.c_void_p] * 6)
    with ops.launching("flash_bwd", q.device):
        status = fn(dt, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(bias),
                    _build.ptr(lse), _build.ptr(dout), n, sq, sk, h, hd, hd ** -0.5, int(causal),
                    int(seed), threshold, dropout_scale(dropout_rate), int(head0), _build.ptr(dq),
                    _build.ptr(dk), _build.ptr(dv), _build.ptr(delta),
                    ctypes.c_void_p(None if keep_bits is None else keep_bits.data_ptr()),
                    _build.stream_ptr(q.device))
        _build.check("flash_bwd", status, "flash_bwd launch")
    if tiled_tc:
        ops.LAUNCHES["flash_bwd_tiled_tc"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 forward, K3 backward. Saves q, k, v, bias and lse, never the
    probabilities; the backward regenerates the keep mask from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, dropout_rate, seed, impl, head0):
        out, lse = flash_attention_fwd(q, k, v, bias, causal, impl, dropout_rate, seed, head0)
        ctx.save_for_backward(q, k, v, bias, lse)
        ctx.args = (causal, impl, dropout_rate, seed, head0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, lse = ctx.saved_tensors
        causal, impl, dropout_rate, seed, head0 = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, lse, dout.contiguous(), causal, impl,
                                         dropout_rate, seed, head0)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, bias, causal: bool = False, dropout_rate: float = 0.0,
                    seed: Optional[int] = None, impl: str = "auto",
                    head_offset: int = 0) -> torch.Tensor:
    """Attention output, differentiable in q, k and v through the backward
    kernel. ``seed`` is required when ``dropout_rate`` > 0; without a seed
    nothing is dropped (the eval path). ``head_offset``: the model's index
    of the call's first head (a tensor-parallel rank's first head), which
    the keep mask is keyed on."""
    if seed is None:
        dropout_rate, seed = 0.0, 0
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                bias.contiguous(), causal, float(dropout_rate), int(seed), impl,
                                int(head_offset))
