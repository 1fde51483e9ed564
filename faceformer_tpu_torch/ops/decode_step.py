"""K4 fused decode step: one whole greedy step of the anchor-parallel decoder.

Replaces faceformer_tpu/ops/decode_step.py::decode_step (pl.pallas_call at
decode_step.py:414), the whole step of the ``fused`` engine. One C entry,
``decode_step`` in csrc/decode_step.cu, launches a fixed sequence of
hand-written kernels on the current stream (its header says what bounds the
step on the card and how the design answers that); no library GEMM runs
inside it. Contract as in the JAX package: pre-LN blocks and a ReLU FFN.

Layouts (the port's own; the TPU's lane-packed K|V cache and sample blocks
do not carry over): x (R, E) with R = N*F anchor rows, sample-major;
self-attention cache (L, 2, R, T, E), K then V, updated in place at slot
``step``; cross K/V (L, N, S, E); memory (N, S, E); mem_bias (N, S) fp32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from faceformer_tpu_torch import ops
from faceformer_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows of the per-layer vector table (faceformer_tpu/ops/decode_step.py:101-103)
_BQ, _BK, _BV, _BO, _CBQ, _CBO, _FB2 = range(7)
_N1S, _N1B, _N2S, _N2B, _N3S, _N3B = range(7, 13)
_NVEC = 16


@torch.no_grad()
def pack_decoder_weights(model, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Pack the decoder's weights once per decode call, outside the step
    loop: matrices in the compute dtype in (in, out) layout, biases and norm
    parameters in fp32 (the pointer bias rounded through the compute dtype,
    as the Pallas kernel reads it)."""
    layers = model.decoder.layers
    f32 = torch.float32

    def w(lin):
        return lin.weight.t().to(dtype)

    w_mats = torch.stack([torch.stack(
        [w(ly.self_attn.q), w(ly.self_attn.k), w(ly.self_attn.v), w(ly.self_attn.o),
         w(ly.cross_attn.q), w(ly.cross_attn.o)]) for ly in layers])
    zeros = torch.zeros_like(layers[0].norm1.weight, dtype=f32)
    vecs = torch.stack([torch.stack(
        [ly.self_attn.q.bias, ly.self_attn.k.bias, ly.self_attn.v.bias, ly.self_attn.o.bias,
         ly.cross_attn.q.bias, ly.cross_attn.o.bias, ly.ffn.lin2.bias,
         ly.norm1.weight, ly.norm1.bias, ly.norm2.weight, ly.norm2.bias,
         ly.norm3.weight, ly.norm3.bias, zeros, zeros, zeros]).to(f32) for ly in layers])
    return {
        "w_mats": w_mats.contiguous(),                                     # (L, 6, E, E)
        "vecs": vecs.contiguous(),                                         # (L, 16, E)
        "ffn_w1": torch.stack([w(ly.ffn.lin1) for ly in layers]).contiguous(),  # (L, E, FF)
        "ffn_w2": torch.stack([w(ly.ffn.lin2) for ly in layers]).contiguous(),  # (L, FF, E)
        "ffn_b1": torch.stack([ly.ffn.lin1.bias for ly in layers]).to(f32).contiguous(),
        "final_norm": torch.stack([model.decoder.norm.weight,
                                   model.decoder.norm.bias]).to(f32).contiguous(),
        "proj_w": w(model.project).contiguous(),
        "proj_b": model.project.bias.detach().to(dtype).to(f32).contiguous(),
    }


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + 1e-5) * scale + bias).to(x.dtype)


@torch.no_grad()
def decode_step_plain(step: int, x, qpos_t, packed, cross_k, cross_v, memory, mem_bias,
                      cache, num_head: int, pointer_out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same step in plain PyTorch with the kernel's rounding points:
    q, k_t, v_t rounded to the compute type after fp32 accumulation plus
    bias; cross-attention fp32 until its residual add; residual adds in the
    compute type; pointer logits fp32. Writes the cache slot in place, and
    the pointer vectors into ``pointer_out`` when given."""
    dt = x.dtype
    r, e = x.shape
    n, s = mem_bias.shape
    f = r // n
    hd = e // num_head
    scale = hd ** -0.5
    qpos = qpos_t.float()

    def mm(a, wt, b):
        return a.float() @ wt.float() + b

    def add(h, y):  # residual add in the compute dtype
        return (h.float() + y.to(dt).float()).to(dt)

    h = x
    for lyr in range(packed["w_mats"].shape[0]):
        vec, wm = packed["vecs"][lyr], packed["w_mats"][lyr]
        xn = _ln(h, vec[_N1S], vec[_N1B])
        qk = (xn.float() + qpos).to(dt)
        q = mm(qk, wm[0], vec[_BQ]).to(dt)
        cache[lyr, 0, :, step] = mm(qk, wm[1], vec[_BK]).to(dt)
        cache[lyr, 1, :, step] = mm(xn, wm[2], vec[_BV]).to(dt)
        k = cache[lyr, 0, :, :step + 1].float().reshape(r, step + 1, num_head, hd)
        v = cache[lyr, 1, :, :step + 1].float().reshape(r, step + 1, num_head, hd)
        sc = torch.einsum("rhd,rjhd->rhj", (q.float() * scale).reshape(r, num_head, hd), k)
        attn = torch.einsum("rhj,rjhd->rhd", torch.softmax(sc, dim=-1), v)
        h = add(h, mm(attn.reshape(r, e).to(dt), wm[3], vec[_BO]))

        qk = (_ln(h, vec[_N2S], vec[_N2B]).float() + qpos).to(dt)
        q2 = (mm(qk, wm[4], vec[_CBQ]) * scale).reshape(n, f, num_head, hd)
        ck = cross_k[lyr].float().reshape(n, s, num_head, hd)
        cv = cross_v[lyr].float().reshape(n, s, num_head, hd)
        sc = torch.einsum("nfhd,nshd->nhfs", q2, ck) + mem_bias[:, None, None, :]
        cross = torch.einsum("nhfs,nshd->nfhd", torch.softmax(sc, dim=-1), cv)
        h = add(h, mm(cross.reshape(r, e), wm[5], vec[_CBO]))

        xn = _ln(h, vec[_N3S], vec[_N3B])
        h1 = torch.relu(mm(xn, packed["ffn_w1"][lyr], packed["ffn_b1"][lyr])).to(dt)
        h = add(h, mm(h1, packed["ffn_w2"][lyr], vec[_FB2]))

    fnorm = packed["final_norm"]
    pointer = mm(_ln(h, fnorm[0], fnorm[1]), packed["proj_w"], packed["proj_b"])
    if pointer_out is not None:
        pointer_out.copy_(pointer)
    logits = torch.einsum("nfe,nse->nfs", pointer.reshape(n, f, e), memory.float())
    tokens = (logits + mem_bias[:, None, :]).argmax(dim=-1).to(torch.int32)
    x_next = torch.gather(memory, 1, tokens.long()[..., None].expand(-1, -1, e))
    return x_next.reshape(r, e), tokens


def decode_step(step: int, x, qpos_t, packed, cross_k, cross_v, memory, mem_bias, cache, *,
                num_head: int, impl: str = "auto",
                pointer_out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one greedy step for every anchor row.

    step: host int, the position being decoded (0 <= step < T). x (R, E),
    qpos_t (E,), cross_k/cross_v (L, N, S, E), memory (N, S, E) and cache
    (L, 2, R, T, E) in the compute dtype (float32 or bfloat16); mem_bias
    (N, S) fp32. Returns (x_next (R, E), tokens (N, F) int32); the cache
    slot ``step`` is written in place. ``pointer_out``, an optional (R, E)
    fp32 tensor, receives the pointer vectors the argmax reads (final LN
    and projection), so checks can see the step's output before the
    argmax. CUDA tensors launch the kernel sequence; CPU tensors (or
    impl="plain") run ``decode_step_plain``."""
    dt = x.dtype
    r, e = x.shape
    n, s = mem_bias.shape
    lyr, two, rc, t_max, ec = cache.shape
    ff = packed["ffn_w1"].shape[-1]
    if dt not in _DTYPES:
        raise ValueError(f"compute dtype {dt}: need float32 or bfloat16")
    if r % n or (two, rc, ec) != (2, r, e) or not 0 <= step < t_max or e % num_head:
        raise ValueError(f"inconsistent shapes: x {tuple(x.shape)}, cache {tuple(cache.shape)}, "
                         f"mem_bias {tuple(mem_bias.shape)}, step {step}")
    expected = {
        "qpos_t": (qpos_t, (e,), dt), "cross_k": (cross_k, (lyr, n, s, e), dt),
        "cross_v": (cross_v, (lyr, n, s, e), dt), "memory": (memory, (n, s, e), dt),
        "mem_bias": (mem_bias, (n, s), torch.float32), "cache": (cache, cache.shape, dt),
        "w_mats": (packed["w_mats"], (lyr, 6, e, e), dt),
        "vecs": (packed["vecs"], (lyr, _NVEC, e), torch.float32),
        "ffn_w1": (packed["ffn_w1"], (lyr, e, ff), dt),
        "ffn_w2": (packed["ffn_w2"], (lyr, ff, e), dt),
        "ffn_b1": (packed["ffn_b1"], (lyr, ff), torch.float32),
        "final_norm": (packed["final_norm"], (2, e), torch.float32),
        "proj_w": (packed["proj_w"], (e, e), dt),
        "proj_b": (packed["proj_b"], (e,), torch.float32),
    }
    if pointer_out is not None:
        expected["pointer_out"] = (pointer_out, (r, e), torch.float32)
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {tuple(shape)} {dtype}")
    tensors = [x] + [t for t, _, _ in expected.values()]
    if not ops.use_kernel(impl, *tensors):
        return decode_step_plain(step, x, qpos_t, packed, cross_k, cross_v, memory, mem_bias,
                                 cache, num_head, pointer_out)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_step needs contiguous tensors")
    vec = 16 // x.element_size()  # the self-attention kernel's 16-byte loads
    lanes = (e // num_head) // vec
    if (e // num_head) % vec or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"head dim {e // num_head} does not fit the kernel's 16-byte loads")

    dev = x.device

    def scratch(cols, dtype=dt):
        return torch.empty((r, cols), dtype=dtype, device=dev)

    x_out = scratch(e)
    tokens = torch.empty((n, r // n), dtype=torch.int32, device=dev)
    # xs, xn, qk, q, attn; q2 (fp32: the cross queries, then the pointer
    # vectors), cross (fp32); h1
    work = [scratch(e) for _ in range(5)]
    work += [scratch(e, torch.float32) if pointer_out is None else pointer_out,
             scratch(e, torch.float32), scratch(ff)]
    fn = _build.bind("decode_step", "decode_step",
                     [ctypes.c_int] * 10 + [ctypes.c_void_p] * 26)
    status = fn(
        _DTYPES[dt], step, n, r // n, s, e, ff, num_head, lyr, t_max,
        *(_build.ptr(t) for t in (
            x, qpos_t, packed["w_mats"], packed["vecs"], packed["ffn_w1"], packed["ffn_w2"],
            packed["ffn_b1"], packed["final_norm"], packed["proj_w"], packed["proj_b"],
            cross_k, cross_v, memory, mem_bias, cache, x_out, tokens, *work)),
        _build.stream_ptr(dev))
    _build.check("decode_step", status, "decode_step launch")
    ops.LAUNCHES["decode_step"] += 1
    return x_out, tokens


_EPILOGUES = {"store": 0, "relu": 1, "residual": 2}


def decode_gemm_plain(a, w, bias, epilogue: str = "store", resid=None, out_dtype=None):
    """One product of the step in plain PyTorch with the kernel's rounding:
    y = a @ w + bias in fp32; "relu" clamps it at 0; "residual" returns
    resid + y with y first rounded to resid's dtype (the residual add in the
    compute type); else y in ``out_dtype`` (default: a's dtype)."""
    y = a.float() @ w.float() + bias
    if epilogue == "relu":
        y = torch.relu(y)
    if epilogue == "residual":
        return (resid.float() + y.to(resid.dtype).float()).to(resid.dtype)
    return y.to(out_dtype or a.dtype)


def decode_gemm(a, w, bias, *, epilogue: str = "store", resid=None, out_dtype=None,
                impl: str = "auto"):
    """One of the fused step's products alone, for tests and timing; no main
    path calls it (the step calls the GEMM from C). a (M, K) and w (K, N)
    in the step's (in, out) layout, bias (N,) float32; epilogue "store",
    "relu" or "residual" (then resid (M, N) gives the output dtype). The
    type combinations are the step's: w bfloat16 with a bfloat16 (any
    epilogue; "store" may also write float32) or a float32 (the cross
    out-projection: "residual" onto bfloat16), or everything float32.
    CUDA tensors launch csrc/decode_step.cu's GEMM; CPU tensors (or
    impl="plain") run ``decode_gemm_plain``."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r}: need one of {sorted(_EPILOGUES)}")
    m, k = a.shape
    n = w.shape[1]
    if w.shape != (k, n) or bias.shape != (n,) or bias.dtype != torch.float32:
        raise ValueError(f"a {tuple(a.shape)}, w {tuple(w.shape)}, bias {tuple(bias.shape)} "
                         f"{bias.dtype}: want (M, K), (K, N), (N,) float32")
    if (epilogue == "residual") != (resid is not None) or (
            resid is not None and resid.shape != (m, n)):
        raise ValueError("resid (M, N) goes with epilogue 'residual', and only with it")
    c_dtype = resid.dtype if epilogue == "residual" else (out_dtype or a.dtype)
    tensors = [a, w, bias] + ([resid] if resid is not None else [])
    if not ops.use_kernel(impl, *tensors):
        return decode_gemm_plain(a, w, bias, epilogue, resid, out_dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_gemm needs contiguous tensors")
    if any(t.dtype not in _DTYPES for t in (a, w)) or c_dtype not in _DTYPES:
        raise ValueError(f"dtypes a {a.dtype}, w {w.dtype}, out {c_dtype}: need float32 or "
                         "bfloat16")
    out = torch.empty((m, n), dtype=c_dtype, device=a.device)
    fn = _build.bind("decode_step", "decode_gemm",
                     [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p])
    status = fn(_DTYPES[a.dtype], _DTYPES[w.dtype], _DTYPES[c_dtype], _EPILOGUES[epilogue],
                m, n, k, _build.ptr(a), k, _build.ptr(w), n, _build.ptr(bias), _build.ptr(out), n,
                ctypes.c_void_p(None) if resid is None else _build.ptr(resid), n,
                _build.stream_ptr(a.device))
    _build.check("decode_step", status, f"decode_gemm launch ({a.dtype} . {w.dtype} -> "
                                        f"{c_dtype}, {epilogue})")
    ops.LAUNCHES["decode_gemm"] += 1
    return out
