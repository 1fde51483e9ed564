"""Transformer building blocks (DETR convention), PyTorch counterpart of
faceformer_tpu/models/layers.py.

Parameters live in ``nn.Module`` containers (``nn.Linear``, ``nn.LayerNorm``,
``nn.ModuleList`` of layers) and stay float32; the functions below cast
them to the activation dtype at use, as the JAX package does. Math contract
(reference: faceformer/transformer.py:127-269):
  - positional embeddings are added to q and k only, never to values;
  - pre-LN ("normalize_before") residual blocks by default, post-LN switch;
  - q is scaled by head_dim**-0.5 (inside the attention kernel);
  - masks fill with the float32 minimum, never -inf;
  - LayerNorm and softmax run in fp32 whatever the activation dtype.

Every attention call goes through ``ops.flash.flash_attention`` (the CUDA
kernels on a card, forward and backward; their plain versions on the CPU).

Dropout (training) sits where the JAX layers have it: on the attention
probabilities inside the flash kernel, after self-attention, after
cross-attention, after the FFN activation and after the FFN output.
Randomness is explicit, as ``rng`` is in JAX: a layer gets one integer seed
per site (``seeds``), and each site makes its mask from its seed alone. No
mask depends on a generator's state, so a layer that runs twice under remat
draws the same masks. ``seeds=None`` is eval: nothing is dropped.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from faceformer_tpu_torch.ops.flash import flash_attention, padding_mask_bias

NEG = float(np.finfo(np.float32).min)


class Attention(nn.Module):
    """torch.nn.MultiheadAttention-compatible projections, kept as four
    separate linears like the JAX tree (wq/bq, wk/bk, wv/bv, wo/bo)."""

    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, ffn_dim)
        self.lin2 = nn.Linear(ffn_dim, dim)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.self_attn = Attention(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_dim)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.self_attn = Attention(dim)
        self.cross_attn = Attention(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_dim)


class Stack(nn.Module):
    """A stack of layers plus its final norm (the JAX tree's
    ``{"layers": stacked, "norm": ...}``)."""

    def __init__(self, layers, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (population variance), cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * norm.weight.float() + norm.bias.float()).to(x.dtype)


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b in x's dtype (product rounded, then the bias added, as the
    JAX ``linear`` does)."""
    return x @ lin.weight.to(x.dtype).t() + lin.bias.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Inverted dropout; identity when seed is None (eval) or rate == 0.
    The mask is a function of (seed, shape, device) only: a generator on
    x's device seeded with ``seed`` draws it."""
    if seed is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


ENCODER_SITES = 4  # attention probabilities, after attention, FFN activation, FFN output
DECODER_SITES = 6  # self-attn probs, after it, cross-attn probs, after it, FFN act, FFN out


def draw_seeds(generator: torch.Generator, count: int):
    """``count`` integer seeds from ``generator``, as Python ints."""
    return torch.randint(0, 2 ** 62, (count,), generator=generator,
                         device=generator.device).tolist()


def _sites(seeds: Optional[Sequence[int]], count: int):
    if seeds is None:
        return (None,) * count
    if len(seeds) != count:
        raise ValueError(f"a layer needs {count} dropout seeds, got {len(seeds)}")
    return tuple(seeds)


def activation_fn(name: str):
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if name == "glu":
        return lambda x: F.glu(x, dim=-1)
    raise ValueError(f"activation should be relu/gelu/glu, not {name}")


def _split_heads(x: torch.Tensor, num_head: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], num_head, x.shape[-1] // num_head)


def multihead_attention(
    attn: Attention,
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    num_head: int,
    causal: bool = False,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Batch-first multi-head attention.

    query (*Bq, Sq, E); key/value (*Bk, Sk, E) with Bk equal to Bq, or the
    anchor-broadcast form query (N, F, T, E) against key (N, 1, S, E), whose
    anchor axis folds into the query sequence (one attention per sample,
    no per-anchor copy of memory; layers.py:325-332). key_padding_mask:
    broadcastable to (*Bk, Sk), True = padded. ``causal`` masks keys after
    each query (training's decoder self-attention). With a ``seed``, the
    attention probabilities are dropped at ``dropout_rate`` inside the kernel.
    ``impl="plain"`` runs the flash kernels' plain versions, for comparisons.
    """
    q = _split_heads(linear(attn.q, query), num_head)
    k = _split_heads(linear(attn.k, key), num_head)
    v = _split_heads(linear(attn.v, value), num_head)

    if q.ndim == 5 and k.ndim == 5 and k.shape[1] == 1 and q.shape[1] > 1:
        if causal:
            raise ValueError("causal attention cannot fold the anchor axis")
        n, f, t, h, hd = q.shape
        sk = k.shape[2]
        kp = (torch.zeros((n, sk), dtype=torch.bool, device=q.device)
              if key_padding_mask is None
              else key_padding_mask.expand(n, 1, sk).reshape(n, sk))
        out = flash_attention(q.reshape(n, f * t, h, hd), k[:, 0], v[:, 0],
                              padding_mask_bias(kp), dropout_rate=dropout_rate, seed=seed,
                              impl=impl)
        return linear(attn.o, out.reshape(n, f, t, h * hd))

    *batch, sq, h, hd = q.shape
    sk = k.shape[-3]
    if tuple(k.shape[:-3]) != tuple(batch):
        raise ValueError(f"key batch {tuple(k.shape[:-3])} != query batch {tuple(batch)}")
    n = math.prod(batch)
    kp = (torch.zeros((n, sk), dtype=torch.bool, device=q.device)
          if key_padding_mask is None
          else key_padding_mask.expand(*batch, sk).reshape(n, sk))
    out = flash_attention(
        q.reshape(n, sq, h, hd), k.reshape(n, sk, h, hd), v.reshape(n, sk, h, hd),
        padding_mask_bias(kp), causal=causal, dropout_rate=dropout_rate, seed=seed, impl=impl)
    return linear(attn.o, out.reshape(*batch, sq, h * hd))


# ---------------------------------------------------------------------------
# encoder / decoder layers (pre-LN and post-LN paths)
# ---------------------------------------------------------------------------


def _ffn(ffn: FeedForward, x: torch.Tensor, act, rate: float = 0.0,
         seed: Optional[int] = None) -> torch.Tensor:
    return linear(ffn.lin2, dropout(act(linear(ffn.lin1, x)), rate, seed))


def encoder_layer(
    layer: EncoderLayer,
    x: torch.Tensor,
    pos: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    *,
    num_head: int,
    activation: str,
    normalize_before: bool,
    dropout_rate: float = 0.0,
    seeds: Optional[Sequence[int]] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """One encoder block (reference: transformer.py:146-184)."""
    act = activation_fn(activation)
    rate = dropout_rate
    s_attn, s1, s_ffn_in, s2 = _sites(seeds, ENCODER_SITES)
    attend = dict(key_padding_mask=key_padding_mask, dropout_rate=rate, seed=s_attn, impl=impl)
    if normalize_before:
        x2 = layer_norm(layer.norm1, x)
        qk = x2 + pos
        sa = multihead_attention(layer.self_attn, qk, qk, x2, num_head, **attend)
        x = x + dropout(sa, rate, s1)
        x2 = layer_norm(layer.norm2, x)
        return x + dropout(_ffn(layer.ffn, x2, act, rate, s_ffn_in), rate, s2)
    qk = x + pos
    sa = multihead_attention(layer.self_attn, qk, qk, x, num_head, **attend)
    x = layer_norm(layer.norm1, x + dropout(sa, rate, s1))
    ff = _ffn(layer.ffn, x, act, rate, s_ffn_in)
    return layer_norm(layer.norm2, x + dropout(ff, rate, s2))


def decoder_layer(
    layer: DecoderLayer,
    tgt: torch.Tensor,
    memory: torch.Tensor,
    query_pos: torch.Tensor,
    pos: torch.Tensor,
    *,
    num_head: int,
    activation: str,
    normalize_before: bool,
    causal: bool = False,
    tgt_key_padding_mask: Optional[torch.Tensor] = None,
    memory_key_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seeds: Optional[Sequence[int]] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """One decoder block: self-attn, cross-attn to memory, FFN
    (reference: transformer.py:209-259). ``memory`` may carry a size-1
    anchor axis against ``tgt`` (anchor-parallel decode)."""
    act = activation_fn(activation)
    rate = dropout_rate
    s_sa, s1, s_ca, s2, s_ffn_in, s3 = _sites(seeds, DECODER_SITES)
    self_kw = dict(causal=causal, key_padding_mask=tgt_key_padding_mask, dropout_rate=rate,
                   seed=s_sa, impl=impl)
    cross_kw = dict(key_padding_mask=memory_key_padding_mask, dropout_rate=rate, seed=s_ca,
                    impl=impl)
    if normalize_before:
        t2 = layer_norm(layer.norm1, tgt)
        qk = t2 + query_pos
        sa = multihead_attention(layer.self_attn, qk, qk, t2, num_head, **self_kw)
        tgt = tgt + dropout(sa, rate, s1)
        t2 = layer_norm(layer.norm2, tgt)
        ca = multihead_attention(layer.cross_attn, t2 + query_pos, memory + pos, memory,
                                 num_head, **cross_kw)
        tgt = tgt + dropout(ca, rate, s2)
        t2 = layer_norm(layer.norm3, tgt)
        return tgt + dropout(_ffn(layer.ffn, t2, act, rate, s_ffn_in), rate, s3)
    qk = tgt + query_pos
    sa = multihead_attention(layer.self_attn, qk, qk, tgt, num_head, **self_kw)
    tgt = layer_norm(layer.norm1, tgt + dropout(sa, rate, s1))
    ca = multihead_attention(layer.cross_attn, tgt + query_pos, memory + pos, memory,
                             num_head, **cross_kw)
    tgt = layer_norm(layer.norm2, tgt + dropout(ca, rate, s2))
    ff = _ffn(layer.ffn, tgt, act, rate, s_ffn_in)
    return layer_norm(layer.norm3, tgt + dropout(ff, rate, s3))


REMAT_POLICIES = ("full", "dots", "attn", "attn_ffn")


def _run_stack(layer_fn, layers, x: torch.Tensor, seeds, remat: bool, remat_policy: str):
    """Apply ``layer_fn(layer, x, layer_seeds)`` over the stack. ``seeds``
    holds one row of site seeds per layer, or is None (eval).

    ``remat`` recomputes each layer in the backward pass and saves only the
    layer boundary (the JAX package's "full" policy, layers.py:475-506). The
    seeds are arguments of the layer, so the recomputation replays the same
    dropout masks. The named policies that keep tagged block outputs
    resident have no counterpart here yet."""
    if remat and remat_policy != "full":
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"model.remat_policy must be one of {sorted(REMAT_POLICIES)}, "
                             f"got {remat_policy!r}")
        raise NotImplementedError(
            f"remat_policy {remat_policy!r} is not ported: only 'full' "
            "(torch.utils.checkpoint around each layer) is")
    for i, layer in enumerate(layers):
        layer_seeds = None if seeds is None else seeds[i]
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer_fn, layer, x, layer_seeds, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer_fn(layer, x, layer_seeds)
    return x


def encoder_forward(
    encoder: Stack,
    x: torch.Tensor,
    pos: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    *,
    num_head: int,
    activation: str = "relu",
    normalize_before: bool = True,
    dropout_rate: float = 0.0,
    seeds=None,
    remat: bool = False,
    remat_policy: str = "full",
    impl: str = "auto",
) -> torch.Tensor:
    """Full encoder stack + final norm in pre-LN (reference:
    transformer.py:62-83). ``seeds``: (layers, ENCODER_SITES) ints, or None."""

    def fn(layer, x, layer_seeds):
        return encoder_layer(layer, x, pos, key_padding_mask, num_head=num_head,
                             activation=activation, normalize_before=normalize_before,
                             dropout_rate=dropout_rate, seeds=layer_seeds, impl=impl)

    x = _run_stack(fn, encoder.layers, x, seeds, remat, remat_policy)
    if normalize_before:
        x = layer_norm(encoder.norm, x)
    return x


def decoder_forward(
    decoder: Stack,
    tgt: torch.Tensor,
    memory: torch.Tensor,
    query_pos: torch.Tensor,
    pos: torch.Tensor,
    *,
    num_head: int,
    activation: str = "relu",
    normalize_before: bool = True,
    causal: bool = False,
    tgt_key_padding_mask: Optional[torch.Tensor] = None,
    memory_key_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seeds=None,
    remat: bool = False,
    remat_policy: str = "full",
    impl: str = "auto",
) -> torch.Tensor:
    """Full decoder stack + final norm (the decoder norm exists in both
    pre/post-LN modes, reference model.py:42-43). ``seeds``: (layers,
    DECODER_SITES) ints, or None."""

    def fn(layer, x, layer_seeds):
        return decoder_layer(
            layer, x, memory, query_pos, pos, num_head=num_head,
            activation=activation, normalize_before=normalize_before,
            causal=causal, tgt_key_padding_mask=tgt_key_padding_mask,
            memory_key_padding_mask=memory_key_padding_mask,
            dropout_rate=dropout_rate, seeds=layer_seeds, impl=impl)

    tgt = _run_stack(fn, decoder.layers, tgt, seeds, remat, remat_policy)
    return layer_norm(decoder.norm, tgt)
