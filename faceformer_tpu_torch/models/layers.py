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

Tensor parallelism (parallel/tensor.py): a module that ``shard_params_``
cut holds its rank's heads or FFN columns and a ``shard``. Each block then
takes its input through ``copy_to_model`` (the positions and the decoder's
memory once a stack), runs its local heads (the flash kernels keyed on
their global head index, so the keep masks are the one-rank run's), sums
its ``o`` or ``lin2`` product over the model ranks (``reduce_from_model``)
and adds that bias once. The FFN-activation dropout draws its mask at the
whole FFN width and keeps the rank's columns; every other site acts on
replicated activations and draws as at one rank. Without a shard every
function below runs as at one rank, op for op.

Remat (``model.remat``) recomputes each layer in the backward pass, keeping
what its policy names (JAX layers.py:475-506): "full" the layer's input
only; "dots" every matrix product without batch dims (``aten.mm`` and
``aten.addmm``: each linear's product, before its bias); "attn" the
attention blocks' outputs, tagged "attn_out"; "attn_ffn" those and the
FFN outputs, tagged "ffn_out". The tags are an identity op
(``faceformer_tpu_torch::ckpt_name``, a copy, as a custom op may not alias
its input) that a selective checkpoint's policy saves by name, as
``jax.ad_checkpoint.checkpoint_name`` marks a value for JAX's; they are
applied only under a named policy with gradients on. The flash kernels'
``autograd.Function`` is opaque to the policy, so K2 runs again in the
backward under every policy, as the Pallas call does under JAX's. Under
tensor parallelism a layer's collectives run inside its checkpoint: every
rank recomputes its layers, and their all-reduces, in the same order.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from faceformer_tpu_torch.ops.flash import flash_attention, padding_mask_bias
from faceformer_tpu_torch.parallel.tensor import Shard, copy_to_model, reduce_from_model

NEG = float(np.finfo(np.float32).min)


class Attention(nn.Module):
    """torch.nn.MultiheadAttention-compatible projections, kept as four
    separate linears like the JAX tree (wq/bq, wk/bk, wv/bv, wo/bo).
    ``shard``: the rank's place on the model axis, once cut."""

    shard: Optional[Shard] = None

    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)


class FeedForward(nn.Module):
    shard: Optional[Shard] = None

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

    shard: Optional[Shard] = None

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


def row_linear(lin: nn.Linear, x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """A row-parallel linear: the rank's partial product summed over the
    model ranks, then the whole bias once; ``linear`` without a shard."""
    if shard is None:
        return linear(lin, x)
    return reduce_from_model(x @ lin.weight.to(x.dtype).t(), shard) + lin.bias.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, seed: Optional[int],
            shard: Optional[Shard] = None) -> torch.Tensor:
    """Inverted dropout; identity when seed is None (eval) or rate == 0.
    The mask is a function of (seed, shape, device) only: a generator on
    x's device seeded with ``seed`` draws it. With a ``shard``, x holds the
    rank's columns of a tensor ``shard.size`` times as wide: the mask is
    drawn at that width and cut to the rank's columns."""
    if seed is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    if shard is None:
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    else:
        width = x.shape[-1]
        full = torch.rand((*x.shape[:-1], width * shard.size), generator=gen, device=x.device)
        mask = full[..., shard.rank * width:(shard.rank + 1) * width] < keep
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


@torch.library.custom_op("faceformer_tpu_torch::ckpt_name", mutates_args=())
def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


_tag.register_autograd(lambda ctx, grad: (grad, None))


def _ckpt_name(x: torch.Tensor, name: str, save_names: Sequence[str]) -> torch.Tensor:
    """Tag ``x`` for a named remat policy when the policy keeps ``name``;
    else ``x`` itself."""
    return _tag(x, name) if name in save_names else x


def activation_fn(name: str):
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if name == "glu":
        return lambda x: F.glu(x, dim=-1)
    raise ValueError(f"activation should be relu/gelu/glu, not {name}")


def split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(..., H * hd) -> (..., H, hd), H the heads of the weight that made
    ``x``: all of the model's, or a tensor-parallel rank's."""
    return x.reshape(*x.shape[:-1], x.shape[-1] // head_dim, head_dim)


def local_heads(attn: Attention, head_dim: int) -> int:
    """The heads ``attn``'s weights hold: all of the model's, or a
    tensor-parallel rank's (the rows of its cut q weight)."""
    return attn.q.weight.shape[0] // head_dim


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

    ``num_head`` counts the model's heads. A cut block (``attn.shard``)
    runs its rank's, as many as its q weight holds, on query/key/value that
    came through ``copy_to_model``; the keep mask is keyed on their global
    head index, and the output is summed over the model ranks.
    """
    head_dim = query.shape[-1] // num_head
    q = split_heads(linear(attn.q, query), head_dim)
    k = split_heads(linear(attn.k, key), head_dim)
    v = split_heads(linear(attn.v, value), head_dim)
    head_offset = 0 if attn.shard is None else attn.shard.rank * local_heads(attn, head_dim)

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
                              impl=impl, head_offset=head_offset)
        return row_linear(attn.o, out.reshape(n, f, t, h * hd), attn.shard)

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
        padding_mask_bias(kp), causal=causal, dropout_rate=dropout_rate, seed=seed, impl=impl,
        head_offset=head_offset)
    return row_linear(attn.o, out.reshape(*batch, sq, h * hd), attn.shard)


# ---------------------------------------------------------------------------
# encoder / decoder layers (pre-LN and post-LN paths)
# ---------------------------------------------------------------------------


def _ffn(ffn: FeedForward, x: torch.Tensor, act, rate: float = 0.0,
         seed: Optional[int] = None, save_names: Sequence[str] = ()) -> torch.Tensor:
    hidden = act(linear(ffn.lin1, copy_to_model(x, ffn.shard)))
    return _ckpt_name(row_linear(ffn.lin2, dropout(hidden, rate, seed, ffn.shard), ffn.shard),
                      "ffn_out", save_names)


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
    save_names: Sequence[str] = (),
) -> torch.Tensor:
    """One encoder block (reference: transformer.py:146-184). ``save_names``:
    the tags a named remat policy keeps. Under tensor parallelism ``pos``
    came through ``copy_to_model``."""
    act = activation_fn(activation)
    rate = dropout_rate
    s_attn, s1, s_ffn_in, s2 = _sites(seeds, ENCODER_SITES)
    attend = dict(key_padding_mask=key_padding_mask, dropout_rate=rate, seed=s_attn, impl=impl)

    def attention(x_in):
        value = copy_to_model(x_in, layer.self_attn.shard)
        qk = value + pos
        return _ckpt_name(multihead_attention(layer.self_attn, qk, qk, value, num_head, **attend),
                          "attn_out", save_names)

    if normalize_before:
        x = x + dropout(attention(layer_norm(layer.norm1, x)), rate, s1)
        x2 = layer_norm(layer.norm2, x)
        return x + dropout(_ffn(layer.ffn, x2, act, rate, s_ffn_in, save_names), rate, s2)
    x = layer_norm(layer.norm1, x + dropout(attention(x), rate, s1))
    ff = _ffn(layer.ffn, x, act, rate, s_ffn_in, save_names)
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
    save_names: Sequence[str] = (),
) -> torch.Tensor:
    """One decoder block: self-attn, cross-attn to memory, FFN
    (reference: transformer.py:209-259). ``memory`` may carry a size-1
    anchor axis against ``tgt`` (anchor-parallel decode). ``save_names``:
    the tags a named remat policy keeps. Under tensor parallelism
    ``memory``, ``query_pos`` and ``pos`` came through ``copy_to_model``."""
    act = activation_fn(activation)
    rate = dropout_rate
    s_sa, s1, s_ca, s2, s_ffn_in, s3 = _sites(seeds, DECODER_SITES)
    self_kw = dict(causal=causal, key_padding_mask=tgt_key_padding_mask, dropout_rate=rate,
                   seed=s_sa, impl=impl)
    cross_kw = dict(key_padding_mask=memory_key_padding_mask, dropout_rate=rate, seed=s_ca,
                    impl=impl)

    def self_attention(x_in):
        value = copy_to_model(x_in, layer.self_attn.shard)
        qk = value + query_pos
        return _ckpt_name(multihead_attention(layer.self_attn, qk, qk, value, num_head,
                                              **self_kw), "attn_out", save_names)

    def cross_attention(x_in):
        q = copy_to_model(x_in, layer.cross_attn.shard) + query_pos
        return _ckpt_name(multihead_attention(layer.cross_attn, q, memory + pos, memory,
                                              num_head, **cross_kw), "attn_out", save_names)

    if normalize_before:
        tgt = tgt + dropout(self_attention(layer_norm(layer.norm1, tgt)), rate, s1)
        tgt = tgt + dropout(cross_attention(layer_norm(layer.norm2, tgt)), rate, s2)
        t2 = layer_norm(layer.norm3, tgt)
        return tgt + dropout(_ffn(layer.ffn, t2, act, rate, s_ffn_in, save_names), rate, s3)
    tgt = layer_norm(layer.norm1, tgt + dropout(self_attention(tgt), rate, s1))
    tgt = layer_norm(layer.norm2, tgt + dropout(cross_attention(tgt), rate, s2))
    ff = _ffn(layer.ffn, tgt, act, rate, s_ffn_in, save_names)
    return layer_norm(layer.norm3, tgt + dropout(ff, rate, s3))


# the tags each remat policy keeps ("dots" keeps matrix products instead)
_SAVED_NAMES = {"full": (), "dots": (), "attn": ("attn_out",),
                "attn_ffn": ("attn_out", "ffn_out")}
REMAT_POLICIES = tuple(_SAVED_NAMES)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy_fn(remat_policy: str):
    """The selective checkpoint policy of a named remat policy: save what it
    keeps, recompute the rest."""
    names = _SAVED_NAMES[remat_policy]
    dots = remat_policy == "dots"

    def policy(ctx, op, *args, **kwargs):
        if (dots and op in _DOTS) or (op is torch.ops.faceformer_tpu_torch.ckpt_name.default
                                      and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _run_stack(layer_fn, layers, x: torch.Tensor, seeds, remat: bool, remat_policy: str):
    """Apply ``layer_fn(layer, x, layer_seeds, save_names)`` over the stack.
    ``seeds`` holds one row of site seeds per layer, or is None (eval).

    ``remat`` (with gradients on) runs each layer under
    ``torch.utils.checkpoint``, saving what ``remat_policy`` keeps (the
    module docstring) and recomputing the rest in the backward pass. The
    seeds are arguments of the layer, so the recomputation replays the same
    dropout masks."""
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"model.remat_policy must be one of {sorted(REMAT_POLICIES)}, "
                         f"got {remat_policy!r}")
    remat = remat and torch.is_grad_enabled()
    save_names = _SAVED_NAMES[remat_policy] if remat else ()
    kwargs = {}
    if remat and remat_policy != "full":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 remat_policy_fn(remat_policy))
    for i, layer in enumerate(layers):
        layer_seeds = None if seeds is None else seeds[i]
        if remat:
            x = checkpoint(layer_fn, layer, x, layer_seeds, save_names, use_reentrant=False,
                           preserve_rng_state=False, **kwargs)
        else:
            x = layer_fn(layer, x, layer_seeds, save_names)
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
    pos = copy_to_model(pos, encoder.shard)

    def fn(layer, x, layer_seeds, save_names):
        return encoder_layer(layer, x, pos, key_padding_mask, num_head=num_head,
                             activation=activation, normalize_before=normalize_before,
                             dropout_rate=dropout_rate, seeds=layer_seeds, impl=impl,
                             save_names=save_names)

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
    # the blocks' column-parallel inputs that every layer shares: their
    # gradients are summed over the model ranks once a stack
    memory, query_pos, pos = (copy_to_model(t, decoder.shard) for t in (memory, query_pos, pos))

    def fn(layer, x, layer_seeds, save_names):
        return decoder_layer(
            layer, x, memory, query_pos, pos, num_head=num_head,
            activation=activation, normalize_before=normalize_before,
            causal=causal, tgt_key_padding_mask=tgt_key_padding_mask,
            memory_key_padding_mask=memory_key_padding_mask,
            dropout_rate=dropout_rate, seeds=layer_seeds, impl=impl, save_names=save_names)

    tgt = _run_stack(fn, decoder.layers, tgt, seeds, remat, remat_policy)
    return layer_norm(decoder.norm, tgt)
