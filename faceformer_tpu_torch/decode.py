"""Greedy decode engines (PyTorch counterpart of faceformer_tpu/decode.py;
reference: model.py:169-219, model_para.py:181-241).

Anchor-parallel model (``greedy_decode_parallel``), three engines, each
mirroring its JAX twin as written:

  - "reference": re-runs the decoder over a prefix buffer every step with a
    prefix key-padding mask and NO causal mask (the reference eval), on
    prefix buckets so early steps run on short buffers. Whole-batch stop
    when every next token is a special/type token (< token.length).
  - "causal_cache": incremental decode with per-layer self-attention caches
    and cross K/V precomputed once from memory.
  - "fused": causal_cache semantics, one ``ops.decode_step`` call per step
    (all layers, pointer argmax and next-input gather).

Retirement (causal_cache, fused, retire_rows=True): a row finishes on a
face-TYPE token (face_type_offset <= tok < token.length); PAD never retires
a row; retired rows write PAD. Grids are then a pure function of each row's
prefix and do not depend on when the loop stops, so the stop check — a host
sync in eager PyTorch — runs every ``STOP_CHECK_EVERY`` steps. The
reference engine's whole-batch stop and the legacy stop (retire_rows=False)
write raw tokens, so their grids depend on the stop step: they check every
step.

Anchor quirk (replicated): anchor_mode="reference" seeds anchor row j with
memory row j, WITHOUT the +4 token offset (model_para.py:201); rows at or
past the sample's edge count start at the Other-type token.

Tensor parallelism (parallel/tensor.py): a model cut over the model axis
decodes the data rank's rows on every model rank of it. "reference" runs
the cut layers as they are; "causal_cache" keeps the self- and
cross-attention K/V of the rank's heads only, sums each ``o`` and ``lin2``
product over the model ranks and gathers the pointer before the argmax;
"fused" gathers the decoder's weights once a decode (JAX runs it under
``shard_map`` over the data axis with replicated weights,
__graft_entry__.py:159-176) and runs K4 on the whole rows, the same on
each model rank. The grids are the one-rank grids. The flat engines
below do the same as "reference" and "causal_cache".

Flat model (``greedy_decode_single``), the "reference" and "causal_cache"
engines (the JAX package has no fused engine for it). Its stops: with
retire_rows=True a row retires at its first EOS and writes PAD after it,
and the batch stops once every row has seen one (checked every
``STOP_CHECK_EVERY`` steps, since the grid does not depend on it); with
retire_rows=False the reference's count of EOS emissions, which stops when
it EQUALS the batch size (model.py:205-210), checked every step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from faceformer_tpu_torch.config import ModelConfig
from faceformer_tpu_torch.models import layers as L
from faceformer_tpu_torch.models.common import (
    compute_dtype,
    encode,
    gather_memory_rows,
    masked_argmax,
    project_pointer,
)
from faceformer_tpu_torch.ops.decode_step import decode_step, pack_decoder_weights
from faceformer_tpu_torch.parallel.tensor import gather_modules

NEG = float(np.finfo(np.float32).min)
#: steps between host-side all-done checks under per-row retirement
STOP_CHECK_EVERY = 4


def _prefix_buckets(t_max: int) -> List[int]:
    """Ascending prefix-buffer sizes for reference-mode decoding: powers of
    two below t_max, then t_max itself. Positions beyond the live prefix are
    key-masked, so every bucket computes the same tokens."""
    buckets = [b for b in (8, 16, 32, 64, 128, 256) if 2 < b < t_max]
    return buckets + [t_max]


def _stacked_linear(lins, x: torch.Tensor) -> torch.Tensor:
    """Apply one linear per layer to (N, S, E) -> (Lyr, N, S, E)."""
    w = torch.stack([lin.weight.t() for lin in lins]).to(x.dtype)
    b = torch.stack([lin.bias for lin in lins]).to(x.dtype)
    return torch.einsum("nse,leo->lnso", x, w) + b[:, None, None, :]


def _cross_kv(model, memory: torch.Tensor, pos: torch.Tensor, num_head: int):
    """Cross-attention K/V for every decoder layer at once: K projects
    (memory + pos), V projects raw memory. Returns (Lyr, N, S, H, hd) each,
    H the heads the weights hold (a tensor-parallel rank's own)."""
    layers = model.decoder.layers
    head_dim = memory.shape[-1] // num_head
    k = _stacked_linear([ly.cross_attn.k for ly in layers], memory + pos)
    v = _stacked_linear([ly.cross_attn.v for ly in layers], memory)
    return L.split_heads(k, head_dim), L.split_heads(v, head_dim)


def _attend(q, k, v, key_padding_mask):
    """One-query attention: q (..., 1, H, hd), k/v (..., S, H, hd).

    Anchor-broadcast K/V (q (N, F, 1, H, hd) vs k (N, 1, S, H, hd)) fold
    the anchor axis into the query axis (no per-anchor copy of K/V)."""
    head_dim = q.shape[-1]
    if (q.ndim == 5 and k.ndim == 5 and k.shape[1] == 1 and q.shape[1] > 1
            and q.shape[2] == 1):
        q2 = q[:, :, 0] * head_dim ** -0.5  # (N, F, H, hd)
        scores = torch.einsum("nfhd,nshd->nhfs", q2.float(), k[:, 0].float())
        if key_padding_mask is not None:
            pad = key_padding_mask.reshape(key_padding_mask.shape[0], 1, 1, -1)
            scores = scores.masked_fill(pad, NEG)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("nhfs,nshd->nfhd", probs, v[:, 0])[:, :, None]
    scores = torch.einsum("...qhd,...khd->...hqk", (q * head_dim ** -0.5).float(), k.float())
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[..., None, None, :], NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


def _incremental_decoder_step(model, cfg: ModelConfig, x, qpos_t, step: int,
                              self_k, self_v, cross_k, cross_v, mem_padding):
    """Run one token through all decoder layers (pre-LN), writing this
    step's K/V into the per-layer caches in place.

    x (..., 1, E); caches (..., T, H, hd) per layer; cross K/V
    (Lyr, ..., S, H, hd), H the heads the weights hold (a tensor-parallel
    rank's, whose ``o`` and ``lin2`` products are summed over the model
    ranks). Returns the decoder output (..., 1, E)."""
    head_dim = cfg.num_model // cfg.num_head
    t_max = self_k[0].shape[-3]
    self_padding = torch.arange(t_max, device=x.device) > step
    act = L.activation_fn(cfg.activation)
    for i, layer in enumerate(model.decoder.layers):
        t2 = L.layer_norm(layer.norm1, x)
        qk_in = t2 + qpos_t
        sa = layer.self_attn
        q = L.linear(sa.q, qk_in)
        k_t = L.linear(sa.k, qk_in)
        v_t = L.linear(sa.v, t2)
        q = L.split_heads(q, head_dim)
        self_k[i][..., step, :, :] = L.split_heads(k_t[..., 0, :], head_dim)
        self_v[i][..., step, :, :] = L.split_heads(v_t[..., 0, :], head_dim)
        attn = _attend(q, self_k[i], self_v[i], self_padding)
        x = x + L.row_linear(sa.o, attn.reshape(*attn.shape[:-2], -1), sa.shard)

        t2 = L.layer_norm(layer.norm2, x)
        ca = layer.cross_attn
        q2 = L.linear(ca.q, t2 + qpos_t)
        q2 = L.split_heads(q2, head_dim)
        attn = _attend(q2, cross_k[i], cross_v[i], mem_padding)
        x = x + L.row_linear(ca.o, attn.reshape(*attn.shape[:-2], -1), ca.shard)

        t2 = L.layer_norm(layer.norm3, x)
        ffn = layer.ffn
        x = x + L.row_linear(ffn.lin2, act(L.linear(ffn.lin1, t2)), ffn.shard)
    return L.layer_norm(model.decoder.norm, x)


def _retire(nxt, done, tok, retire_rows: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens to write, new done) for the causal_cache/fused engines."""
    if retire_rows:
        fin = (nxt >= tok.face_type_offset) & (nxt < tok.length)
        return torch.where(done, torch.full_like(nxt, tok.PAD), nxt), done | fin
    return nxt, nxt < tok.length  # legacy whole-batch stop


def _stop_now(step: int, done, early_stop: bool, retire_rows: bool) -> bool:
    every = STOP_CHECK_EVERY if retire_rows else 1
    return early_stop and step % every == 0 and bool(done.all())


def _fused_decode_parallel(model, cfg: ModelConfig, memory, pos, padded_mask, tokens0,
                           anchors, dtype, early_stop: bool, retire_rows: bool):
    """causal_cache semantics, one fused decode-step call per step. A cut
    model's decoder weights are gathered first (collective over the model
    group)."""
    tok = cfg.token
    n, s, e = memory.shape
    f = cfg.num_lines
    t_max = cfg.max_face_length
    whole = model if model.shard is None else gather_modules(model, ("decoder.", "project."))
    cross_k, cross_v = _cross_kv(whole, memory, pos, cfg.num_head)
    cross_k = cross_k.reshape(-1, n, s, e).contiguous()
    cross_v = cross_v.reshape(-1, n, s, e).contiguous()
    packed = pack_decoder_weights(whole, dtype)
    cache = torch.zeros((cfg.num_decoder_layers, 2, n * f, t_max, e), dtype=dtype,
                        device=memory.device)
    mem_bias = torch.where(padded_mask, NEG, 0.0).to(torch.float32)
    query_pos = model.query_pos_table.to(dtype)
    x = gather_memory_rows(memory, anchors).reshape(n * f, e)
    tokens = tokens0.clone()
    done = torch.zeros((n, f), dtype=torch.bool, device=memory.device)
    for step in range(t_max - 1):
        if _stop_now(step, done, early_stop, retire_rows):
            break
        x, nxt = decode_step(step, x, query_pos[step].contiguous(), packed, cross_k, cross_v,
                             memory, mem_bias, cache, num_head=cfg.num_head)
        out_tok, done = _retire(nxt, done, tok, retire_rows)
        tokens[:, :, step + 1] = out_tok
    return {"predict": tokens}


def greedy_decode_parallel(
    model,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    precision: str = "fp32",
    mode: str = "reference",
    early_stop: bool = True,
    anchor_mode: str = "reference",
    retire_rows: bool = True,
) -> Dict[str, torch.Tensor]:
    """Anchor-parallel greedy decode. batch: input (N, L, P, D) float,
    input_mask (N, L) bool, num_input (N,) int, on the model's device.
    Returns predict (N, F, T) int32 with F = num_lines.

    early_stop=False decodes the full token budget; retire_rows=False
    restores the legacy whole-batch stop."""
    if mode not in ("reference", "causal_cache", "fused"):
        raise ValueError(f"unknown decode mode {mode!r}")
    if mode != "reference" and not cfg.normalize_before:
        mode = "reference"  # the incremental engines implement pre-LN only
    if mode == "fused" and cfg.activation != "relu":
        mode = "causal_cache"  # the fused step hard-codes ReLU
    dtype = compute_dtype(precision)
    tok = cfg.token
    with torch.no_grad():
        memory, pos, padded_mask = encode(model, cfg, batch["input"], batch["input_mask"], dtype)
        n, s, e = memory.shape
        f = cfg.num_lines
        t_max = cfg.max_face_length
        dev = memory.device
        query_pos = model.query_pos_table.to(dtype)

        num_input = batch["num_input"].to(device=dev, dtype=torch.int32)
        anchor_ids = torch.arange(f, dtype=torch.int32, device=dev)[None, :]
        offset = tok.length if anchor_mode == "aligned" else 0
        other_tok = 2 + tok.face_type_offset  # the bare Other-type token
        anchors = torch.where(anchor_ids < num_input[:, None], anchor_ids + offset,
                              torch.full_like(anchor_ids, other_tok))
        tokens = torch.full((n, f, t_max), tok.PAD, dtype=torch.int32, device=dev)
        tokens[:, :, 0] = anchors

        mem_b = memory[:, None]  # (N, 1, S, E): anchor-broadcast memory
        pos_b = pos[:, None]
        mem_pad_b = padded_mask[:, None]

        if mode == "reference":
            step = 0
            for bucket in _prefix_buckets(t_max):
                last = min(bucket - 2, t_max - 2)
                while step <= last:
                    tgt = gather_memory_rows(memory, tokens[:, :, :bucket])
                    prefix_pad = (torch.arange(bucket, device=dev) > step)[None, None, :]
                    out = L.decoder_forward(
                        model.decoder, tgt, mem_b, query_pos[None, None, :bucket], pos_b,
                        num_head=cfg.num_head, activation=cfg.activation,
                        normalize_before=cfg.normalize_before,
                        tgt_key_padding_mask=prefix_pad, memory_key_padding_mask=mem_pad_b)
                    pointer_t = project_pointer(model, out[:, :, step])  # (N, F, E)
                    nxt = masked_argmax(memory, pointer_t, padded_mask)
                    tokens[:, :, step + 1] = nxt
                    step += 1
                    if early_stop and bool((nxt < tok.length).all()):
                        return {"predict": tokens}
            return {"predict": tokens}

        if mode == "fused":
            return _fused_decode_parallel(model, cfg, memory, pos, padded_mask, tokens,
                                          anchors, dtype, early_stop, retire_rows)

        # causal_cache
        head_dim = cfg.num_model // cfg.num_head
        cross_k, cross_v = _cross_kv(model, memory, pos, cfg.num_head)
        cross_k, cross_v = cross_k[:, :, None], cross_v[:, :, None]  # (Lyr, N, 1, S, H, hd)
        heads = L.local_heads(model.decoder.layers[0].self_attn, head_dim)
        cache_shape = (n, f, t_max, heads, head_dim)
        sk = [torch.zeros(cache_shape, dtype=dtype, device=dev)
              for _ in range(cfg.num_decoder_layers)]
        sv = [torch.zeros(cache_shape, dtype=dtype, device=dev)
              for _ in range(cfg.num_decoder_layers)]
        done = torch.zeros((n, f), dtype=torch.bool, device=dev)
        for step in range(t_max - 1):
            if _stop_now(step, done, early_stop, retire_rows):
                break
            x = gather_memory_rows(memory, tokens[:, :, step:step + 1])  # (N, F, 1, E)
            out = _incremental_decoder_step(model, cfg, x, query_pos[step:step + 1], step,
                                            sk, sv, cross_k, cross_v, mem_pad_b)
            pointer_t = project_pointer(model, out[:, :, 0])  # (N, F, E)
            nxt = masked_argmax(memory, pointer_t, padded_mask)
            out_tok, done = _retire(nxt, done, tok, retire_rows)
            tokens[:, :, step + 1] = out_tok
        return {"predict": tokens}


def _single_stop(step: int, eos, n: int, early_stop: bool, retire_rows: bool) -> bool:
    """The flat engines' stop before ``step``: every row has seen an EOS
    (retire_rows), or the EOS count equals the batch size."""
    if not early_stop:
        return False
    if retire_rows:
        return step % STOP_CHECK_EVERY == 0 and bool(eos.all())
    return int(eos) == n


def _single_next(nxt, eos, tok, retire_rows: bool):
    """(tokens to write, new EOS state): retired rows write PAD; the
    reference ablation counts every EOS emitted (decode.py:258-273)."""
    if retire_rows:
        nxt = torch.where(eos, torch.full_like(nxt, tok.PAD), nxt)
        return nxt, eos | (nxt == tok.EOS)
    return nxt, eos + (nxt == tok.EOS).sum()


def greedy_decode_single(
    model,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    precision: str = "fp32",
    mode: str = "reference",
    early_stop: bool = True,
    retire_rows: bool = True,
    impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Flat-sequence greedy decode (reference: model.py:169-219;
    faceformer_tpu/decode.py:223-343). batch: input (N, L, P, D) float,
    input_mask (N, L) bool, on the model's device. Returns predict (N, T)
    int32 with T = label_seq_length: SOS, then one token a step.

    "reference" re-runs the decoder over a prefix buffer every step (prefix
    buckets, key-padded, no causal mask: the reference's bidirectional
    eval); "causal_cache" runs one token a step through per-layer caches. A
    post-LN config decodes through "reference" (the incremental engine is
    pre-LN only). early_stop=False decodes the full token budget;
    ``impl="plain"`` runs the kernels' plain versions, for comparisons."""
    if mode not in ("reference", "causal_cache"):
        raise ValueError(f"the flat model decodes with 'reference' or 'causal_cache', "
                         f"not {mode!r}")
    if mode != "reference" and not cfg.normalize_before:
        mode = "reference"  # the incremental engine implements pre-LN only
    dtype = compute_dtype(precision)
    tok = cfg.token
    with torch.no_grad():
        memory, pos, padded_mask = encode(model, cfg, batch["input"], batch["input_mask"], dtype,
                                          impl=impl)
        n = memory.shape[0]
        t_max = cfg.label_seq_length
        dev = memory.device
        query_pos = model.query_pos_table.to(dtype)
        tokens = torch.full((n, t_max), tok.PAD, dtype=torch.int32, device=dev)
        tokens[:, 0] = tok.SOS
        eos = (torch.zeros(n, dtype=torch.bool, device=dev) if retire_rows
               else torch.zeros((), dtype=torch.int64, device=dev))

        if mode == "reference":
            step = 0
            for bucket in _prefix_buckets(t_max):
                # steps s <= bucket - 2 fit this buffer (token s + 1 lands in it)
                last = min(bucket - 2, t_max - 2)
                while step <= last:
                    if _single_stop(step, eos, n, early_stop, retire_rows):
                        return {"predict": tokens}
                    tgt = gather_memory_rows(memory, tokens[:, :bucket])
                    prefix_pad = (torch.arange(bucket, device=dev) > step)[None, :]
                    out = L.decoder_forward(
                        model.decoder, tgt, memory, query_pos[None, :bucket], pos,
                        num_head=cfg.num_head, activation=cfg.activation,
                        normalize_before=cfg.normalize_before,
                        tgt_key_padding_mask=prefix_pad, memory_key_padding_mask=padded_mask,
                        impl=impl)
                    pointer_t = project_pointer(model, out[:, step])  # (N, E)
                    nxt = masked_argmax(memory, pointer_t, padded_mask, impl=impl)
                    nxt, eos = _single_next(nxt, eos, tok, retire_rows)
                    tokens[:, step + 1] = nxt
                    step += 1
            return {"predict": tokens}

        # causal_cache
        head_dim = cfg.num_model // cfg.num_head
        cross_k, cross_v = _cross_kv(model, memory, pos, cfg.num_head)  # (Lyr, N, S, H, hd)
        heads = L.local_heads(model.decoder.layers[0].self_attn, head_dim)
        cache_shape = (n, t_max, heads, head_dim)
        sk = [torch.zeros(cache_shape, dtype=dtype, device=dev)
              for _ in range(cfg.num_decoder_layers)]
        sv = [torch.zeros(cache_shape, dtype=dtype, device=dev)
              for _ in range(cfg.num_decoder_layers)]
        for step in range(t_max - 1):
            if _single_stop(step, eos, n, early_stop, retire_rows):
                break
            x = gather_memory_rows(memory, tokens[:, step:step + 1])  # (N, 1, E)
            out = _incremental_decoder_step(model, cfg, x, query_pos[step:step + 1], step,
                                            sk, sv, cross_k, cross_v, padded_mask)
            pointer_t = project_pointer(model, out[:, 0])  # (N, E)
            nxt = masked_argmax(memory, pointer_t, padded_mask, impl=impl)
            nxt, eos = _single_next(nxt, eos, tok, retire_rows)
            tokens[:, step + 1] = nxt
        return {"predict": tokens}
