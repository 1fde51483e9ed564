"""Shared model core: encoder pass and pointer scoring (PyTorch counterpart
of faceformer_tpu/models/common.py)."""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F

import torch

from faceformer_tpu_torch.config import ModelConfig
from faceformer_tpu_torch.models import layers as L
from faceformer_tpu_torch.models.embedding import position_embedding, vanilla_embedding
from faceformer_tpu_torch.ops.pointer import pointer_argmax


def compute_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision in ("bf16", "16", 16) else torch.float32


def pad_input_mask(input_mask: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """Prepend ``num_tokens`` unmasked slots for the special-token rows
    (reference: model.py:61-66 process_masks)."""
    pad = torch.zeros((*input_mask.shape[:-1], num_tokens), dtype=input_mask.dtype,
                      device=input_mask.device)
    return torch.cat([pad, input_mask], dim=-1)


def encode(
    model,
    cfg: ModelConfig,
    inputs: torch.Tensor,
    input_mask: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    seeds=None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Embed + encode. ``seeds`` ((layers, ENCODER_SITES) ints) switches
    dropout on; None is eval. Returns (memory (N, 4+L, E), pos (1, 4+L, E),
    padded key mask (N, 4+L))."""
    x = vanilla_embedding(model.embed, inputs.to(dtype))
    pos = position_embedding(model.pos_table, x.shape[1], dtype)
    padded_mask = pad_input_mask(input_mask, cfg.token.length)
    memory = L.encoder_forward(
        model.encoder, x, pos, padded_mask, num_head=cfg.num_head,
        activation=cfg.activation, normalize_before=cfg.normalize_before,
        dropout_rate=cfg.dropout, seeds=seeds, remat=cfg.remat,
        remat_policy=cfg.remat_policy, impl=impl)
    return memory, pos, padded_mask


def pad_target_time(
    target: torch.Tensor, tgt_key_padding: torch.Tensor, t: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pad the face-token (time) axis to a multiple of 8 once before the
    decoder stack, as the JAX function does (common.py:86-101). Padded
    positions carry PAD tokens and a True key-padding mask and sit after
    every real position, so causal attention leaves the real outputs
    unchanged; callers slice the pointer output back to t. The port keeps
    the pad so that its activations compare row for row with JAX's."""
    t_pad = -(-t // 8) * 8
    if t_pad == t:
        return target, tgt_key_padding, t_pad
    return (F.pad(target, (0, t_pad - t)),
            F.pad(tgt_key_padding, (0, t_pad - t), value=True), t_pad)


def padded_query_pos(table: torch.Tensor, t: int, t_pad: int, dtype) -> torch.Tensor:
    """First t learned query positions, zero-padded to t_pad rows."""
    qp = table[:t].to(dtype)
    if t_pad != t:
        qp = F.pad(qp, (0, 0, 0, t_pad - t))
    return qp


def gather_memory_rows(memory: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Decoder inputs are rows of encoder memory at token indices — the
    pointer-network trick (reference: model.py:147, model_para.py:155).

    memory: (N, S, E); token_ids: (N, ...) integer grid -> (N, ..., E)."""
    flat = token_ids.reshape(token_ids.shape[0], -1).long()  # (N, R)
    rows = torch.gather(memory, 1, flat[..., None].expand(-1, -1, memory.shape[-1]))
    return rows.reshape(*token_ids.shape, memory.shape[-1])


def pointer_logits(memory: torch.Tensor, pointer: torch.Tensor) -> torch.Tensor:
    """Pointer scores against every memory row, fp32 (reference:
    trainer.py:65). memory (N, S, E), pointer (N, ..., E) -> (N, S, ...)."""
    flat = pointer.reshape(pointer.shape[0], -1, pointer.shape[-1])
    logits = torch.einsum("nse,nre->nsr", memory.float(), flat.float())
    return logits.reshape(memory.shape[0], memory.shape[1], *pointer.shape[1:-1])


def masked_argmax(
    memory: torch.Tensor, pointer_vec: torch.Tensor, padded_mask: torch.Tensor
) -> torch.Tensor:
    """Greedy next-token pick (reference: model.py:161-167 select_next)
    through the pointer-argmax kernel: fp32 logits against memory rows,
    padded rows at the float32 minimum, first index on ties.
    memory (N, S, E), pointer_vec (N, ..., E), padded_mask (N, S) -> (N, ...)
    int32."""
    rows = pointer_vec.reshape(pointer_vec.shape[0], -1, pointer_vec.shape[-1])
    out = pointer_argmax(rows.contiguous(), memory.contiguous(), padded_mask.contiguous())
    return out.reshape(pointer_vec.shape[:-1])

