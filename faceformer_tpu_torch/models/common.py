"""Shared model core: the parameters, the encoder pass and pointer scoring
(PyTorch counterpart of faceformer_tpu/models/common.py). Both SurfaceFormer
variants use it."""

from __future__ import annotations

from typing import Optional, Tuple

import torch.nn.functional as F

import torch
from torch import nn

from faceformer_tpu_torch.config import ModelConfig
from faceformer_tpu_torch.device import require_device
from faceformer_tpu_torch.models import layers as L
from faceformer_tpu_torch.models.embedding import (
    VanillaEmbedding,
    position_embedding,
    vanilla_embedding,
)
from faceformer_tpu_torch.ops.pointer import pointer_argmax
from faceformer_tpu_torch.parallel.tensor import Shard, copy_to_model, gather_from_model
from faceformer_tpu_torch.params import init_parameters_


class PointerNetwork(nn.Module):
    """The parameters both SurfaceFormer variants share (the JAX
    ``init_params`` tree, common.py:31-55): embedding, position tables,
    encoder and decoder stacks, pointer projection. ``query_pos_len`` is
    label_seq_length for the flat model and max_face_length for the parallel
    one (reference: model.py:31-32, model_para.py:31-33).

    Parameters are float32 and follow the JAX tree (``params.params_from_jax``
    loads one); they are initialised from ``generator`` (xavier-uniform
    matrices and tables, torch-default linear biases, zero attention biases)
    on the CPU and then moved to ``device``, so a seed gives the same weights
    on every device. The module's ``train()`` / ``eval()`` mode switches
    nothing: dropout is on exactly when ``forward_train`` is given a
    ``generator``, as ``rng`` switches it in the JAX package.

    ``shard``: the rank's place on the model axis once
    ``parallel.tensor.shard_params_`` has cut the model (None: whole)."""

    shard: Optional[Shard] = None

    def __init__(self, cfg: ModelConfig, query_pos_len: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        dev = require_device(device)
        self.cfg = cfg
        dim, ffn = cfg.num_model, cfg.num_feedforward
        self.embed = VanillaEmbedding(cfg.num_points_per_line * cfg.point_dim, dim,
                                      cfg.token.length)
        self.pos_table = nn.Parameter(torch.empty(cfg.num_lines + cfg.token.length, dim))
        self.query_pos_table = nn.Parameter(torch.empty(query_pos_len, dim))
        self.encoder = L.Stack([L.EncoderLayer(dim, ffn)
                                for _ in range(cfg.num_encoder_layers)], dim)
        self.decoder = L.Stack([L.DecoderLayer(dim, ffn)
                                for _ in range(cfg.num_decoder_layers)], dim)
        self.project = nn.Linear(dim, dim)
        init_parameters_(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        self.to(dev)


def draw_dropout_seeds(generator: Optional[torch.Generator], cfg: ModelConfig):
    """The step's randomness, split three ways as the JAX forward splits its
    rng: one row of dropout seeds per encoder layer, one per decoder layer,
    and the scheduled-sampling seed. All None without a generator (no
    dropout, no sampling)."""
    if generator is None:
        return None, None, None
    n_enc = cfg.num_encoder_layers * L.ENCODER_SITES
    n_dec = cfg.num_decoder_layers * L.DECODER_SITES
    drawn = L.draw_seeds(generator, n_enc + n_dec + 1)
    enc = [drawn[i:i + L.ENCODER_SITES] for i in range(0, n_enc, L.ENCODER_SITES)]
    dec = [drawn[i:i + L.DECODER_SITES] for i in range(n_enc, n_enc + n_dec, L.DECODER_SITES)]
    return enc, dec, drawn[-1]


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


def project_pointer(model, out: torch.Tensor) -> torch.Tensor:
    """The pointer vectors of decoder outputs: ``project``, column-parallel
    under tensor parallelism and gathered over the model ranks, so the
    logits, the loss and the argmax see the whole vector on every rank."""
    shard = model.shard
    return gather_from_model(L.linear(model.project, copy_to_model(out, shard)), shard)


def pointer_logits(memory: torch.Tensor, pointer: torch.Tensor) -> torch.Tensor:
    """Pointer scores against every memory row, fp32 (reference:
    trainer.py:65). memory (N, S, E), pointer (N, ..., E) -> (N, S, ...)."""
    flat = pointer.reshape(pointer.shape[0], -1, pointer.shape[-1])
    logits = torch.einsum("nse,nre->nsr", memory.float(), flat.float())
    return logits.reshape(memory.shape[0], memory.shape[1], *pointer.shape[1:-1])


def masked_argmax(
    memory: torch.Tensor, pointer_vec: torch.Tensor, padded_mask: torch.Tensor,
    impl: str = "auto",
) -> torch.Tensor:
    """Greedy next-token pick (reference: model.py:161-167 select_next)
    through the pointer-argmax kernel: fp32 logits against memory rows,
    padded rows at the float32 minimum, first index on ties.
    memory (N, S, E), pointer_vec (N, ..., E), padded_mask (N, S) -> (N, ...)
    int32. ``impl="plain"`` runs the kernel's plain version."""
    rows = pointer_vec.reshape(pointer_vec.shape[0], -1, pointer_vec.shape[-1])
    out = pointer_argmax(rows.contiguous(), memory.contiguous(), padded_mask.contiguous(),
                         impl=impl)
    return out.reshape(pointer_vec.shape[:-1])

