"""SurfaceFormer_Parallel: per-edge-anchor simultaneous face decoding
(PyTorch counterpart of faceformer_tpu/models/parallel.py; reference:
faceformer/models/model_para.py).

Every edge index is the start token of its own face sequence and all
sequences decode at once. Memory stays (N, 4+L, E): the anchor axis is a
broadcast dim of cross-attention, never a repeat_interleave copy. F =
num_lines is static; rows past a sample's edges parse to empty faces.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from faceformer_tpu_torch.config import ModelConfig
from faceformer_tpu_torch.models import layers as L
from faceformer_tpu_torch.models.common import (
    PointerNetwork,
    compute_dtype,
    draw_dropout_seeds,
    encode,
    gather_memory_rows,
    pad_target_time,
    padded_query_pos,
    pointer_logits,
    project_pointer,
)


class SurfaceFormerParallel(PointerNetwork):
    """The anchor-parallel model; its ``query_pos_table`` has
    max_face_length rows. Parameters and their init: ``PointerNetwork``."""

    is_parallel = True

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(cfg, cfg.max_face_length, generator=generator, device=device)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None, precision: str = "fp32",
                      scheduled_sampling_ratio: float = 0.0, impl: str = "auto"
                      ) -> Dict[str, torch.Tensor]:
        """Teacher-forced pass over all anchor rows (reference:
        model_para.py:99-171; faceformer_tpu/models/parallel.py:47-112).

        batch: input (N, L, P, D), label (N, F, T), input_mask (N, L),
        label_mask (N, F, T) with F == num_lines. ``generator`` yields the
        dropout seeds (one per layer and site) and the scheduled-sampling
        draw; None runs without dropout and without sampling. Returns
        embedding (N, 4+L, E), pointer (N, F, T-1, E), label (N, F, T-1).
        ``impl="plain"`` runs the flash kernels' plain versions, for
        comparisons. A model cut over the model axis
        (parallel/tensor.py) runs the same pass on its rank's shards; its
        outputs are whole on every rank."""
        cfg = self.cfg
        dtype = compute_dtype(precision)
        label = batch["label"].to(torch.int32)
        enc_seeds, dec_seeds, ss_seed = draw_dropout_seeds(generator, cfg)

        memory, pos, padded_mask = encode(self, cfg, batch["input"], batch["input_mask"], dtype,
                                          seeds=enc_seeds, impl=impl)

        target, shifted_label = label[:, :, :-1], label[:, :, 1:]
        tgt_key_padding = batch["label_mask"][:, :, :-1]  # (N, F, T-1)
        t = target.shape[-1]
        target, tgt_key_padding, t_pad = pad_target_time(target, tgt_key_padding, t)
        query_pos = padded_query_pos(self.query_pos_table, t, t_pad, dtype)[None, None]

        # memory broadcasts across the anchor axis; it is never repeated
        mem_b, pos_b, mem_pad_b = memory[:, None], pos[:, None], padded_mask[:, None]

        def run_decoder(tokens, seeds):
            tgt = gather_memory_rows(memory, tokens)  # (N, F, T-1, E)
            out = L.decoder_forward(
                self.decoder, tgt, mem_b, query_pos, pos_b, num_head=cfg.num_head,
                activation=cfg.activation, normalize_before=cfg.normalize_before,
                causal=True, tgt_key_padding_mask=tgt_key_padding,
                memory_key_padding_mask=mem_pad_b, dropout_rate=cfg.dropout, seeds=seeds,
                remat=cfg.remat, remat_policy=cfg.remat_policy, impl=impl)
            return project_pointer(self, out)

        if scheduled_sampling_ratio > 0.0 and generator is not None:
            with torch.no_grad():
                pointer = run_decoder(target, None)
                logits = pointer_logits(memory, pointer)  # (N, S, F, T-1)
                logits = logits.masked_fill(padded_mask[:, :, None, None], L.NEG)
                sampled = logits.argmax(dim=1).to(torch.int32)
                sampled = torch.cat([target[..., :1], sampled[..., :-1]], dim=-1)
                gen = torch.Generator(device=target.device).manual_seed(ss_seed)
                use_sampled = (torch.rand(target.shape, generator=gen, device=target.device)
                               < scheduled_sampling_ratio)
                target = torch.where(use_sampled, sampled, target)

        pointer = run_decoder(target, dec_seeds)[:, :, :t]
        return {"embedding": memory, "pointer": pointer, "label": shifted_label}

    def forward_eval(self, batch: Dict[str, torch.Tensor], precision: str = "fp32",
                     mode: str = "reference", anchor_mode: str = "reference",
                     early_stop: bool = True, retire_rows: bool = True
                     ) -> Dict[str, torch.Tensor]:
        """Anchor-parallel greedy decode (reference: model_para.py:181-241).
        Returns predict (N, F, T) int32 token grids."""
        from faceformer_tpu_torch.decode import greedy_decode_parallel

        return greedy_decode_parallel(self, self.cfg, batch, precision=precision, mode=mode,
                                      early_stop=early_stop, anchor_mode=anchor_mode,
                                      retire_rows=retire_rows)
