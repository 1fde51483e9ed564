"""SurfaceFormer: the flat single-sequence pointer network (PyTorch
counterpart of faceformer_tpu/models/surfaceformer.py; reference:
faceformer/models/model.py).

All faces of a wireframe decode as one token stream
[SOS, face1..., SEP, face2..., ..., EOS] whose tokens point at encoder
memory rows. With --direction_token data every edge pointer is followed by
a DIR0/DIR1 token, itself a pointer at a special-token row of memory.
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


class SurfaceFormer(PointerNetwork):
    """The flat model; its ``query_pos_table`` has label_seq_length rows.
    Parameters and their init: ``PointerNetwork``."""

    is_parallel = False

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(cfg, cfg.label_seq_length, generator=generator, device=device)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None, precision: str = "fp32",
                      scheduled_sampling_ratio: float = 0.0, impl: str = "auto"
                      ) -> Dict[str, torch.Tensor]:
        """Teacher-forced training pass (reference: model.py:98-159;
        faceformer_tpu/models/surfaceformer.py:42-104).

        batch: input (N, L, P, D), label (N, T), input_mask (N, L),
        label_mask (N, T). The T - 1 target positions are padded to a
        multiple of 8 and run under a causal mask with the targets' key
        padding. ``generator`` yields the dropout seeds and the
        scheduled-sampling draw; None runs without either. Returns
        embedding (N, 4+L, E), pointer (N, T-1, E), label (N, T-1), the
        shifted targets. ``impl="plain"`` runs the flash kernels' plain
        versions, for comparisons. A model cut over the model axis
        (parallel/tensor.py) runs the same pass on its rank's shards; its
        outputs are whole on every rank, and the model ranks of a data rank,
        given the data rank's ``generator``, draw the same scheduled-sampling
        mask over the same gathered pointer."""
        cfg = self.cfg
        dtype = compute_dtype(precision)
        label = batch["label"].to(torch.int32)
        enc_seeds, dec_seeds, ss_seed = draw_dropout_seeds(generator, cfg)

        memory, pos, padded_mask = encode(self, cfg, batch["input"], batch["input_mask"], dtype,
                                          seeds=enc_seeds, impl=impl)

        target, shifted_label = label[:, :-1], label[:, 1:]
        tgt_key_padding = batch["label_mask"][:, :-1]
        t = target.shape[1]
        target, tgt_key_padding, t_pad = pad_target_time(target, tgt_key_padding, t)
        query_pos = padded_query_pos(self.query_pos_table, t, t_pad, dtype)[None]

        def run_decoder(tokens, seeds):
            tgt = gather_memory_rows(memory, tokens)  # (N, T_pad, E)
            out = L.decoder_forward(
                self.decoder, tgt, memory, query_pos, pos, num_head=cfg.num_head,
                activation=cfg.activation, normalize_before=cfg.normalize_before,
                causal=True, tgt_key_padding_mask=tgt_key_padding,
                memory_key_padding_mask=padded_mask, dropout_rate=cfg.dropout, seeds=seeds,
                remat=cfg.remat, remat_policy=cfg.remat_policy, impl=impl)
            return project_pointer(self, out)

        if scheduled_sampling_ratio > 0.0 and generator is not None:
            # model predictions without gradient, mixed with the gold tokens
            # (reference: model.py:122-140, mix_gold_sampled model.py:87-96);
            # the pick is plain torch, as the JAX argmax is plain XLA
            with torch.no_grad():
                pointer = run_decoder(target, None)
                logits = pointer_logits(memory, pointer)  # (N, S, T_pad)
                logits = logits.masked_fill(padded_mask[:, :, None], L.NEG)
                sampled = logits.argmax(dim=1).to(torch.int32)
                # shifted right: position t sees the sample for t - 1
                sampled = torch.cat([target[:, :1], sampled[:, :-1]], dim=1)
                gen = torch.Generator(device=target.device).manual_seed(ss_seed)
                use_sampled = (torch.rand(target.shape, generator=gen, device=target.device)
                               < scheduled_sampling_ratio)
                target = torch.where(use_sampled, sampled, target)

        pointer = run_decoder(target, dec_seeds)[:, :t]
        return {"embedding": memory, "pointer": pointer, "label": shifted_label}

    def forward_eval(self, batch: Dict[str, torch.Tensor], precision: str = "fp32",
                     mode: str = "reference", early_stop: bool = True, retire_rows: bool = True,
                     impl: str = "auto") -> Dict[str, torch.Tensor]:
        """Greedy decode (reference: model.py:169-219) through the engine
        ``mode`` ("reference" or "causal_cache"). Returns predict (N, T)
        int32 token grids."""
        from faceformer_tpu_torch.decode import greedy_decode_single

        return greedy_decode_single(self, self.cfg, batch, precision=precision, mode=mode,
                                    early_stop=early_stop, retire_rows=retire_rows, impl=impl)
