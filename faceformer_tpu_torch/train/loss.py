"""Pointer cross-entropy loss + token accuracy (PyTorch counterpart of
faceformer_tpu/train/loss.py).

Contract (reference: faceformer/trainer.py:60-80 compute_loss):
  - logits = embedding @ pointer^T over every memory row (the class axis is
    the 4+L memory positions; NO padding mask is applied to the logits);
  - cross-entropy ignoring PAD labels, summed then divided by the number of
    non-PAD labels;
  - token accuracy over non-PAD positions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from faceformer_tpu_torch.config import TokenConfig


def pointer_cross_entropy(
    outputs: Dict[str, torch.Tensor], token: TokenConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Compute (loss, aux) from a forward_train output dict.

    outputs: embedding (N, S, E), pointer (N, ..., E), label (N, ...);
    trailing axes are flattened. The operands keep their compute dtype's
    values and the logits accumulate in fp32 (a bf16 x bf16 product is exact
    in fp32, so up-casting the operands gives the JAX einsum's numbers). The
    picked logit is a gather here: the JAX one-hot select works around a
    slow TPU scatter and computes the same number.
    """
    memory = outputs["embedding"]
    pointer = outputs["pointer"]
    labels = outputs["label"].long()

    n = memory.shape[0]
    pointer2 = pointer.reshape(n, -1, pointer.shape[-1])  # (N, R, E)
    labels2 = labels.reshape(n, -1)  # (N, R)

    logits = torch.einsum("nre,nse->nrs", pointer2.float(), memory.float())  # (N, R, S)

    valid = labels2 != token.PAD
    picked = torch.gather(logits, -1, labels2[..., None])[..., 0]
    logz = torch.logsumexp(logits, dim=-1)
    valid_sum = valid.sum()
    loss = ((logz - picked) * valid).sum() / valid_sum

    pred = logits.argmax(dim=-1)
    acc_sum = (valid & (pred == labels2)).sum()
    cls_acc = acc_sum / (valid_sum + 1e-10)

    aux = {
        "cls_acc": cls_acc,
        "valid_tokens": valid_sum,
        "predict_tokens": pred.reshape(labels.shape),
    }
    return loss, aux
