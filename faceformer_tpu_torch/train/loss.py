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


def summed_cross_entropy(
    outputs: Dict[str, torch.Tensor], token: TokenConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The cross-entropy summed over the non-PAD labels, with aux: the
    counts of label tokens (``valid_tokens``) and of those predicted right
    (``correct_tokens``), and the predicted tokens. A training step divides
    the sum by the label tokens of the global batch (``train/step.py``).

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
    loss_sum = ((logz - picked) * valid).sum()

    pred = logits.argmax(dim=-1)
    aux = {
        "valid_tokens": valid.sum(),
        "correct_tokens": (valid & (pred == labels2)).sum(),
        "predict_tokens": pred.reshape(labels.shape),
    }
    return loss_sum, aux


def pointer_cross_entropy(
    outputs: Dict[str, torch.Tensor], token: TokenConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Compute (loss, aux) from a forward_train output dict: the token-mean
    cross-entropy of this batch, and ``summed_cross_entropy``'s aux with the
    token accuracy ``cls_acc``."""
    loss_sum, aux = summed_cross_entropy(outputs, token)
    aux["cls_acc"] = aux["correct_tokens"] / (aux["valid_tokens"] + 1e-10)
    return loss_sum / aux["valid_tokens"], aux
