"""One training step (PyTorch counterpart of the step that
faceformer_tpu/train/trainer.py:129-155 compiles): teacher-forced forward,
pointer cross-entropy, backward, Adam, and the NaN-loss skip. The harness
(``train/trainer.py``) runs it once a batch and sets each parameter group's
``lr`` from ``lr_for_epoch`` at the start of each epoch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from faceformer_tpu_torch.config import Config, TrainerConfig
from faceformer_tpu_torch.train.loss import pointer_cross_entropy


def make_optimizer(model: torch.nn.Module, trainer_cfg: TrainerConfig) -> torch.optim.Adam:
    """Adam at ``lr`` with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8
    added outside the square root, no weight decay)."""
    return torch.optim.Adam(model.parameters(), lr=trainer_cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)


def lr_for_epoch(trainer_cfg: TrainerConfig, epoch: int) -> float:
    """StepLR(gamma=0.1) stepped per epoch (trainer.py:114-118); constant
    when ``lr_step`` is 0."""
    if trainer_cfg.lr_step <= 0:
        return trainer_cfg.lr
    return trainer_cfg.lr * (0.1 ** (epoch // trainer_cfg.lr_step))


def train_step(model, optimizer: torch.optim.Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], cfg: Config, impl: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step on ``batch``; returns (loss, cls_acc) as 0-d tensors.

    A step whose loss is not finite is skipped (reference trainer.py:87-88):
    parameters and the optimizer's state, moments and step count, stay
    untouched. The JAX step selects old or new state on the device; here
    the check reads the loss on the host once per step, which waits for the
    step's device work to finish."""
    optimizer.zero_grad(set_to_none=True)
    out = model.forward_train(batch, generator=generator, precision=cfg.trainer.precision,
                              scheduled_sampling_ratio=cfg.trainer.scheduled_sampling,
                              impl=impl)
    loss, aux = pointer_cross_entropy(out, cfg.model.token)
    loss.backward()
    if bool(torch.isfinite(loss)):
        optimizer.step()
    return loss.detach(), aux["cls_acc"]
