"""One training step (PyTorch counterpart of the step that
faceformer_tpu/train/trainer.py:129-155 compiles): teacher-forced forward,
pointer cross-entropy, backward, Adam, and the NaN-loss skip, all queued on
the device without waiting for it. The harness
(``train/trainer.py``) runs it once a batch and sets each parameter group's
``lr`` from ``lr_for_epoch`` at the start of each epoch.

Over several ranks (``parallel/mesh.py``) the gradient is that of the
global batch's token mean, ``sum of losses / sum of label tokens`` over every
rank's rows, as JAX's loss over the sharded batch is
(faceformer_tpu/train/loss.py:55): the label-token count is all-reduced
before the backward, each rank's summed loss is divided by it, and the
gradients are summed over the ranks. (A mean of the ranks' own means, as
DDP's averaging gives, differs whenever the ranks hold different numbers of
label tokens.)

Under tensor parallelism (parallel/tensor.py) the reductions run over the
data axis: the model ranks of a data rank hold the same rows, the same
loss and, on every replicated parameter, the same gradient (the layers
sum what their heads and columns give; ``replicate_grads_`` makes the
copies equal bit for bit), so the bucket sums each shard and each
replicated leaf over the data ranks alike.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from faceformer_tpu_torch.config import Config, TrainerConfig
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.parallel.tensor import replicate_grads_
from faceformer_tpu_torch.train.loss import summed_cross_entropy


def make_optimizer(model: torch.nn.Module, trainer_cfg: TrainerConfig) -> torch.optim.Adam:
    """Adam at ``lr`` with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8
    added outside the square root, no weight decay). Fused: one kernel a
    device and dtype, which reads ``train_step``'s skip flag on the device
    (``found_inf``, which the foreach and single-tensor versions refuse)."""
    return torch.optim.Adam(model.parameters(), lr=trainer_cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0, fused=True)


def lr_for_epoch(trainer_cfg: TrainerConfig, epoch: int) -> float:
    """StepLR(gamma=0.1) stepped per epoch (trainer.py:114-118); constant
    when ``lr_step`` is 0."""
    if trainer_cfg.lr_step <= 0:
        return trainer_cfg.lr
    return trainer_cfg.lr * (0.1 ** (epoch // trainer_cfg.lr_step))


def train_step(model, optimizer: torch.optim.Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], cfg: Config, impl: str = "auto",
               world: Optional[mesh.World] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step on ``batch``, the rank's rows of the global batch under
    ``world`` (None: one rank); returns the global (loss, cls_acc) as 0-d
    tensors.

    Two all-reduces over the data axis, which do nothing at one data rank:
    the label-token count before the backward, then one bucket of every
    gradient with the rank's loss share and correct-token count after it;
    with a model axis, one broadcast of the replicated gradients over it.

    A step whose loss is not finite is skipped (reference trainer.py:87-88):
    parameters and the optimizer's state, moments and step count, stay
    untouched. As in the JAX step, which selects old or new state with
    ``jnp.where``, the decision stays on the device: the flag
    ``loss is not finite`` goes to the fused Adam as ``found_inf``, whose
    kernel then leaves parameters and moments as they are and whose step
    count is taken back by the flag. Nothing is read on the host, so the
    call returns once the step is queued, and the caller decides when to
    wait for its scalars. The flag comes from the global loss, so every rank
    steps or skips together."""
    optimizer.zero_grad(set_to_none=True)
    out = model.forward_train(batch, generator=generator, precision=cfg.trainer.precision,
                              scheduled_sampling_ratio=cfg.trainer.scheduled_sampling,
                              impl=impl)
    loss_sum, aux = summed_cross_entropy(out, cfg.model.token)
    count = aux["valid_tokens"].reshape(1).to(torch.float64)
    mesh.all_reduce_(world, [count])
    tokens = count[0].float()
    loss = loss_sum / tokens
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    shares = torch.stack([loss.detach(), aux["correct_tokens"].float()])
    mesh.all_reduce_(world, grads + [shares])
    replicate_grads_(model)
    optimizer.found_inf = (~torch.isfinite(shares[0])).float()
    optimizer.step()
    del optimizer.found_inf  # a later plain optimizer.step() steps
    return shares[0], shares[1] / (tokens + 1e-10)
