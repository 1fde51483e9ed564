"""PyTorch port: ``train_step`` against the JAX package (CPU, fp32, tiny
dims): three Adam steps against ``optax.adam``, the NaN-loss skip, and the
per-epoch learning-rate schedule."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faceformer_tpu.models.parallel import SurfaceFormerParallel as JaxParallel
from faceformer_tpu.train.loss import pointer_cross_entropy as jax_pointer_cross_entropy
from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.params import params_to_numpy
from faceformer_tpu_torch.train.step import lr_for_epoch, make_optimizer, train_step

from torch_port_helpers import (  # noqa: F401
    fixture_batch,
    jax_params,
    leaves,
    port_model,
    torch_batch,
    torch_fp32_single_thread,
)


@pytest.fixture(scope="module")
def batch(tiny_model_cfg):
    return fixture_batch(tiny_model_cfg)


def train_cfg(tiny_model_cfg, **trainer):
    from faceformer_tpu.config import config_to_dict

    return config_from_dict({"model": config_to_dict(tiny_model_cfg),
                             "trainer": {"precision": "fp32", **trainer}})


def test_three_adam_steps_match_optax(tiny_model_cfg, batch):
    lr = 1e-4  # parameters move ~3e-4, thirty times the tolerance
    tree = jax_params(tiny_model_cfg, seed=7)
    params = jax.tree.map(jnp.asarray, tree)
    opt = optax.adam(lr)
    state = opt.init(params)

    def loss_fn(p):
        out = JaxParallel.forward_train(p, tiny_model_cfg, batch)
        return jax_pointer_cross_entropy(out, tiny_model_cfg.token)[0]

    losses_j, smallest = [], None
    for _ in range(3):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        size = jax.tree.map(lambda g: np.abs(np.asarray(g)), grads)
        smallest = size if smallest is None else jax.tree.map(np.minimum, smallest, size)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss))

    cfg = train_cfg(tiny_model_cfg, lr=lr)
    model = port_model(tiny_model_cfg, tree)
    optimizer = make_optimizer(model, cfg.trainer)
    tb = torch_batch(batch)
    losses = [float(train_step(model, optimizer, tb, None, cfg)[0]) for _ in range(3)]
    np.testing.assert_allclose(losses, losses_j, atol=1e-5)
    assert losses[2] < losses[0]
    ours = dict(leaves(params_to_numpy(model)))
    noise = dict(leaves(smallest))
    checked = 0
    for name, want in leaves(jax.tree.map(np.asarray, params)):
        # Adam's update is m / (sqrt(v) + 1e-8), a ratio of gradients. The
        # two frameworks' gradients differ by up to ~4e-7 absolute (summation
        # order), so where a gradient is that small (every key bias, which
        # the softmax ignores; a dead ReLU unit) the update's direction is
        # noise, up to ~3 lr a step. Entries whose gradient stays above 1e-4
        # in all three steps are held to 1e-5, every entry to 10 lr.
        clear = noise[name] > 1e-4
        checked += int(clear.sum())
        np.testing.assert_allclose(ours[name][clear], want[clear], atol=1e-5, err_msg=name)
        np.testing.assert_allclose(ours[name], want, atol=10 * lr, err_msg=name)
    assert checked > 0.5 * sum(w.size for w in ours.values())


def test_nonfinite_loss_leaves_parameters_and_adam_state_unchanged(tiny_model_cfg, batch):
    cfg = train_cfg(tiny_model_cfg, lr=1e-3)
    model = port_model(tiny_model_cfg, jax_params(tiny_model_cfg, seed=8))
    optimizer = make_optimizer(model, cfg.trainer)
    tb = torch_batch(batch)
    train_step(model, optimizer, tb, None, cfg)  # moments and step count exist now
    params = copy.deepcopy(model.state_dict())
    state = copy.deepcopy(optimizer.state_dict())
    bad = dict(tb)
    bad["input"] = tb["input"].clone()
    bad["input"][0, 0, 0, 0] = float("nan")
    loss, _ = train_step(model, optimizer, bad, None, cfg)
    assert not bool(torch.isfinite(loss))
    for name, value in model.state_dict().items():
        assert torch.equal(value, params[name]), name
    after = optimizer.state_dict()
    assert after["state"].keys() == state["state"].keys()
    for idx, slot in state["state"].items():
        for key, value in slot.items():
            assert torch.equal(after["state"][idx][key], value), (idx, key)
    loss, _ = train_step(model, optimizer, tb, None, cfg)  # and training goes on
    assert bool(torch.isfinite(loss))
    assert not torch.equal(model.project.weight, params["project.weight"])


def test_lr_schedule_matches_jax_harness(tiny_model_cfg):
    from faceformer_tpu.config import Config, TrainerConfig
    from faceformer_tpu.train.trainer import Harness

    harness = Harness(Config(model=tiny_model_cfg, trainer=TrainerConfig(lr=3e-4, lr_step=5)))
    harness.optimizer  # builds the schedule
    cfg = train_cfg(tiny_model_cfg, lr=3e-4, lr_step=5)
    for epoch in (0, 4, 5, 9, 10, 23):
        assert lr_for_epoch(cfg.trainer, epoch) == harness._epoch_schedule(epoch)
    flat = train_cfg(tiny_model_cfg, lr=3e-4)
    assert lr_for_epoch(flat.trainer, 50) == 3e-4
    model = port_model(tiny_model_cfg, jax_params(tiny_model_cfg, seed=8))
    optimizer = make_optimizer(model, cfg.trainer)
    group = optimizer.param_groups[0]
    assert group["lr"] == 3e-4
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 0.0)
