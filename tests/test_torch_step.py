"""PyTorch port: ``train_step`` against the JAX package (CPU, fp32, tiny
dims): three Adam steps against ``optax.adam``, the NaN-loss skip (alone,
and between two good steps against the JAX step's on-device skip), and the
per-epoch learning-rate schedule."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faceformer_tpu.config import Config, TrainerConfig, config_to_dict
from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.dataset import ABCDatasetParallel as JaxDataset
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu.models.parallel import SurfaceFormerParallel as JaxParallel
from faceformer_tpu.parallel.mesh import shard_batch as jax_shard_batch
from faceformer_tpu.train.loss import pointer_cross_entropy as jax_pointer_cross_entropy
from faceformer_tpu.train.trainer import Harness as JaxHarness
from faceformer_tpu.train.trainer import _device_batch
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


LR = 1e-3


def poisoned(item):
    """A packed sample with a NaN in its first input coordinate."""
    bad = dict(item, input=np.array(item["input"], copy=True))
    bad["input"].flat[0] = np.nan
    return bad


def moment_tree(model, optimizer, key):
    """Adam's ``key`` state of every parameter in the JAX parameter layout."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p_clone, p in zip(clone.parameters(), model.parameters()):
            p_clone.copy_(optimizer.state[p][key])
    return dict(leaves(params_to_numpy(clone)))


def step_counts(optimizer):
    return {float(slot["step"]) for slot in optimizer.state.values()}


@pytest.fixture(scope="module")
def batch(tiny_model_cfg):
    return fixture_batch(tiny_model_cfg)


def train_cfg(tiny_model_cfg, **trainer):
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


def test_nan_batch_between_good_ones_is_skipped_as_jax_skips_it(tiny_model_cfg):
    """A good batch, a NaN one, a good one, through the JAX harness's
    compiled step (its on-device ``jnp.where`` skip) and ``train_step`` (the
    fused Adam's ``found_inf``) from the same parameters: losses, parameters,
    Adam's moments and step count after each step; the NaN step leaves the
    port's state as it was, bit for bit."""
    rng = np.random.default_rng(31)
    ds = JaxDataset.from_samples([random_sample(rng) for _ in range(4)], tiny_model_cfg)
    good_a, good_b = collate([ds[0], ds[1]]), collate([ds[2], ds[3]])
    bad = collate([poisoned(ds[0]), ds[1]])

    cfg = Config(model_class="SurfaceFormer_Parallel", model=tiny_model_cfg,
                 trainer=TrainerConfig(lr=LR, precision="fp32", num_devices=1))
    jh = JaxHarness(cfg)
    step_fn = jh.train_step()
    tree = jax_params(tiny_model_cfg, seed=5)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = jh.optimizer.init(params)
    key = jax.random.key(0)

    pcfg = config_from_dict(config_to_dict(cfg))
    model = port_model(tiny_model_cfg, tree)
    optimizer = make_optimizer(model, pcfg.trainer)

    for i, batch in enumerate((good_a, bad, good_b)):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        moments = {k: moment_tree(model, optimizer, k) for k in ("exp_avg", "exp_avg_sq")
                   } if optimizer.state else None
        params, opt_state, loss_j, _ = step_fn(
            params, opt_state, jax_shard_batch(_device_batch(batch), jh.mesh), key)
        loss, _ = train_step(model, optimizer, torch_batch(batch), None, pcfg)
        assert np.isfinite(float(loss)) == np.isfinite(float(loss_j)) == (i != 1)
        if i != 1:
            np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5)
        adam = opt_state[0]
        # the step count: 1, kept at 1 by the skip, then 2, in both
        assert step_counts(optimizer) == {float(adam.count)} == {1.0 if i < 2 else 2.0}
        if i == 1:  # the skip leaves everything as it was, bit for bit
            for k, v in model.state_dict().items():
                assert torch.equal(v, before[k]), k
            for k in ("exp_avg", "exp_avg_sq"):
                now = moment_tree(model, optimizer, k)
                for name, value in moments[k].items():
                    np.testing.assert_array_equal(now[name], value, err_msg=(k, name))
        # the two frameworks' gradients differ by summation order (~4e-7),
        # and Adam's normalised update turns that into up to ~lr where a
        # gradient is as small: parameters within 10 lr, as above
        ours = dict(leaves(params_to_numpy(model)))
        for name, want in leaves(jax.tree.map(np.asarray, params)):
            np.testing.assert_allclose(ours[name], want, atol=10 * LR, err_msg=name)
        # the moments: a tenth of the gradient, and a thousandth of its square
        for k, want_tree, atol in (("exp_avg", adam.mu, 1e-6), ("exp_avg_sq", adam.nu, 1e-9)):
            got = moment_tree(model, optimizer, k)
            for name, want in leaves(jax.tree.map(np.asarray, want_tree)):
                np.testing.assert_allclose(got[name], want, rtol=1e-3, atol=atol,
                                           err_msg=(k, name))


def test_lr_schedule_matches_jax_harness(tiny_model_cfg):
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
