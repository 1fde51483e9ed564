"""PyTorch port: the flat SurfaceFormer's training pass against the JAX
package (CPU, fp32, tiny dims, direction-token labels): forward_train
outputs, loss and every gradient, with the Pallas kernels interpreted and
on the XLA path, pre- and post-LN, and scheduled sampling at ratio 1.0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu import ops as jax_ops
from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.dataset import ABCDataset as JaxDataset
from faceformer_tpu.models.surfaceformer import SurfaceFormer as JaxFlat
from faceformer_tpu.train.loss import pointer_cross_entropy as jax_pointer_cross_entropy
from faceformer_tpu_torch.params import grads_to_numpy
from faceformer_tpu_torch.train.loss import pointer_cross_entropy

from torch_flat_helpers import fitting_samples, flavor_cfg
from torch_port_helpers import (  # noqa: F401
    jax_params,
    leaves,
    port_model,
    torch_batch,
    torch_fp32_single_thread,
)


# -- training forward, loss and gradients ------------------------------------------


@pytest.fixture(scope="module")
def dir_batch(tiny_model_cfg):
    cfg = flavor_cfg(tiny_model_cfg, "direction", label_seq_length=64)
    samples = fitting_samples(cfg, 2, seed=3, flavor="direction")
    ds = JaxDataset.from_samples(samples, cfg)
    return cfg, collate([ds[0], ds[1]])


def jax_loss_and_grads(cfg, tree, batch, kernels, rng=None, ss=0.0):
    params = jax.tree.map(jnp.asarray, tree)

    def loss_fn(p):
        out = JaxFlat.forward_train(p, cfg, batch, rng=rng, scheduled_sampling_ratio=ss)
        loss, aux = jax_pointer_cross_entropy(out, cfg.token)
        return loss, {**aux, "outputs": out}

    try:
        jax_ops.enable(kernels)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    finally:
        jax_ops.enable(None)
    return float(loss), aux, jax.tree.map(np.asarray, grads)


def port_loss_and_grads(model, batch, generator=None, ss=0.0):
    model.zero_grad(set_to_none=True)
    out = model.forward_train(torch_batch(batch), generator=generator,
                              scheduled_sampling_ratio=ss)
    loss, aux = pointer_cross_entropy(out, model.cfg.token)
    loss.backward()
    return loss.detach(), aux, grads_to_numpy(model)


@pytest.mark.parametrize("kernels,normalize_before",
                         [(True, True), (False, True), (False, False)],
                         ids=["pallas-interpret", "xla", "xla-post-ln"])
def test_flat_forward_train_loss_and_grads_match_jax(dir_batch, kernels, normalize_before):
    cfg, batch = dir_batch
    cfg = dataclasses.replace(cfg, normalize_before=normalize_before)
    tree = jax_params(cfg, seed=3, flat=True)
    model = port_model(cfg, tree, flat=True)
    loss_j, aux_j, grads_j = jax_loss_and_grads(cfg, tree, batch, kernels)
    with torch.no_grad():
        ours = model.forward_train(torch_batch(batch))
    theirs = aux_j["outputs"]
    assert ours["pointer"].shape == (2, cfg.label_seq_length - 1, cfg.num_model)
    np.testing.assert_array_equal(ours["label"].numpy(), np.asarray(theirs["label"]))
    for key in ("embedding", "pointer"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    loss, aux, grads = port_loss_and_grads(model, batch)
    assert abs(float(loss) - loss_j) < 1e-5
    assert abs(float(aux["cls_acc"]) - float(aux_j["cls_acc"])) < 1e-5
    assert int(aux["valid_tokens"]) == int(aux_j["valid_tokens"])
    np.testing.assert_array_equal(aux["predict_tokens"].numpy(),
                                  np.asarray(aux_j["predict_tokens"]))
    theirs, ours = dict(leaves(grads_j)), dict(leaves(grads))
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        np.testing.assert_allclose(ours[name], g, atol=5e-4, err_msg=f"grad mismatch at {name}")
    assert max(float(np.abs(g).max()) for g in ours.values()) > 1e-2


def test_flat_scheduled_sampling_matches_jax(dir_batch):
    """At ratio 1.0 every position is sampled and the dropout rate is 0, so
    no random draw decides anything."""
    cfg, batch = dir_batch
    tree = jax_params(cfg, seed=5, flat=True)
    loss_j, _, grads_j = jax_loss_and_grads(cfg, tree, batch, False,
                                            rng=jax.random.PRNGKey(0), ss=1.0)
    model = port_model(cfg, tree, flat=True)
    loss, _, grads = port_loss_and_grads(model, batch, torch.Generator().manual_seed(0), ss=1.0)
    assert abs(float(loss) - loss_j) < 1e-5
    ours = dict(leaves(grads))
    for name, g in leaves(grads_j):
        np.testing.assert_allclose(ours[name], g, atol=5e-4, err_msg=name)
    teacher, _, _ = port_loss_and_grads(model, batch)
    assert abs(float(loss) - float(teacher)) > 1e-4  # sampling changed the inputs
