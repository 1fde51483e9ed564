"""PyTorch port: the training forward and loss against the JAX package
(CPU, fp32, tiny dims): teacher-forced forward + pointer cross-entropy +
every parameter gradient, scheduled sampling, and remat with dropout. The
optimizer step is in tests/test_torch_step.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu import ops as jax_ops
from faceformer_tpu.data.packing import pack_label_parallel as jax_pack_label_parallel
from faceformer_tpu.models.parallel import SurfaceFormerParallel as JaxParallel
from faceformer_tpu.train.loss import pointer_cross_entropy as jax_pointer_cross_entropy
from faceformer_tpu_torch.data.packing import count_rotation_rows, pack_label_parallel
from faceformer_tpu_torch.models import layers as L
from faceformer_tpu_torch.models.common import pad_target_time, padded_query_pos
from faceformer_tpu_torch.params import grads_to_numpy
from faceformer_tpu_torch.train.loss import pointer_cross_entropy

from torch_port_helpers import (  # noqa: F401
    fixture_batch,
    jax_params,
    leaves,
    port_model,
    port_model_cfg,
    torch_batch,
    torch_fp32_single_thread,
)


@pytest.fixture(scope="module")
def batch(tiny_model_cfg):
    return fixture_batch(tiny_model_cfg)


def jax_loss_and_grads(cfg, tree, batch, kernels: bool, rng=None, ss=0.0):
    """JAX loss, aux and gradients, through the Pallas flash kernels in
    interpret mode (``kernels``) or the plain XLA path."""
    params = jax.tree.map(jnp.asarray, tree)

    def loss_fn(p):
        out = JaxParallel.forward_train(p, cfg, batch, rng=rng, scheduled_sampling_ratio=ss)
        return jax_pointer_cross_entropy(out, cfg.token)

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


@pytest.mark.parametrize("kernels", [True, False], ids=["pallas-interpret", "xla"])
@pytest.mark.parametrize("normalize_before", [True, False], ids=["pre-ln", "post-ln"])
def test_forward_train_loss_and_grads_match_jax(tiny_model_cfg, batch, normalize_before,
                                                kernels):
    cfg = dataclasses.replace(tiny_model_cfg, normalize_before=normalize_before)
    tree = jax_params(cfg, seed=3)
    loss_j, aux_j, grads_j = jax_loss_and_grads(cfg, tree, batch, kernels)
    loss, aux, grads = port_loss_and_grads(port_model(cfg, tree), batch)
    assert abs(float(loss) - loss_j) < 1e-5
    assert abs(float(aux["cls_acc"]) - float(aux_j["cls_acc"])) < 1e-5
    assert int(aux["valid_tokens"]) == int(aux_j["valid_tokens"])
    np.testing.assert_array_equal(aux["predict_tokens"].numpy(),
                                  np.asarray(aux_j["predict_tokens"]))
    theirs = dict(leaves(grads_j))
    ours = dict(leaves(grads))
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        np.testing.assert_allclose(ours[name], g, atol=5e-4, err_msg=f"grad mismatch at {name}")
    assert max(float(np.abs(g).max()) for g in ours.values()) > 1e-2  # not all-zero grads


def test_forward_train_outputs_match_jax(tiny_model_cfg, batch):
    tree = jax_params(tiny_model_cfg, seed=4)
    theirs = JaxParallel.forward_train(jax.tree.map(jnp.asarray, tree), tiny_model_cfg, batch)
    with torch.no_grad():
        ours = port_model(tiny_model_cfg, tree).forward_train(torch_batch(batch))
    assert sorted(ours) == ["embedding", "label", "pointer"]
    np.testing.assert_array_equal(ours["label"].numpy(), np.asarray(theirs["label"]))
    for key in ("embedding", "pointer"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), rtol=1e-5,
                                   atol=1e-5)


def test_scheduled_sampling_matches_jax(tiny_model_cfg, batch):
    """At ratio 1.0 every position is sampled, so no random draw decides
    anything and the two frameworks' different generators do not matter."""
    tree = jax_params(tiny_model_cfg, seed=5)
    loss_j, _, _ = jax_loss_and_grads(tiny_model_cfg, tree, batch, False,
                                      rng=jax.random.PRNGKey(0), ss=1.0)
    model = port_model(tiny_model_cfg, tree)
    loss, _, _ = port_loss_and_grads(model, batch, torch.Generator().manual_seed(0), ss=1.0)
    assert abs(float(loss) - loss_j) < 1e-5
    teacher, _, _ = port_loss_and_grads(model, batch)
    assert abs(float(loss) - float(teacher)) > 1e-4  # sampling changed the inputs


def test_remat_replays_dropout_masks(tiny_model_cfg, batch):
    """remat on == remat off with dropout 0.2: the recomputed layers draw
    the same masks, because the seeds are arguments of the layer."""
    tree = jax_params(tiny_model_cfg, seed=6)
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(tiny_model_cfg, dropout=0.2, remat=remat)
        model = port_model(cfg, tree)
        results.append(port_loss_and_grads(model, batch, torch.Generator().manual_seed(21)))
    (loss_a, _, grads_a), (loss_b, _, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    for (name, a), (_, b) in zip(leaves(grads_a), leaves(grads_b)):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
    # dropout is on (the loss moved), seeded, and the generator advances
    model = port_model(dataclasses.replace(tiny_model_cfg, dropout=0.2), tree)
    gen = torch.Generator().manual_seed(21)
    first, _, _ = port_loss_and_grads(model, batch, gen)
    second, _, _ = port_loss_and_grads(model, batch, gen)
    clean, _, _ = port_loss_and_grads(model, batch)
    assert torch.equal(first, loss_a) and not torch.equal(first, second)
    assert abs(float(first) - float(clean)) > 1e-4
    # train()/eval() mode switches nothing; the generator does
    model.eval()
    assert torch.equal(port_loss_and_grads(model, batch)[0], clean)


@pytest.mark.parametrize("policy", ["dots", "attn", "attn_ffn"])
def test_named_remat_policies_are_refused(tiny_model_cfg, batch, policy):
    cfg = dataclasses.replace(tiny_model_cfg, remat=True, remat_policy=policy)
    model = port_model(cfg, jax_params(cfg, seed=6))
    with pytest.raises(NotImplementedError):
        model.forward_train(torch_batch(batch))


def test_dropout_site_function():
    x = torch.ones(4, 1000)
    a, b, c = L.dropout(x, 0.2, 5), L.dropout(x, 0.2, 5), L.dropout(x, 0.2, 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 1.25}
    assert abs(float(a.mean()) - 1.0) < 0.05
    assert L.dropout(x, 0.2, None) is x and L.dropout(x, 0.0, 5) is x


def test_pad_target_time_and_query_pos(tiny_model_cfg):
    from faceformer_tpu.models.common import pad_target_time as jax_pad
    from faceformer_tpu.models.common import padded_query_pos as jax_qpos

    rng = np.random.default_rng(0)
    target = rng.integers(0, 9, (2, 3, 15)).astype(np.int32)
    mask = rng.random((2, 3, 15)) < 0.3
    table = rng.standard_normal((16, 8)).astype(np.float32)
    ours = pad_target_time(torch.as_tensor(target), torch.as_tensor(mask), 15)
    theirs = jax_pad(jnp.asarray(target), jnp.asarray(mask), 15)
    assert ours[2] == theirs[2] == 16
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(
        padded_query_pos(torch.as_tensor(table), 15, 16, torch.float32).numpy(),
        np.asarray(jax_qpos(jnp.asarray(table), 15, 16, jnp.float32)))
    same = pad_target_time(torch.as_tensor(target[..., :8]), torch.as_tensor(mask[..., :8]), 8)
    assert same[2] == 8 and same[0].shape[-1] == 8


def test_pack_label_parallel_matches_jax(tiny_model_cfg):
    faces = [(0, [[0, 1, 2, 3]]), (1, [[4, 5, 6], [7, 8, 9]]), (5, [[10, 11, 12, 13, 14]])]
    ours = pack_label_parallel(faces, port_model_cfg(tiny_model_cfg))
    theirs = jax_pack_label_parallel(faces, tiny_model_cfg)
    for key in ("label", "label_mask"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["num_faces"] == theirs["num_faces"] == 3
    assert count_rotation_rows(faces) == 15
    with pytest.raises(ValueError):
        pack_label_parallel([(0, [list(range(20))])], port_model_cfg(tiny_model_cfg))
