"""PyTorch port: tensor parallelism over the model axis (parallel/tensor.py,
the Megatron split of faceformer_tpu/parallel/mesh.py) on a 2x2 grid of
gloo ranks on the CPU (data 2 x model 2), fp32, tiny dims, as
tests/test_tensor_parallel.py runs JAX's: the loss and every gradient,
gathered, against JAX's replicated value_and_grad; each engine's decode
grid against JAX's; Adam's state cut and gathered; with dropout and remat,
the loss and gradients against the port's one-rank run with the same
seeds (and a planted fault: the keep masks' head offset left at 0); the
keep masks of a rank's heads and FFN columns without ranks. The ranks run
in processes of their own (tests/torch_parallel_helpers.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.config import Config, DecodeConfig, TrainerConfig, config_to_dict
from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.dataset import ABCDatasetParallel as JaxDataset
from faceformer_tpu.decode import greedy_decode_parallel as jax_decode
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu.models.parallel import SurfaceFormerParallel as JaxParallel
from faceformer_tpu.train.loss import pointer_cross_entropy as jax_cross_entropy
from faceformer_tpu_torch.models import layers as L
from faceformer_tpu_torch.ops.flash import philox_keep_mask
from faceformer_tpu_torch.params import grads_to_numpy
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.parallel.tensor import Shard, partition_specs
from faceformer_tpu_torch.train.loss import summed_cross_entropy
from faceformer_tpu_torch.train.trainer import rank_generator

from torch_parallel_helpers import flat, load_rank, run_ranks
from torch_port_helpers import (  # noqa: F401
    jax_params,
    port_model,
    torch_batch,
    torch_fp32_single_thread,
)

SEED = 5


def jax_cfg(model_cfg):
    return Config(
        model_class="SurfaceFormer_Parallel", dataset_class="ABCDataset_Parallel",
        batch_size_train=4, batch_size_valid=4, model=model_cfg,
        trainer=TrainerConfig(name="tp", version="v0", lr=1e-4, precision="fp32",
                              num_devices=4),
        decode=DecodeConfig(precision="fp32"))


@pytest.fixture(scope="module")
def ranks(tiny_model_cfg, tmp_path_factory):
    """One run of four ranks (data 2 x model 2) for the whole file."""
    out = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(11)
    samples = [random_sample(rng) for _ in range(4)]
    dropout_cfg = dataclasses.replace(tiny_model_cfg, dropout=0.1, remat=True,
                                      remat_policy="full")
    tree = jax_params(tiny_model_cfg, seed=4)
    run_ranks({"cfg": config_to_dict(jax_cfg(tiny_model_cfg)),
               "cfg_dropout": config_to_dict(jax_cfg(dropout_cfg)), "tree": tree,
               "batch_samples": samples, "seed": SEED, "ranks": 4, "model_axis": 2,
               "tasks": ["tp", "tp_dropout"]}, out, ranks=4)
    ds = JaxDataset.from_samples(samples, tiny_model_cfg)
    batch = {k: v for k, v in collate([ds[i] for i in range(4)]).items()
             if not isinstance(v, (list, str))}
    return {"out": out, "tree": tree, "batch": batch, "dropout_cfg": dropout_cfg,
            "r": [load_rank(out, "tp", r) for r in range(4)]}


def test_tp_loss_and_gradients_match_jax_replicated(ranks, tiny_model_cfg):
    """(a) The 2x2 step's loss and every gathered gradient against JAX's
    value_and_grad over the whole batch (test_tensor_parallel.py:60-67);
    each rank holds an (E/2, E) shard of the decoder's q projection."""
    cfg = tiny_model_cfg
    params = jax.tree.map(jnp.asarray, ranks["tree"])
    batch = {k: jnp.asarray(v) for k, v in ranks["batch"].items()}

    def loss_fn(p):
        out = JaxParallel.forward_train(p, cfg, batch, rng=None)
        return jax_cross_entropy(out, cfg.token)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = flat(jax.tree.map(np.asarray, ref_grads))
    e = cfg.num_model
    for r in ranks["r"]:
        assert tuple(r["__q_shape"]) == (e // 2, e)
        np.testing.assert_allclose(r["__loss"], np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
        for name, g in want.items():
            np.testing.assert_allclose(r[f"grad/{name}"], g, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["reference", "causal_cache", "fused"])
def test_tp_decode_grids_equal_jax(ranks, tiny_model_cfg, mode):
    """(b) Each engine's grid, the data ranks' rows put back in place, equal
    to JAX's (the fused engine, plain K4 on the CPU, against JAX's
    causal_cache, as tests/test_torch_decode.py holds it); the two model
    ranks of a data rank decode the same grid."""
    params = jax.tree.map(jnp.asarray, ranks["tree"])
    theirs = np.asarray(jax_decode(params, tiny_model_cfg, ranks["batch"], precision="fp32",
                                   mode="causal_cache" if mode == "fused" else mode)["predict"])
    ours = np.zeros_like(theirs)
    for r in ranks["r"]:
        ours[r["__rows"]] = r[f"grid/{mode}"]
    for d in (0, 2):
        np.testing.assert_array_equal(ranks["r"][d][f"grid/{mode}"],
                                      ranks["r"][d + 1][f"grid/{mode}"])
    np.testing.assert_array_equal(ours, theirs)


def test_shard_opt_state_mirrors_the_parameter_shards(ranks, tiny_model_cfg):
    """(c) Adam's exp_avg and exp_avg_sq cut as their parameters, step
    replicated, and the values survive the cut and the gather
    (test_tensor_parallel.py:86-123)."""
    model = port_model(tiny_model_cfg, ranks["tree"])
    specs = partition_specs(model)
    # per encoder layer 8 column and 2 row leaves, per decoder layer 14 and 3, project 2
    assert sum(d is not None for d in specs.values()) == 2 * 10 + 2 * 17 + 2
    for rank, r in enumerate(ranks["r"]):
        model_rank = rank % 2
        for name, dim in specs.items():
            shape = tuple(r[f"opt/{name}/shape"])
            for key in ("exp_avg", "exp_avg_sq"):
                whole, cut = r[f"opt/{name}/{key}/whole"], r[f"opt/{name}/{key}/cut"]
                assert cut.shape == shape, name
                if dim is None:
                    np.testing.assert_array_equal(cut, whole)
                else:
                    width = whole.shape[dim] // 2
                    np.testing.assert_array_equal(
                        cut, np.take(whole, range(model_rank * width, (model_rank + 1) * width),
                                     axis=dim))
                np.testing.assert_array_equal(r[f"opt/{name}/{key}/back"], whole)
            np.testing.assert_array_equal(r[f"opt/{name}/step/cut"], r[f"opt/{name}/step/whole"])
            np.testing.assert_array_equal(r[f"opt/{name}/loaded"], r[f"opt/{name}/exp_avg/cut"])


def test_tp_dropout_and_remat_match_one_rank(ranks, tiny_model_cfg):
    """(d) Dropout 0.1 and remat full: the 2x2 loss and gathered gradients
    against one process running both data ranks' rows, each with its data
    rank's stream (trainer.rank_generator), as one rank holding every head
    and column. The planted fault (every head offset left at 0) reads far
    outside the tolerance."""
    cfg = ranks["dropout_cfg"]
    model = port_model(cfg, ranks["tree"])
    token = model.cfg.token
    batch = torch_batch(ranks["batch"])
    sums, counts = [], []
    for d in (0, 1):
        rows = {k: v[d::2] for k, v in batch.items()}
        out = model.forward_train(rows, generator=rank_generator(SEED, d))
        loss_sum, aux = summed_cross_entropy(out, token)
        sums.append(loss_sum)
        counts.append(aux["valid_tokens"].float())
    loss = (sums[0] + sums[1]) / (counts[0] + counts[1])
    loss.backward()
    want = flat(grads_to_numpy(model))
    worst_fault = 0.0
    for r in (load_rank(ranks["out"], "tp_dropout", k) for k in range(4)):
        np.testing.assert_allclose(r["__ok_loss"], float(loss.detach()), rtol=1e-4)
        for name, g in want.items():
            np.testing.assert_allclose(r[f"ok/{name}"], g, rtol=1e-4, atol=1e-5, err_msg=name)
            scale = float(np.abs(g).max()) + 1e-12
            worst_fault = max(worst_fault, float(np.abs(r[f"fault/{name}"] - g).max()) / scale)
    assert worst_fault > 1e-2


@pytest.mark.parametrize("h,rank", [(4, 1), (8, 3)])
def test_rank_keep_masks_equal_the_whole_masks(h, rank):
    """(e) Without ranks: a rank's heads' keep mask (head0 = its first
    head) equals those heads of the whole mask, bit for bit; the FFN
    activation's mask drawn at the whole width and cut to the rank's
    columns equals the whole mask's columns."""
    size = 2 if h == 4 else 4
    local = h // size
    whole = philox_keep_mask(77, 3, h, 9, 13, 0.2)
    part = philox_keep_mask(77, 3, local, 9, 13, 0.2, head0=rank * local)
    assert torch.equal(part, whole[:, rank * local:(rank + 1) * local])
    assert not torch.equal(part, philox_keep_mask(77, 3, local, 9, 13, 0.2))
    x = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(3))
    width = 24 // size
    cols = slice(rank * width, (rank + 1) * width)
    got = L.dropout(x[..., cols], 0.2, 123, Shard(rank, size, None))
    assert torch.equal(got, L.dropout(x, 0.2, 123)[..., cols])


def test_make_mesh_model_axis_rule():
    """JAX's rule (mesh.py:29-30): a rank count that does not divide by the
    model axis raises; the grid's coordinates are JAX's reshape."""
    with pytest.raises(ValueError, match="not divisible by model_axis=2"):
        mesh.make_mesh(3, "cpu", model_axis=2)
    world = mesh.World(5, 8, 5, 8, torch.device("cpu"), "gloo", model_axis=2)
    assert (world.data_rank, world.data_size, world.model_rank) == (2, 4, 1)
    assert mesh.rank_rows(world, 8) == 2 and mesh.eval_batch_size(world, 6) == 4
    assert mesh.local_rows(world, 8) == slice(4, 6)
