"""PyTorch port: the flat SurfaceFormer under the model axis
(parallel/tensor.py, the Megatron split of faceformer_tpu/parallel/mesh.py)
on a 2x2 grid of gloo ranks on the CPU (data 2 x model 2), fp32, tiny
dims, with and without direction tokens: the loss and every gathered
gradient against JAX's replicated value_and_grad of the flat
forward_train; both engines' grids against JAX's greedy_decode_single;
the causal_cache's self-attention cache on the rank's heads; with
dropout, remat and scheduled sampling, the loss and gradients against the
port's one-rank run with the same seeds (and a planted fault: the keep
masks' head offset left at 0); the split table against JAX's
param_partition_specs. The ranks run in processes of their own
(tests/torch_parallel_helpers.py::task_tp_flat)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.config import Config, DecodeConfig, TrainerConfig, config_to_dict
from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.dataset import ABCDataset as JaxDataset
from faceformer_tpu.decode import greedy_decode_single as jax_decode
from faceformer_tpu.models.surfaceformer import SurfaceFormer as JaxFlat
from faceformer_tpu.parallel.mesh import param_partition_specs
from faceformer_tpu.train.loss import pointer_cross_entropy as jax_cross_entropy
from faceformer_tpu_torch.params import _leaves, grads_to_numpy
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.parallel.tensor import partition_specs, shard_params_
from faceformer_tpu_torch.train.loss import summed_cross_entropy
from faceformer_tpu_torch.train.trainer import rank_generator

from torch_flat_helpers import fitting_samples, flavor_cfg
from torch_parallel_helpers import flat, load_rank, run_ranks
from torch_port_helpers import (  # noqa: F401
    jax_params,
    port_model,
    torch_batch,
    torch_fp32_single_thread,
)

SEED = 7
SAMPLING = 0.5
# the direction-token labels and the combined-edge ones (no direction token)
FLAVORS = ("direction", "combined")


def jax_cfg(model_cfg, sampling: float = 0.0):
    return Config(
        model_class="SurfaceFormer", dataset_class="ABCDataset",
        batch_size_train=4, batch_size_valid=4, model=model_cfg,
        trainer=TrainerConfig(name="tpf", version="v0", lr=1e-4, precision="fp32",
                              num_devices=4, scheduled_sampling=sampling),
        decode=DecodeConfig(precision="fp32"))


@pytest.fixture(scope="module")
def ranks(tiny_model_cfg, tmp_path_factory):
    """One run of four ranks (data 2 x model 2) for the whole file, both
    flavors in it."""
    out = str(tmp_path_factory.mktemp("tp_flat"))
    cases, jobs = {}, []
    for i, flavor in enumerate(FLAVORS):
        cfg = flavor_cfg(tiny_model_cfg, flavor, label_seq_length=64)
        dropout_cfg = dataclasses.replace(cfg, dropout=0.1, remat=True, remat_policy="full")
        samples = fitting_samples(cfg, 4, seed=SEED + i, flavor=flavor)
        tree = jax_params(cfg, seed=2 + i, flat=True)
        jobs.append({"flavor": flavor, "cfg": config_to_dict(jax_cfg(cfg)),
                     "cfg_dropout": config_to_dict(jax_cfg(dropout_cfg, SAMPLING)),
                     "tree": tree, "batch_samples": samples})
        ds = JaxDataset.from_samples(samples, cfg)
        batch = {k: v for k, v in collate([ds[j] for j in range(4)]).items()
                 if not isinstance(v, (list, str))}
        cases[flavor] = {"cfg": cfg, "dropout_cfg": dropout_cfg, "tree": tree, "batch": batch}
    run_ranks({"flat": jobs, "seed": SEED, "ranks": 4, "model_axis": 2, "tasks": ["tp_flat"]},
              out, ranks=4)
    return {"cases": cases, "r": [load_rank(out, "tp_flat", r) for r in range(4)]}


@pytest.mark.parametrize("flavor", FLAVORS)
def test_flat_tp_loss_and_gradients_match_jax_replicated(ranks, flavor):
    """The 2x2 step's loss and every gathered gradient against JAX's
    value_and_grad of the flat forward_train over the whole batch; each
    rank holds an (E/2, E) shard of the pointer projection."""
    case = ranks["cases"][flavor]
    cfg = case["cfg"]
    params = jax.tree.map(jnp.asarray, case["tree"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}

    def loss_fn(p):
        out = JaxFlat.forward_train(p, cfg, batch, rng=None)
        return jax_cross_entropy(out, cfg.token)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = flat(jax.tree.map(np.asarray, ref_grads))
    e = cfg.num_model
    for r in ranks["r"]:
        assert tuple(r[f"{flavor}/__project_shape"]) == (e // 2, e)
        assert abs(float(r[f"{flavor}/__loss"]) - float(ref_loss)) < 1e-5
        for name, g in want.items():
            np.testing.assert_allclose(r[f"{flavor}/grad/{name}"], g, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("mode", ["reference", "causal_cache"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_flat_tp_decode_grids_equal_jax(ranks, flavor, mode):
    """Each engine's grid, the data ranks' rows put back in place, equal to
    JAX's greedy_decode_single; the two model ranks of a data rank decode
    the same grid."""
    case = ranks["cases"][flavor]
    theirs = np.asarray(jax_decode(jax.tree.map(jnp.asarray, case["tree"]), case["cfg"],
                                   case["batch"], precision="fp32", mode=mode)["predict"])
    ours = np.zeros_like(theirs)
    key = f"{flavor}/grid/{mode}"
    for r in ranks["r"]:
        ours[r[f"{flavor}/__rows"]] = r[key]
    for d in (0, 2):
        np.testing.assert_array_equal(ranks["r"][d][key], ranks["r"][d + 1][key])
    np.testing.assert_array_equal(ours, theirs)
    assert (theirs[:, 1:] != case["cfg"].token.PAD).any()


@pytest.mark.parametrize("flavor", FLAVORS)
def test_flat_tp_cache_holds_the_rank_heads(ranks, flavor):
    """The causal_cache's self-attention K/V cache, (N, T, H_local, hd) on
    each rank: 2 of the 4 heads, the data rank's 2 rows."""
    cfg = ranks["cases"][flavor]["cfg"]
    hd = cfg.num_model // cfg.num_head
    for r in ranks["r"]:
        np.testing.assert_array_equal(r[f"{flavor}/__cache_shapes"],
                                      [[2, cfg.label_seq_length, cfg.num_head // 2, hd]])


@pytest.mark.parametrize("flavor", FLAVORS)
def test_flat_tp_dropout_remat_sampling_match_one_rank(ranks, flavor):
    """Dropout 0.1, remat full and scheduled sampling 0.5: the 2x2 loss and
    gathered gradients against one process running both data ranks' rows,
    each with its data rank's stream (trainer.rank_generator), as one rank
    holding every head and column. The planted fault (every head offset
    left at 0) reads far outside the tolerance."""
    case = ranks["cases"][flavor]
    model = port_model(case["dropout_cfg"], case["tree"], flat=True)
    token = model.cfg.token
    batch = torch_batch(case["batch"])
    sums, counts = [], []
    for d in (0, 1):
        rows = {k: v[d::2] for k, v in batch.items()}
        out = model.forward_train(rows, generator=rank_generator(SEED, d),
                                  scheduled_sampling_ratio=SAMPLING)
        loss_sum, aux = summed_cross_entropy(out, token)
        sums.append(loss_sum)
        counts.append(aux["valid_tokens"].float())
    loss = (sums[0] + sums[1]) / (counts[0] + counts[1])
    loss.backward()
    want = flat(grads_to_numpy(model))
    worst_fault = 0.0
    for r in ranks["r"]:
        np.testing.assert_allclose(r[f"{flavor}/__ok_loss"], float(loss.detach()), rtol=1e-4)
        for name, g in want.items():
            np.testing.assert_allclose(r[f"{flavor}/ok/{name}"], g, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            scale = float(np.abs(g).max()) + 1e-12
            worst_fault = max(worst_fault,
                              float(np.abs(r[f"{flavor}/fault/{name}"] - g).max()) / scale)
    assert worst_fault > 1e-2
    # sampling moved the inputs: the teacher-forced loss differs
    with torch.no_grad():
        teacher = [summed_cross_entropy(model.forward_train(
            {k: v[d::2] for k, v in batch.items()}, generator=rank_generator(SEED, d)),
            token)[0] for d in (0, 1)]
    assert abs(float((teacher[0] + teacher[1]) / (counts[0] + counts[1]))
               - float(loss.detach())) > 1e-4


@pytest.mark.parametrize("flat_model", [True, False], ids=["flat", "parallel"])
def test_split_table_is_jax_param_partition_specs(tiny_model_cfg, flat_model):
    """Every leaf the port cuts is one JAX's param_partition_specs(...,
    shard_model=True) cuts, on the same axis in torch's (out, in) layout,
    and no other; shard_params_ halves each cut leaf on that axis."""
    cfg = flavor_cfg(tiny_model_cfg, "direction")
    tree = jax_params(cfg, seed=1, flat=flat_model)
    specs = param_partition_specs(tree, shard_model=True)
    model = port_model(cfg, tree, flat=flat_model)
    ours = partition_specs(model)
    names = {id(p): name for name, p in model.named_parameters()}
    cut = 0
    for path, param, layer, transposed in _leaves(model):
        spec = specs
        for key in path:
            spec = spec[key]
        axes = tuple(spec)[1:] if layer is not None else tuple(spec)  # the stacked layer axis
        jax_dim = axes.index("model") if "model" in axes else None
        want = None if jax_dim is None else (param.ndim - 1 - jax_dim if transposed else jax_dim)
        assert ours[names[id(param)]] == want, (path, layer)
        cut += want is not None
    # per encoder layer 8 column and 2 row leaves, per decoder layer 14 and 3, project 2
    assert cut == 2 * 10 + 2 * 17 + 2
    whole = {name: p.shape for name, p in model.named_parameters()}
    world = mesh.World(1, 4, 1, 4, torch.device("cpu"), "gloo", model_axis=2)
    shard_params_(model, world)
    assert model.shard is not None and model.decoder.layers[0].cross_attn.shard is model.shard
    for name, p in model.named_parameters():
        shape = list(whole[name])
        if ours[name] is not None:
            shape[ours[name]] //= 2
        assert list(p.shape) == shape, name
