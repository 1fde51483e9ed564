"""PyTorch port: the training step over two gloo ranks on the CPU
(``train/step.py`` under ``parallel/mesh.py``), fp32, tiny dims, dropout 0:
the gradient of the global token mean when the ranks hold different
numbers of label tokens, and the NaN skip taken by every rank together;
and the training stripe of one and two hosts. The ranks run in processes
of their own (tests/torch_parallel_helpers.py)."""

import numpy as np
import pytest
import torch

from faceformer_tpu.config import Config, DecodeConfig, TrainerConfig, config_to_dict
from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.dataset import ABCDatasetParallel as JaxDataset
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu_torch.data.batching import iter_batches
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.params import grads_to_numpy
from faceformer_tpu_torch.train.loss import pointer_cross_entropy

from torch_parallel_helpers import flat, load_rank, run_ranks
from torch_port_helpers import (  # noqa: F401
    jax_params,
    leaves,
    port_model,
    torch_batch,
    torch_fp32_single_thread,
)


@pytest.fixture(scope="module")
def ranks(tiny_model_cfg, tmp_path_factory):
    """One run of two ranks for the whole file: the uneven-token step and
    the NaN skip, from one parameter tree, on four solids whose label-token
    counts differ between rows 0, 2 and 1, 3."""
    out = str(tmp_path_factory.mktemp("ranks"))
    cfg = Config(
        model_class="SurfaceFormer_Parallel", dataset_class="ABCDataset_Parallel",
        batch_size_train=4, batch_size_valid=4, model=tiny_model_cfg,
        trainer=TrainerConfig(name="p", version="v0", lr=1e-4, precision="fp32",
                              num_devices=2),
        decode=DecodeConfig(precision="fp32"))
    tree = jax_params(tiny_model_cfg, seed=3)
    rng = np.random.default_rng(23)
    batch_samples = [random_sample(rng) for _ in range(4)]
    run_ranks({"cfg": config_to_dict(cfg), "tree": tree, "batch_samples": batch_samples,
               "tasks": ["uneven", "nan"]}, out)
    return {"out": out, "tree": tree, "batch_samples": batch_samples}


def test_global_token_mean_gradient_with_uneven_ranks(ranks, tiny_model_cfg):
    """The two-rank gradient is the one-rank gradient of the same global
    batch; the mean of the ranks' own means (DDP's average) is not."""
    out = ranks["out"]
    r0, r1 = (load_rank(out, "uneven", r) for r in (0, 1))
    assert int(r0["__tokens"]) != int(r1["__tokens"])  # the ranks' token counts differ
    model = port_model(tiny_model_cfg, ranks["tree"])
    ds = JaxDataset.from_samples(ranks["batch_samples"], tiny_model_cfg)
    batch = torch_batch(collate([ds[i] for i in range(4)]))
    loss, aux = pointer_cross_entropy(model.forward_train(batch), model.cfg.token)
    loss.backward()
    assert abs(float(r0["__loss"]) - float(loss.detach())) < 1e-6
    assert float(r0["__loss"]) == float(r1["__loss"])
    assert abs(float(r0["__acc"]) - float(aux["cls_acc"])) < 1e-6
    worst_global = worst_means = 0.0
    for name, want in flat(grads_to_numpy(model)).items():
        np.testing.assert_array_equal(r0[f"global/{name}"], r1[f"global/{name}"])
        worst_global = max(worst_global, float(np.abs(r0[f"global/{name}"] - want).max()))
        means = (r0[f"own/{name}"] + r1[f"own/{name}"]) / 2
        worst_means = max(worst_means, float(np.abs(means - want).max()))
    assert worst_global <= 1e-6
    assert worst_means > 1e-4


def test_nan_skip_is_global(ranks):
    """A NaN on rank 1's rows: both ranks skip the step (parameters and Adam
    untouched, equal on both: step count 0 and every moment 0), then both
    take the next one alike, to finite parameters."""
    r0, r1 = (load_rank(ranks["out"], "nan", r) for r in (0, 1))
    assert not np.isfinite(r0["__skipped_loss"]) and not np.isfinite(r1["__skipped_loss"])
    assert int(r0["__adam_steps_after_skip"]) == int(r1["__adam_steps_after_skip"]) == 0
    for r in (r0, r1):
        # the fused Adam holds a state for every parameter after the skip;
        # NaN != 0, so a NaN moment fails here
        assert int(r["__adam_slots_after_skip"]) == int(r["__parameters"]) > 0
        moments = [k for k in r if k.startswith(("exp_avg/", "exp_avg_sq/"))]
        assert len(moments) == 2 * int(r["__parameters"])
        for k in moments:
            assert not np.any(r[k] != 0), k
    moved = 0
    for name, init in leaves(ranks["tree"]):
        for r in (r0, r1):
            np.testing.assert_array_equal(r[f"skipped/{name}"], init)
        np.testing.assert_array_equal(r0[f"stepped/{name}"], r1[f"stepped/{name}"])
        assert np.all(np.isfinite(r0[f"stepped/{name}"])), name
        moved += int(not np.array_equal(r0[f"stepped/{name}"], init))
    assert moved > 0 and np.isfinite(r0["__stepped_loss"])


@pytest.mark.parametrize("hosts", [1, 2])
def test_training_stripe_covers_the_global_batch(hosts):
    """Two ranks, one host each or both on one host: each step's rows,
    over both ranks, are the rows one process takes at the global batch
    size (``batch_size_train`` a host), epoch by epoch."""
    data = [{"i": i} for i in range(23)]
    batch_size = 4
    worlds = [mesh.World(r, 2, r % (2 // hosts), 2 // hosts, torch.device("cpu"))
              for r in (0, 1)]
    assert all(w.hosts == hosts for w in worlds)
    for epoch in (0, 1):
        kw = dict(shuffle=True, drop_last=True, seed=7, epoch=epoch)
        per_rank = [list(mesh.shard_batch(data, batch_size, w, **kw)) for w in worlds]
        single = list(iter_batches(data, batch_size * hosts, **kw))
        assert len(per_rank[0]) == len(per_rank[1]) == len(single) > 0
        for a, b, want in zip(*per_rank, single):
            assert len(a["i"]) == len(b["i"]) == batch_size * hosts // 2
            assert sorted(a["i"].tolist() + b["i"].tolist()) == sorted(want["i"].tolist())
    with pytest.raises(ValueError, match="divide"):
        mesh.rank_rows(mesh.World(0, 4, 0, 4, torch.device("cpu")), 6)


def test_world_outside_ranks():
    """One rank without a rank environment; more raise and name the two
    ways to start them; a rank count the model axis does not divide raises
    (JAX's rule, mesh.py:29-30)."""
    world = mesh.make_mesh(1, "cpu")
    assert (world.rank, world.size, world.hosts, world.is_writer, world.distributed) == (
        0, 1, 1, True, False)
    assert mesh.local_ranks(0, "cpu") == 1 and mesh.local_ranks(3, "cpu") == 3
    assert mesh.eval_batch_size(mesh.World(0, 2, 0, 2, torch.device("cpu")), 3) == 2
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="not divisible by model_axis=2"):
        mesh.make_mesh(3, "cpu", model_axis=2)
    assert mesh.make_mesh(1, "cpu", model_axis=1).size == 1
    assert mesh.global_mean(world, [1.0, 2.0]) == 1.5 and mesh.global_sum(world, 3) == 3.0


