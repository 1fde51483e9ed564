"""PyTorch port: the fit over two and four gloo ranks on the CPU
(``parallel/mesh.py``) against the JAX package's ``num_devices`` 2 and 4
(of conftest's virtual CPU devices), fp32, tiny dims, dropout 0: the losses and
parameters, one writer; checkpoints across rank counts. The step's global
token mean and NaN skip, and the training stripe, are in
tests/test_torch_parallel_step.py; the command line's ranks and concurrent
builds in tests/test_torch_parallel_procs.py; evaluation in
tests/test_torch_parallel_eval_*.py. The ranks run in processes of their
own (tests/torch_parallel_helpers.py)."""

import json
import os

import jax
import numpy as np
import pytest

from faceformer_tpu.config import Config, DecodeConfig, TrainerConfig, config_to_dict
from faceformer_tpu.data.dataset import ABCDatasetParallel as JaxDataset
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu.train.trainer import Harness as JaxHarness
from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.params import params_from_jax, params_to_numpy
from faceformer_tpu_torch.train.checkpoint import CheckpointManager
from faceformer_tpu_torch.train.trainer import Harness

from torch_parallel_helpers import flat, load_rank, run_ranks
from torch_port_helpers import leaves, torch_fp32_single_thread  # noqa: F401

LR = 1e-4


def jax_cfg(model_cfg, num_devices=2, mode="causal_cache"):
    return Config(
        model_class="SurfaceFormer_Parallel", dataset_class="ABCDataset_Parallel",
        batch_size_train=4, batch_size_valid=4, model=model_cfg,
        trainer=TrainerConfig(name="p", version="v0", lr=LR, checkpoint_period=1,
                              precision="fp32", num_devices=num_devices, max_epochs=2),
        decode=DecodeConfig(mode=mode, precision="fp32"))


def port_cfg(cfg):
    return config_from_dict(config_to_dict(cfg))


def samples(seed, count):
    rng = np.random.default_rng(seed)
    return [random_sample(rng) for _ in range(count)]


def records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_fit(n, tiny_model_cfg, out):
    """A fit of ``n`` ranks against JAX's at ``num_devices n``, with the JAX
    side's inputs; at two ranks also the load of a one-rank checkpoint.
    Train 8 rows at a global batch of 4: one row a rank at four."""
    rows = samples(11, 14)
    splits = {"train": rows[:8], "valid": rows[8:11], "test": rows[11:]}
    names = {k: [f"json/{k}{i:03d}.json" for i in range(len(v))] for k, v in splits.items()}
    cfg = jax_cfg(tiny_model_cfg, num_devices=n)
    jax_harness = JaxHarness(cfg, datasets={
        k: JaxDataset.from_samples(v, tiny_model_cfg, names[k]) for k, v in splits.items()})
    jax_harness.log_dir = os.path.join(out, "jax")
    state = jax_harness.init_state()
    # a copy: the JAX fit donates the buffers an np.asarray view would share
    tree = jax.tree.map(np.array, state["params"])
    job = {"cfg": config_to_dict(cfg), "splits": splits, "names": names, "tree": tree,
           "tasks": ["fit"]}
    if n == 2:
        # a checkpoint of one rank (the JAX init, 3 steps on), for the ranks to load
        one = Harness(port_cfg(jax_cfg(tiny_model_cfg, num_devices=1)), device="cpu")
        ckpt_state = one.init_state()
        params_from_jax(ckpt_state["model"], tree)
        ckpt_state["step"] = 3
        job["ckpt"] = CheckpointManager(os.path.join(out, "one-rank"), top_k=1).save(
            one.checkpoint_tree(ckpt_state), one.cfg, 1)
        job["tasks"].append("load")
    run_ranks(job, out, ranks=n)
    final = jax_harness.fit(state)
    return {"out": out, "jax": jax_harness, "jax_final": final, "tree": tree, "cfg": cfg,
            "n": n}


@pytest.fixture(scope="module")
def ranks(tiny_model_cfg, tmp_path_factory):
    """One run of two ranks for the whole file: the fit and the load of a
    one-rank checkpoint."""
    return run_fit(2, tiny_model_cfg, str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module", params=[2, 4])
def fit_ranks(request, tiny_model_cfg, tmp_path_factory):
    """The fit at two ranks (``ranks``' run) and at four."""
    if request.param == 2:
        return request.getfixturevalue("ranks")
    return run_fit(4, tiny_model_cfg, str(tmp_path_factory.mktemp("ranks4")))


def test_two_rank_fit_matches_jax_two_devices(fit_ranks):
    """The fit of n ranks (2, and 4) against JAX's at num_devices n."""
    ranks = fit_ranks
    out, jh, n = ranks["out"], ranks["jax"], ranks["n"]
    assert int(ranks["jax_final"]["step"]) == 4
    got = [(r["step"], r["train_loss"]) for r in records(os.path.join(out, "fit"))
           if "train_loss" in r]
    want = [(r["step"], r["train_loss"]) for r in records(jh.log_dir) if "train_loss" in r]
    # one writer: one line a step (several ranks writing would repeat them)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], atol=1e-5)
    assert sum("valid_precision" in r for r in records(os.path.join(out, "fit"))) == 2
    index = [json.load(open(os.path.join(d, "checkpoints", "index.json")))
             for d in (os.path.join(out, "fit"), jh.log_dir)]
    assert ([os.path.basename(e[1]) for e in index[0]["top"]]
            == [os.path.basename(e[1]) for e in index[1]["top"]])

    ranks_params = [load_rank(out, "fit", r) for r in range(n)]
    assert all(int(p["__step"]) == 4 for p in ranks_params)
    close = total = 0
    for name, want in leaves(jax.tree.map(np.asarray, ranks["jax_final"]["params"])):
        for other in ranks_params[1:]:
            np.testing.assert_array_equal(ranks_params[0][name], other[name])
        # every entry within 10 lr, most within 1e-5 (test_fit_matches_jax)
        np.testing.assert_allclose(ranks_params[0][name], want, atol=10 * LR, err_msg=name)
        close += int((np.abs(ranks_params[0][name] - want) <= 1e-5).sum())
        total += want.size
    assert close > 0.9 * total


def test_checkpoints_load_across_rank_counts(ranks, tiny_model_cfg):
    """A checkpoint one rank wrote loads on each of two ranks; the two-rank
    fit's ``last`` loads on one rank: the same parameters and step."""
    for rank in (0, 1):
        got = load_rank(ranks["out"], "load", rank)
        assert int(got["__step"]) == 3
        for name, want in leaves(ranks["tree"]):
            np.testing.assert_array_equal(got[name], want)
    one = Harness(port_cfg(jax_cfg(tiny_model_cfg, num_devices=1)), device="cpu")
    state = one.load(os.path.join(ranks["out"], "fit", "checkpoints", "last"))
    fitted = load_rank(ranks["out"], "fit", 0)
    assert state["step"] == int(fitted["__step"]) == 4
    for name, value in flat(params_to_numpy(state["model"])).items():
        np.testing.assert_array_equal(value, fitted[name])


