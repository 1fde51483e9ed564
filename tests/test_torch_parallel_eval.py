"""PyTorch port: validate and test over two gloo ranks on the CPU against the
JAX package's ``num_devices 2``, under each decode engine (fp32, tiny dims):
equal metrics and byte-equal prediction JSONs, as
tests/test_torch_harness.py::test_validate_and_test_match_jax holds for one
device. Each rank decodes, scores and writes its rows of every batch; the
writer alone writes ``results.json``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faceformer_tpu import ops as jax_ops
from faceformer_tpu.config import Config, DecodeConfig, TrainerConfig, config_to_dict
from faceformer_tpu.data.dataset import ABCDatasetParallel as JaxDataset
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu.train.trainer import Harness as JaxHarness

from torch_parallel_helpers import run_ranks
from torch_port_helpers import jax_params, torch_fp32_single_thread  # noqa: F401

MODES = ("reference", "causal_cache", "fused")


def jax_cfg(model_cfg, mode):
    return Config(
        model_class="SurfaceFormer_Parallel", dataset_class="ABCDataset_Parallel",
        batch_size_train=4, batch_size_valid=4, model=model_cfg,
        trainer=TrainerConfig(name="pe", version="v0", precision="fp32", num_devices=2),
        decode=DecodeConfig(mode=mode, precision="fp32"))


def read_dir(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def evaluated(tiny_model_cfg, tmp_path_factory):
    """Both ranks' validate and test under every engine (one run of two
    ranks), and the split they ran on: three valid and five test solids,
    so the two-rank batches are padded."""
    out = str(tmp_path_factory.mktemp("eval"))
    rng = np.random.default_rng(11)
    rows = [random_sample(rng) for _ in range(16)]
    splits = {"train": rows[:8], "valid": rows[8:11], "test": rows[11:]}
    names = {k: [f"json/{k}{i:03d}.json" for i in range(len(v))] for k, v in splits.items()}
    tree = jax_params(tiny_model_cfg, seed=4)
    run_ranks({"cfg": config_to_dict(jax_cfg(tiny_model_cfg, "reference")), "splits": splits,
               "names": names, "eval_tree": tree, "modes": MODES, "tasks": ["eval"]}, out)
    return {"out": out, "splits": splits, "names": names, "tree": tree}


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_validate_and_test_match_jax_two_devices(tiny_model_cfg, evaluated, mode):
    out, splits, names = evaluated["out"], evaluated["splits"], evaluated["names"]
    jh = JaxHarness(jax_cfg(tiny_model_cfg, mode),
                    datasets={k: JaxDataset.from_samples(v, tiny_model_cfg, names[k])
                              for k, v in splits.items()})
    jh.log_dir = os.path.join(out, f"jax_{mode}")
    params = jax.tree.map(jnp.asarray, evaluated["tree"])
    if mode == "fused":
        jax_ops.enable(True)  # JAX's fused engine runs its Pallas kernel (interpreted)
    try:
        want_valid = jh.validate(params)
        want_test = jh.test(params)
    finally:
        jax_ops.enable(None)
    got = [json.load(open(os.path.join(out, f"eval_{mode}_rank{r}.json"))) for r in (0, 1)]
    for rank in got:  # every rank returns the global results
        assert rank["valid"] == want_valid
        for key in ("test_precision", "test_recall", "test_type_acc", "num_samples"):
            assert rank["test"][key] == want_test[key], key
    assert got[0]["test"]["num_samples"] == len(splits["test"])
    port_dir = os.path.join(out, f"eval_{mode}")
    ours, theirs = read_dir(os.path.join(port_dir, "json")), read_dir(
        os.path.join(jh.log_dir, "json"))
    assert len(ours) == len(splits["test"])
    assert ours == theirs
    with open(os.path.join(port_dir, "results.json")) as f:
        assert json.load(f) == got[0]["test"]  # the writer's
    with open(os.path.join(port_dir, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 1  # one writer
