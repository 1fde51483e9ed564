"""Shared setup for the flat SurfaceFormer's parity tests
(tests/test_torch_flat*.py): the three label flavours, seeded samples that
fit a config, and a JAX and a port Harness on the same splits."""

import dataclasses
import json
import os

import numpy as np
import pytest

from faceformer_tpu.config import (
    Config,
    DecodeConfig,
    PostProcessConfig,
    TokenConfig,
    TrainerConfig,
    config_to_dict,
)
from faceformer_tpu.data.packing import pack_label_single as jax_pack_label_single
from faceformer_tpu.geometry.fixtures import random_sample

DIR_TOKENS = TokenConfig(DIR0=4, DIR1=5, length=6)
# random_sample keywords of the three flat label flavours: combined edges
# (flat index lists), coedge loops without face types (nested lists), and
# direction tokens ((index, orientation) pairs)
FLAVORS = {"combined": dict(coedge=False), "nested": dict(no_face_type=True),
           "direction": dict(direction_token=True)}


def flavor_cfg(tiny_model_cfg, flavor, label_seq_length=96):
    tok = DIR_TOKENS if flavor == "direction" else tiny_model_cfg.token
    return dataclasses.replace(tiny_model_cfg, num_lines=40, token=tok,
                               label_seq_length=label_seq_length)


def fitting_samples(cfg, count, seed, flavor):
    """Seeded random samples whose edges and single-sequence labels fit cfg."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        sample = random_sample(rng, **FLAVORS[flavor])
        if len(sample["edges"]) > cfg.num_lines:
            continue
        try:
            jax_pack_label_single(sample["faces_indices"], cfg)
        except ValueError:
            continue
        out.append(sample)
    return out


# -- the harness -------------------------------------------------------------------


@pytest.fixture(scope="module")
def flat_model_cfg(tiny_model_cfg):
    return dataclasses.replace(tiny_model_cfg, num_lines=40, label_seq_length=64,
                               token=DIR_TOKENS)


def jax_cfg(model_cfg, mode="causal_cache", **trainer):
    return Config(
        model_class="SurfaceFormer", dataset_class="ABCDataset",
        batch_size_train=4, batch_size_valid=4, model=model_cfg,
        trainer=TrainerConfig(**{"name": "f", "version": "v0", "lr": 1e-4,
                                 "checkpoint_period": 1, "precision": "fp32",
                                 "num_devices": 1, "max_epochs": 2, **trainer}),
        post_process=PostProcessConfig(is_coedge=False, direction_token=True),
        decode=DecodeConfig(mode=mode, precision="fp32"))


@pytest.fixture(scope="module")
def splits(flat_model_cfg):
    """Direction-token wireframes whose labels fit 64 tokens."""
    rng = np.random.default_rng(12)
    samples = []
    while len(samples) < 12:
        sample = random_sample(rng, direction_token=True)
        try:
            jax_pack_label_single(sample["faces_indices"], flat_model_cfg)
        except ValueError:
            continue
        if len(sample["edges"]) <= flat_model_cfg.num_lines:
            samples.append(sample)
    return {"train": samples[:8], "valid": samples[8:10], "test": samples[10:]}


def harnesses(model_cfg, splits, tmp_path, mode="causal_cache", **trainer):
    """A JAX and a port Harness on the same splits, logging under tmp_path."""
    from faceformer_tpu.data.dataset import ABCDataset as JaxDataset
    from faceformer_tpu.train.trainer import Harness as JaxHarness
    from faceformer_tpu_torch.config import config_from_dict
    from faceformer_tpu_torch.data.dataset import ABCDataset
    from faceformer_tpu_torch.train.trainer import Harness

    cfg = jax_cfg(model_cfg, mode, **trainer)
    names = {k: [f"json/{k}{i:03d}.json" for i in range(len(v))] for k, v in splits.items()}
    jh = JaxHarness(cfg, datasets={k: JaxDataset.from_samples(v, model_cfg, names[k])
                                   for k, v in splits.items()})
    pcfg = config_from_dict(config_to_dict(cfg))
    ph = Harness(pcfg, datasets={k: ABCDataset.from_samples(v, pcfg.model, names[k])
                                 for k, v in splits.items()}, device="cpu")
    jh.log_dir, ph.log_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    return jh, ph


def read_dir(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]
