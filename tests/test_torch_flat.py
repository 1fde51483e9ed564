"""PyTorch port: the flat SurfaceFormer against the JAX package (CPU, fp32,
tiny dims): single-sequence label packing (plain, nested and
direction-token faces), ABCDataset items, the parameter tree, the flash
kernels' plain versions past the CUDA kernels' whole-row reach, and the
flat parsers, filter_faces_by_coedge and FaceMetrics. The training pass is
in tests/test_torch_flat_train.py, the decode engines in
tests/test_torch_flat_decode.py; the CUDA kernels on this path are held
against these plain versions on the card in tests/test_torch_gpu.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.config import PostProcessConfig as JaxPostProcess
from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.dataset import ABCDataset as JaxDataset
from faceformer_tpu.data.packing import pack_label_single as jax_pack_label_single
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu.ops.flash import flash_attention as jax_flash_attention
from faceformer_tpu.post_processing import filter_faces_by_coedge as jax_filter_faces_by_coedge
from faceformer_tpu.train import metrics as jax_metrics
from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.data.dataset import ABCDataset
from faceformer_tpu_torch.data.packing import pack_label_single
from faceformer_tpu_torch.ops.flash import (
    flash_attention_bwd_plain,
    flash_attention_plain,
    padding_mask_bias,
)
from faceformer_tpu_torch.params import grads_to_numpy, params_from_jax, params_to_numpy
from faceformer_tpu_torch.post_processing import filter_faces_by_coedge
from faceformer_tpu_torch.train import metrics

from torch_flat_helpers import FLAVORS, fitting_samples, flavor_cfg
from torch_port_helpers import (  # noqa: F401
    jax_params,
    leaves,
    port_model,
    port_model_cfg,
    torch_fp32_single_thread,
)


# -- labels and dataset ---------------------------------------------------------


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_pack_label_single_equals_jax(tiny_model_cfg, flavor):
    cfg = flavor_cfg(tiny_model_cfg, flavor, label_seq_length=512)
    rng = np.random.default_rng(7)
    for _ in range(4):
        faces = random_sample(rng, **FLAVORS[flavor])["faces_indices"]
        ours = pack_label_single(faces, port_model_cfg(cfg))
        theirs = jax_pack_label_single(faces, cfg)
        assert ours.keys() == theirs.keys()
        for key in ("label", "label_mask"):
            assert ours[key].dtype == theirs[key].dtype
            np.testing.assert_array_equal(ours[key], theirs[key])
        assert ours["num_label"] == theirs["num_label"]
    short = dataclasses.replace(cfg, label_seq_length=8)
    for pack, c in ((pack_label_single, port_model_cfg(short)), (jax_pack_label_single, short)):
        with pytest.raises(ValueError, match="label sequence needs"):
            pack(faces, c)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_abc_dataset_items_equal_jax(tiny_model_cfg, flavor):
    cfg = flavor_cfg(tiny_model_cfg, flavor)
    samples = fitting_samples(cfg, 3, seed=1, flavor=flavor)
    ours = ABCDataset.from_samples(samples, port_model_cfg(cfg))
    theirs = JaxDataset.from_samples(samples, cfg)
    for i in range(len(samples)):
        assert ours[i].keys() == theirs[i].keys()
        for key, value in theirs[i].items():
            if isinstance(value, np.ndarray):
                assert ours[i][key].dtype == value.dtype, key
                np.testing.assert_array_equal(ours[i][key], value, err_msg=key)
            else:
                assert ours[i][key] == value, key
        assert ours[i] is ours[i]  # memoized


def test_flat_param_tree_round_trips(tiny_model_cfg):
    cfg = flavor_cfg(tiny_model_cfg, "direction")
    tree = jax_params(cfg, seed=2, flat=True)
    model = port_model(cfg, tree, flat=True)
    assert model.query_pos_table.shape == (cfg.label_seq_length, cfg.num_model)
    mine, theirs = dict(leaves(params_to_numpy(model))), dict(leaves(tree))
    assert len(mine) == len(theirs) == 55  # layer leaves stacked, as in the JAX tree
    for name, value in theirs.items():
        np.testing.assert_array_equal(mine[name], value, err_msg=name)
    assert dict(leaves(grads_to_numpy(model))).keys() == theirs.keys()
    with pytest.raises(ValueError, match="query_pos_table"):  # the parallel model's table
        params_from_jax(port_model(cfg, jax_params(cfg, seed=2)), tree)


# -- the flash kernels' plain versions past the whole-row reach -------------------------


@pytest.mark.parametrize("sq,causal", [(520, True), (40, False)])
def test_plain_flash_long_keys_match_pallas(sq, causal):
    """Sk = 520: past what the CUDA kernels stage whole at hd = 64 (K2 fp32
    420 keys, K3 391), where the card runs their key-tiled forms; the plain
    versions those are held against agree with the JAX kernel."""
    sk = 520
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, sq, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, 2, 16)).astype(np.float32) for _ in range(2))
    pad = np.zeros((1, sk), bool)
    pad[:, 509:] = True
    bias = padding_mask_bias(torch.as_tensor(pad))

    def loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, jnp.asarray(bias.numpy()), causal=causal,
                                  interpret=True)
        return jnp.sum(jnp.sin(out)), out

    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, bias, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)
    grads = flash_attention_bwd_plain(tq, tk, tv, bias, lse, torch.cos(out), causal)
    for a, b, name in zip(grads, grads_j, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5, err_msg=name)


# -- parsers, post-processing and metrics ----------------------------------------------


def corrupted(labels, rng, rate=0.05):
    predicts = labels.copy()
    flip = rng.random(labels.shape) < rate
    predicts[flip] = rng.integers(0, labels.max() + 1, int(flip.sum()))
    return predicts


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_flat_parsers_equal_jax(tiny_model_cfg, flavor):
    cfg = flavor_cfg(tiny_model_cfg, flavor)
    samples = fitting_samples(cfg, 4, seed=4, flavor=flavor)
    labels = collate([JaxDataset.from_samples(samples, cfg)[i] for i in range(4)])["label"]
    predicts = corrupted(np.asarray(labels), np.random.default_rng(4))
    port_tok = port_model_cfg(cfg).token
    for name in ("parse_faces", "parse_directed_faces"):
        for i, sample in enumerate(samples):
            args = (predicts[i], np.asarray(labels[i]), len(sample["edges"]))
            assert (getattr(metrics, name)(*args, port_tok)
                    == getattr(jax_metrics, name)(*args, cfg.token)), (name, i)


@pytest.mark.parametrize("flavor,post", [
    ("combined", dict(is_coedge=False)), ("nested", dict(is_coedge=True)),
    ("direction", dict(is_coedge=False, direction_token=True))])
def test_flat_face_metrics_equal_jax(tiny_model_cfg, flavor, post):
    cfg = flavor_cfg(tiny_model_cfg, flavor)
    samples = fitting_samples(cfg, 4, seed=5, flavor=flavor)
    labels = np.asarray(collate([JaxDataset.from_samples(samples, cfg)[i]
                                 for i in range(4)])["label"])
    predicts = corrupted(labels, np.random.default_rng(5))
    predicts[0] = labels[0]  # one perfect row
    valid = [True, True, False, True]
    want = jax_metrics.FaceMetrics(JaxPostProcess(**post), cfg.token).evaluate_batch(
        predicts, labels, samples, valid)
    pcfg = config_from_dict({"model": {"token": dataclasses.asdict(cfg.token)},
                             "post_process": post})
    got = metrics.FaceMetrics(pcfg.post_process, pcfg.model.token).evaluate_batch(
        predicts, labels, samples, valid)
    assert got == want
    assert got["precision"][0] == got["recall"][0] == 1.0 and len(got["precision"]) == 3


def test_direction_token_hallucination_tolerance_equals_jax(tiny_model_cfg):
    """A DIR token turned into an edge pointer leaves a malformed stream:
    that face is dropped, not a crash (tests/test_direction_token.py)."""
    cfg = flavor_cfg(tiny_model_cfg, "direction")
    samples = fitting_samples(cfg, 1, seed=6, flavor="direction")
    label = np.asarray(JaxDataset.from_samples(samples, cfg)[0]["label"])
    pred = label.copy()
    pred[np.where((pred == 4) | (pred == 5))[0][0]] = cfg.token.length + 1
    post = dict(is_coedge=False, direction_token=True)
    want = jax_metrics.FaceMetrics(JaxPostProcess(**post), cfg.token).evaluate_batch(
        pred[None], label[None], samples, [True])
    pcfg = config_from_dict({"model": {"token": dataclasses.asdict(cfg.token)},
                             "post_process": post})
    got = metrics.FaceMetrics(pcfg.post_process, pcfg.model.token).evaluate_batch(
        pred[None], label[None], samples, [True])
    assert got == want
    assert got["recall"][0] < 1.0 and 0.0 <= got["precision"][0] <= 1.0


def test_filter_faces_by_coedge_equals_jax():
    rng = np.random.default_rng(9)
    for _ in range(3):
        sample = random_sample(rng)  # coedge loops with face types and pairings
        pairings = {int(k): v for k, v in sample["pairings"].items()}
        faces = [(int(t), loops) for t, loops in sample["faces_indices"]]
        faces = faces + faces[:2]  # repeated faces reuse claimed edges
        got = filter_faces_by_coedge(pairings, faces)
        assert got == jax_filter_faces_by_coedge(pairings, faces)
        assert len(got) < len(faces)
