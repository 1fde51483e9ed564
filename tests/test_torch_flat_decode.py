"""PyTorch port: the flat SurfaceFormer's greedy_decode_single against the
JAX package (CPU, fp32, tiny dims, direction-token labels): grids exactly
equal under both engines (reference, causal_cache), both stops
(retire_rows) and early stop, and a post-LN config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.packing import pack_input_edges as jax_pack_input_edges
from faceformer_tpu.decode import greedy_decode_single as jax_greedy_decode_single
from faceformer_tpu.models.common import encode as jax_encode
from faceformer_tpu_torch.decode import greedy_decode_single

from torch_flat_helpers import fitting_samples, flavor_cfg
from torch_port_helpers import (  # noqa: F401
    jax_params,
    port_model,
    port_model_cfg,
    torch_batch,
    torch_fp32_single_thread,
)


# -- greedy decode -------------------------------------------------------------------


@pytest.fixture(scope="module")
def decode_case(tiny_model_cfg):
    """Four direction-token wireframes and a tree whose pointer projection is
    tilted toward the EOS row of memory, so that some rows emit EOS early,
    one late and one never: every stop rule has something to decide."""
    cfg = flavor_cfg(tiny_model_cfg, "direction", label_seq_length=32)
    samples = fitting_samples(dataclasses.replace(cfg, label_seq_length=512), 4, seed=3,
                              flavor="direction")
    batch = collate([jax_pack_input_edges(s["edges"], cfg) for s in samples])
    tree = jax_params(cfg, seed=1, flat=True)
    memory, _, _ = jax_encode(jax.tree.map(jnp.asarray, tree), cfg, batch["input"],
                              batch["input_mask"], None)
    eos_row = np.asarray(memory[:, cfg.token.EOS]).mean(0)
    tree["project"]["b"] = (tree["project"]["b"]
                            + 2.0 * eos_row / np.linalg.norm(eos_row)).astype(np.float32)
    return cfg, batch, tree


@pytest.mark.parametrize("early_stop", [True, False], ids=["early-stop", "full-budget"])
@pytest.mark.parametrize("retire_rows", [True, False], ids=["retire", "eos-count"])
@pytest.mark.parametrize("mode", ["reference", "causal_cache"])
def test_greedy_decode_single_equals_jax(decode_case, mode, retire_rows, early_stop):
    cfg, batch, tree = decode_case
    want = np.asarray(jax_greedy_decode_single(
        jax.tree.map(jnp.asarray, tree), cfg, batch, mode=mode, early_stop=early_stop,
        retire_rows=retire_rows)["predict"])
    got = greedy_decode_single(port_model(cfg, tree, flat=True), port_model_cfg(cfg),
                               torch_batch(batch), mode=mode, early_stop=early_stop,
                               retire_rows=retire_rows)["predict"]
    assert got.dtype == torch.int32 and got.shape == (4, cfg.label_seq_length)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == cfg.token.EOS).any()


def test_greedy_decode_single_post_ln_equals_jax(decode_case):
    """A post-LN config decodes through the reference engine in both
    packages, whichever engine it asks for."""
    cfg, batch, tree = decode_case
    cfg = dataclasses.replace(cfg, normalize_before=False)
    model = port_model(cfg, tree, flat=True)
    want = np.asarray(jax_greedy_decode_single(jax.tree.map(jnp.asarray, tree), cfg, batch,
                                               mode="causal_cache")["predict"])
    for mode in ("causal_cache", "reference"):
        got = model.forward_eval(torch_batch(batch), mode=mode)["predict"]
        np.testing.assert_array_equal(got.numpy(), want)
