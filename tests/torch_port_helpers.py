"""Shared setup for the PyTorch port's parity tests (tests/test_torch_*.py).

The port (faceformer_tpu_torch) is held against the JAX package in fp32 on
the CPU: the same seeded numpy inputs and the same JAX-initialised
parameter tree go to both sides.
"""

import jax
import numpy as np
import pytest
import torch

from faceformer_tpu.config import config_to_dict
from faceformer_tpu.data.batching import collate
from faceformer_tpu.data.dataset import ABCDatasetParallel
from faceformer_tpu.geometry.fixtures import build_sample, make_box, make_prism
from faceformer_tpu.models.parallel import SurfaceFormerParallel as JaxParallel
from faceformer_tpu.models.surfaceformer import SurfaceFormer as JaxFlat
from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
from faceformer_tpu_torch.params import params_from_jax


@pytest.fixture(autouse=True)
def torch_fp32_single_thread():
    """Exact fp32 products, one thread per xdist worker."""
    threads, precision = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def port_model_cfg(jax_model_cfg):
    """The port's ModelConfig with the same values as a JAX one."""
    return config_from_dict({"model": config_to_dict(jax_model_cfg)}).model


AFFINE_LEAVES = ("b", "bq", "bk", "bv", "bo", "scale", "bias")


def jax_params(cfg, seed: int = 0, jitter: float = 0.1, flat: bool = False):
    """A JAX-initialised parameter tree, as numpy arrays, with N(0, jitter)
    noise added to every bias and every LayerNorm scale and bias. The init
    leaves attention biases at 0 and LayerNorms at the identity, so without
    the noise a port that dropped or misread one of them would still
    agree. ``flat`` gives the flat SurfaceFormer's tree (a query_pos_table
    of label_seq_length rows), else the anchor-parallel model's."""
    model = JaxFlat if flat else JaxParallel
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def jitter_(node):
        for key, value in node.items():
            if isinstance(value, dict):
                jitter_(value)
            elif key in AFFINE_LEAVES:
                node[key] = (value + rng.normal(0.0, jitter, value.shape)).astype(value.dtype)

    jitter_(tree)
    return tree


def port_model(jax_model_cfg, tree, flat: bool = False):
    """The port's model on the CPU, loaded with a JAX tree: the flat
    SurfaceFormer with ``flat``, else SurfaceFormerParallel."""
    cls = SurfaceFormer if flat else SurfaceFormerParallel
    model = cls(port_model_cfg(jax_model_cfg), device="cpu")
    params_from_jax(model, tree)
    return model


def torch_batch(batch):
    """numpy arrays -> CPU tensors (list/str fields dropped)."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()
            if not isinstance(v, (list, str))}


def fixture_batch(cfg):
    """A training batch of two fixture solids (a box and a prism), packed by
    the JAX package's dataset, as numpy arrays."""
    samples = [build_sample(make_box(), theta=25.0, phi=45.0),
               build_sample(make_prism(), theta=35.0, phi=20.0)]
    ds = ABCDatasetParallel.from_samples(samples, cfg)
    return collate([ds[0], ds[1]])


def leaves(tree, path=()):
    """(slash-joined path, leaf) pairs of a nested dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, path + (key,))
        else:
            yield "/".join(path + (key,)), value
