"""PyTorch port: the harness with the flat SurfaceFormer (direction-token
labels, as configs/synthetic-dirtok-big.yml) against the JAX package (CPU,
fp32, tiny dims, dropout 0): two epochs of fit, losses within 1e-5,
validated and checkpointed each epoch. Validate, test and the command
lines are in tests/test_torch_flat_cli.py."""

import os

import jax
import numpy as np

from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
from faceformer_tpu_torch.params import params_from_jax

from torch_flat_helpers import flat_model_cfg, harnesses, records, splits  # noqa: F401
from torch_port_helpers import torch_fp32_single_thread  # noqa: F401


def test_flat_fit_matches_jax(flat_model_cfg, splits, tmp_path):
    jh, ph = harnesses(flat_model_cfg, splits, tmp_path)
    state = jh.init_state()
    tree = jax.tree.map(np.asarray, state["params"])
    final = jh.fit(state)
    ours = ph.init_state()
    assert isinstance(ours["model"], SurfaceFormer)
    params_from_jax(ours["model"], tree)
    ours = ph.fit(ours)
    assert (ours["epoch"], ours["step"]) == (final["epoch"], final["step"]) == (2, 4)
    got = [(r["step"], r["train_loss"]) for r in records(ph.log_dir) if "train_loss" in r]
    want = [(r["step"], r["train_loss"]) for r in records(jh.log_dir) if "train_loss" in r]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], atol=1e-5)
    for log in (ph.log_dir, jh.log_dir):  # validated and checkpointed each epoch
        assert sum("valid_precision" in r for r in records(log)) == 2
    assert os.path.isfile(os.path.join(ph.log_dir, "checkpoints", "last"))
