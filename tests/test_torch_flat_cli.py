"""PyTorch port: validate, test and the command lines with the flat
SurfaceFormer (direction-token labels, as configs/synthetic-dirtok-big.yml)
against the JAX package (CPU, fp32, tiny dims, dropout 0): validate and
test results and prediction JSONs under every decode mode (``fused`` is
causal_cache for this model in both packages), and a reference Lightning
checkpoint of the flat model through both command lines and
``tools.predict``."""

import json
import os
import sys
from collections import OrderedDict

import jax
import jax.numpy as jnp
import pytest
import torch

from faceformer_tpu.tools.synthetic_data import generate
from faceformer_tpu_torch import main as port_main
from faceformer_tpu_torch.params import params_from_jax
from faceformer_tpu_torch.tools import predict as port_predict
from faceformer_tpu_torch.train.checkpoint import export_torch_state_dict

from torch_flat_helpers import flat_model_cfg, harnesses, read_dir, splits  # noqa: F401
from torch_port_helpers import jax_params, torch_fp32_single_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["reference", "causal_cache", "fused"])
def test_flat_validate_and_test_match_jax(flat_model_cfg, splits, tmp_path, mode):
    jh, ph = harnesses(flat_model_cfg, splits, tmp_path, mode)
    tree = jax_params(flat_model_cfg, seed=4, flat=True)
    state = ph.init_state()
    params_from_jax(state["model"], tree)
    params = jax.tree.map(jnp.asarray, tree)
    assert ph.validate(state["model"]) == jh.validate(params)
    want_test = jh.test(params)
    got_test = ph.test(state["model"])
    for key in ("test_precision", "test_recall", "test_type_acc", "num_samples"):
        assert got_test[key] == want_test[key], key
    ours, theirs = (read_dir(os.path.join(h.log_dir, "json")) for h in (ph, jh))
    assert len(ours) == len(splits["test"])
    assert ours == theirs


CONFIG_TEMPLATE = """\
model_class: 'SurfaceFormer'
dataset_class: 'ABCDataset'
root_dir: "{root}"
batch_size_train: 4
batch_size_valid: 4
trainer:
  name: 'flat'
  version: 'v0'
  num_devices: 1
  precision: 'fp32'
model:
  num_points_per_line: {p}
  num_lines: {lines}
  label_seq_length: {tlabel}
  num_model: {e}
  num_head: {h}
  num_feedforward: {ffn}
  num_encoder_layers: {enc}
  num_decoder_layers: {dec}
  dropout: 0.0
  token:
    DIR0: 4
    DIR1: 5
    length: 6
post_process:
  is_coedge: False
  direction_token: True
decode:
  mode: 'fused'
  precision: 'fp32'
"""


def test_flat_lightning_ckpt_through_both_command_lines(tmp_path, monkeypatch,
                                                        flat_model_cfg):
    cfg = flat_model_cfg
    root = tmp_path / "data"
    generate(str(root), num=10, seed=3, direction_token=True, max_edges=cfg.num_lines,
             max_label_len=cfg.label_seq_length - 4, split=(0.5, 0.2, 0.3))
    yml = tmp_path / "flat.yml"
    yml.write_text(CONFIG_TEMPLATE.format(
        root=str(root), p=cfg.num_points_per_line, lines=cfg.num_lines,
        tlabel=cfg.label_seq_length, e=cfg.num_model, h=cfg.num_head,
        ffn=cfg.num_feedforward, enc=cfg.num_encoder_layers, dec=cfg.num_decoder_layers))
    sd = export_torch_state_dict(jax_params(cfg, seed=5, flat=True))
    assert sd["model.query_pos_enc.pos_embed.weight"].shape == (cfg.label_seq_length,
                                                                cfg.num_model)
    blob = {"epoch": 3, "global_step": 321, "pytorch-lightning_version": "1.3.5",
            "state_dict": OrderedDict((k, torch.tensor(v)) for k, v in sd.items()),
            "callbacks": {}, "optimizer_states": [], "lr_schedulers": []}
    ckpt = tmp_path / "epoch=3-valid_precision=0.5000.ckpt"
    torch.save(blob, str(ckpt))

    import main as jax_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["main.py", "--config-file", str(yml), "--test_ckpt",
                                      str(ckpt), "trainer.version", "jax"])
    jax_main.main()
    port_main.main(["--config-file", str(yml), "--test_ckpt", str(ckpt), "--device", "cpu",
                    "trainer.version", "port"])
    ours, theirs = (read_dir(tmp_path / "logs" / "flat" / v / "json") for v in ("port", "jax"))
    assert len(ours) == 3
    assert ours == theirs
    results = [json.load(open(tmp_path / "logs" / "flat" / v / "results.json"))
               for v in ("port", "jax")]
    for key in ("test_precision", "test_recall", "test_type_acc", "num_samples"):
        assert results[0][key] == results[1][key]

    port_predict.main(["--config", str(yml), "--ckpt", str(ckpt), "--root", str(root),
                       "--out", str(tmp_path / "pred"), "--device", "cpu"])
    preds = read_dir(tmp_path / "pred" / "json")
    assert len(preds) == 10
    for name, data in ours.items():  # the test split's faces again
        assert json.loads(preds[name])["pred_faces"] == json.loads(data)["pred_faces"]
