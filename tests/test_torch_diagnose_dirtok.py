"""The port's direction-token diagnosis
(faceformer_tpu_torch/tools/diagnose_dirtok.py) against the root
tools/diagnose_dirtok.py: both tools on the same weights (a tiny flat
direction-token model fitted for a few JAX steps) over the same test split
in fp32 give the same counts; the counting function on planted grids;
no quiet CPU run without a card; and chip_smoke.py [6]'s planted counts on
the CPU."""

import functools
import importlib.util
import json
import os
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from faceformer_tpu.config import load_config as jax_load_config
from faceformer_tpu.data.batching import iter_batches
from faceformer_tpu.parallel.mesh import shard_batch
from faceformer_tpu.tools.synthetic_data import generate
from faceformer_tpu.train.trainer import Harness as JaxHarness
from faceformer_tpu_torch.config import TokenConfig
from faceformer_tpu_torch.tools import diagnose_dirtok
from faceformer_tpu_torch.train.checkpoint import export_torch_state_dict
from tools import diagnose_dirtok as jax_diagnose_dirtok

from torch_port_helpers import torch_fp32_single_thread  # noqa: F401

CONFIG = """\
model_class: 'SurfaceFormer'
dataset_class: 'ABCDataset'
root_dir: "{root}"
batch_size_train: 4
batch_size_valid: 4
trainer:
  name: 'dirtok'
  version: 'v0'
  num_devices: 1
  lr: 1.0e-3
  max_epochs: 7
  checkpoint_period: 100
  precision: 'fp32'
model:
  num_points_per_line: 8
  num_lines: 40
  label_seq_length: 96
  num_model: 64
  num_head: 4
  num_feedforward: 128
  num_encoder_layers: 2
  num_decoder_layers: 2
  dropout: 0.0
  token:
    DIR0: 4
    DIR1: 5
    length: 6
post_process:
  is_coedge: False
  direction_token: True
decode:
  mode: 'causal_cache'
  precision: 'fp32'
"""
TOK = TokenConfig(DIR0=4, DIR1=5, length=6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4  # PostProcessConfig.enclosedness_tol
STEPS = 42  # JAX Adam steps (7 epochs of 6): enough for the model to emit faces


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """(config path, .ckpt path, work directory): a 32-solid direction-token
    corpus, and the tiny model JAX's train step took STEPS Adam steps on
    (the batches of its fit, without its logger and checkpoints), written
    as a reference Lightning checkpoint that both packages load."""
    tmp = tmp_path_factory.mktemp("dirtok")
    root = tmp / "data"
    generate(str(root), num=32, seed=3, direction_token=True, max_edges=40,
             max_label_len=92, split=(0.75, 0.0625, 0.1875))
    yml = tmp / "dirtok.yml"
    yml.write_text(CONFIG.format(root=root))
    harness = JaxHarness(jax_load_config(str(yml)))
    cfg, state = harness.cfg, harness.init_state()
    params, opt_state, step_fn = state["params"], state["opt_state"], harness.train_step()
    rng = jax.random.key(cfg.trainer.seed + 1)
    step = epoch = 0
    while step < STEPS:
        for b in iter_batches(harness.dataset("train"), cfg.batch_size_train, shuffle=True,
                              drop_last=True, seed=cfg.trainer.seed, epoch=epoch):
            rng, sub = jax.random.split(rng)
            batch = shard_batch({k: v for k, v in b.items() if not isinstance(v, (list, str))},
                                harness.mesh)
            params, opt_state, _, _ = step_fn(params, opt_state, batch, sub)
            step += 1
        epoch += 1
    sd = export_torch_state_dict(jax.tree.map(np.asarray, params))
    blob = {"epoch": epoch, "global_step": step, "pytorch-lightning_version": "1.3.5",
            "state_dict": OrderedDict((k, torch.tensor(v)) for k, v in sd.items()),
            "callbacks": {}, "optimizer_states": [], "lr_schedulers": []}
    ckpt = tmp / "fitted.ckpt"
    torch.save(blob, str(ckpt))
    return str(yml), str(ckpt), tmp


def test_counts_equal_the_jax_tool(fitted, torch_fp32_single_thread, capsys):  # noqa: F811
    yml, ckpt, tmp = fitted
    jax_out, port_out = str(tmp / "jax.json"), str(tmp / "port.json")
    jax_diagnose_dirtok.main(["--ckpt", ckpt, "--config", yml, "--batch", "4",
                              "--out", jax_out])
    jax_lines = capsys.readouterr().out.splitlines()
    got = diagnose_dirtok.main(["--ckpt", ckpt, "--config", yml, "--batch", "4",
                                "--out", port_out, "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    want = json.load(open(jax_out))[-1]
    assert set(got) == set(want)
    for key in (*diagnose_dirtok.COUNT_KEYS, "filter_drop_rate", "note", "ckpt", "config"):
        assert got[key] == want[key], key
    assert got["samples"] == 6 and got["label"] > 0 and got["pred_raw"] > 0
    # the same printed key: value lines, in the same order
    assert [line.split(":")[0] for line in port_lines] == [
        line.split(":")[0] for line in jax_lines]
    # --out appends to the list the file holds
    diagnose_dirtok.main(["--ckpt", ckpt, "--config", yml, "--batch", "4",
                          "--out", port_out, "--device", "cpu"])
    runs = json.load(open(port_out))
    assert len(runs) == 2
    assert all(r[k] == got[k] for r in runs for k in diagnose_dirtok.COUNT_KEYS)


@functools.lru_cache(maxsize=None)
def smoke_module():
    """chip_smoke.py as a module (its helpers run on the CPU)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def plant(labels):
    """chip_smoke.py's planted_rows: the first pair's direction bit flipped
    and the last face cut off, a slip and a skipped face a row."""
    return smoke_module().planted_rows(labels, TOK)


def test_planted_decodes_count_alike_in_both_tools(fitted, monkeypatch):
    """Both tools with their decode replaced by ``plant`` of the batch's
    labels: the same counts, with faces kept, dropped and skipped."""
    from faceformer_tpu.train import trainer as jax_trainer

    yml, ckpt, tmp = fitted
    monkeypatch.setattr(jax_trainer.Harness, "decode_fn",
                        lambda self: lambda params, batch: plant(batch["label"]))
    monkeypatch.setattr(diagnose_dirtok, "decode_grid",
                        lambda model, cfg, batch: torch.from_numpy(plant(batch["label"].numpy())))
    jax_out = str(tmp / "planted.json")
    jax_diagnose_dirtok.main(["--ckpt", ckpt, "--config", yml, "--batch", "4",
                              "--out", jax_out])
    got = diagnose_dirtok.main(["--ckpt", ckpt, "--config", yml, "--batch", "4",
                                "--device", "cpu"])
    want = json.load(open(jax_out))[-1]
    assert {k: got[k] for k in diagnose_dirtok.COUNT_KEYS} == {
        k: want[k] for k in diagnose_dirtok.COUNT_KEYS}
    assert got["label"] - got["pred_raw"] == got["samples"]  # one face skipped a row
    assert 0 < got["pred_kept"] < got["pred_raw"]
    assert got["dropped_but_matches_label"] > 0
    assert got["kept_matches_label"] == got["pred_kept"]


# -- planted grids through the counting function ---------------------------------------

# a unit square (edges 0-3, counter-clockwise) beside a second one (edges 4-7)
SQUARE = [[[0, 0], [1, 0]], [[1, 0], [1, 1]], [[1, 1], [0, 1]], [[0, 1], [0, 0]]]
RAW = {"edges": SQUARE + [[[x + 2, y] for x, y in e] for e in SQUARE]}
FACES = [[(0, 0), (1, 0), (2, 0), (3, 0)], [(4, 0), (5, 0), (6, 0), (7, 0)]]


def grid(faces, length=40):
    """A flat direction-token row: SOS, [edge, DIR] pairs, SEP between faces, EOS, PAD."""
    row = [TOK.SOS]
    for face in faces:
        for e, o in face:
            row += [e + TOK.length, TOK.DIR0 + o]
        row.append(TOK.SEP)
    row[-1] = TOK.EOS
    return np.asarray(row + [TOK.PAD] * (length - len(row)), dtype=np.int64)


def test_label_grid_passed_back_keeps_every_face():
    counts = diagnose_dirtok.count_sample(grid(FACES), grid(FACES), RAW, TOK, TOL)
    assert counts == {"samples": 1, "pred_raw": 2, "pred_kept": 2, "label": 2,
                      "dropped_but_matches_label": 0, "kept_matches_label": 2}


def test_flipped_direction_bit_is_dropped_but_matches_the_label():
    flipped = [list(FACES[0]), FACES[1]]
    flipped[0][1] = (1, 1)
    counts = diagnose_dirtok.count_sample(grid(flipped), grid(FACES), RAW, TOK, TOL)
    assert counts["pred_raw"] == 2 and counts["pred_kept"] == 1
    assert counts["dropped_but_matches_label"] == 1 and counts["kept_matches_label"] == 1


def test_skipped_face_lowers_pred_raw_and_drops_nothing():
    counts = diagnose_dirtok.count_sample(grid(FACES[1:]), grid(FACES), RAW, TOK, TOL)
    assert counts == {"samples": 1, "pred_raw": 1, "pred_kept": 1, "label": 2,
                      "dropped_but_matches_label": 0, "kept_matches_label": 1}


def test_no_card_raises_without_device_cpu(fitted):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    yml, ckpt, _ = fitted
    with pytest.raises(RuntimeError, match="no CUDA card"):
        diagnose_dirtok.main(["--ckpt", ckpt, "--config", yml])


def test_chip_smoke_planted_counts_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py [6]'s planted_counts on a 16-solid corpus of the
    direction-token recipe's generator flags: label rows keep every face,
    the planted rows drop one face a row that still matches its label; a
    counting function that skips the filter fails it."""
    from faceformer_tpu_torch.tools import synthetic_data

    failures = []
    smoke = smoke_module()
    monkeypatch.setattr(smoke, "fail", failures.append)
    root = str(tmp_path / "syn")
    synthetic_data.generate(root, num=16, seed=3, profile="rich", direction_token=True,
                            max_edges=110, max_faces=42, max_label_len=508,
                            split=(0.5, 0.25, 0.25))
    got = smoke.planted_counts(root, device="cpu")
    assert failures == []
    label, planted = got["label"], got["planted"]
    assert label["samples"] == planted["samples"] == 4
    assert label["pred_kept"] == label["kept_matches_label"] == label["label"] > 0
    assert planted["pred_raw"] == label["label"] - 4
    assert planted["dropped_but_matches_label"] == planted["pred_raw"] - planted["pred_kept"] > 0

    monkeypatch.setattr(diagnose_dirtok, "filter_faces_by_encloseness_batch",
                        lambda edges, faces, tol: [(t, [pairs]) for t, pairs in faces])
    smoke.planted_counts(root, device="cpu")
    assert len(failures) == 1 and "planted rows" in failures[0]
