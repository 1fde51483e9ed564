"""PyTorch port: the harness, checkpoints and command lines against the JAX
package (CPU, fp32, tiny dims, dropout 0): fit losses and parameters, the
lag-1 fit's logged losses with NaN steps, validate and test results and
prediction JSONs under every decode engine, the checkpoint manager's rules,
resume, and a reference Lightning checkpoint through both command lines."""

import json
import os
import sys
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu import ops as jax_ops
from faceformer_tpu.config import Config, DecodeConfig, TrainerConfig, config_to_dict
from faceformer_tpu.data.dataset import ABCDatasetParallel as JaxDataset
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu.tools.synthetic_data import generate
from faceformer_tpu.train import checkpoint as jax_checkpoint
from faceformer_tpu.train.trainer import Harness as JaxHarness
from faceformer_tpu_torch import main as port_main
from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.data.dataset import ABCDatasetParallel
from faceformer_tpu_torch.parallel.mesh import make_mesh
from faceformer_tpu_torch.params import params_from_jax, params_to_numpy
from faceformer_tpu_torch.tools import predict as port_predict
from faceformer_tpu_torch.train.checkpoint import (
    CheckpointManager,
    convert_torch_state_dict,
    export_torch_state_dict,
    load_checkpoint,
)
from faceformer_tpu_torch.train.trainer import Harness

from torch_port_helpers import jax_params, leaves, torch_fp32_single_thread  # noqa: F401


def jax_cfg(model_cfg, mode="causal_cache", **trainer):
    return Config(
        model_class="SurfaceFormer_Parallel", dataset_class="ABCDataset_Parallel",
        batch_size_train=4, batch_size_valid=4, model=model_cfg,
        trainer=TrainerConfig(**{"name": "h", "version": "v0", "lr": 1e-4,
                                 "checkpoint_period": 1, "precision": "fp32",
                                 "num_devices": 1, "max_epochs": 2, **trainer}),
        decode=DecodeConfig(mode=mode, precision="fp32"))


def port_cfg(cfg):
    return config_from_dict(config_to_dict(cfg))


@pytest.fixture(scope="module")
def splits():
    rng = np.random.default_rng(11)
    samples = [random_sample(rng) for _ in range(14)]
    return {"train": samples[:8], "valid": samples[8:11], "test": samples[11:]}


def harnesses(model_cfg, splits, tmp_path, mode="causal_cache", **trainer):
    cfg = jax_cfg(model_cfg, mode, **trainer)
    names = {k: [f"json/{k}{i:03d}.json" for i in range(len(v))] for k, v in splits.items()}
    jh = JaxHarness(cfg, datasets={k: JaxDataset.from_samples(v, model_cfg, names[k])
                                   for k, v in splits.items()})
    pcfg = port_cfg(cfg)
    ph = Harness(pcfg, datasets={k: ABCDatasetParallel.from_samples(v, pcfg.model, names[k])
                                 for k, v in splits.items()}, device="cpu")
    jh.log_dir, ph.log_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    return jh, ph


def read_dir(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_matches_jax(tiny_model_cfg, splits, tmp_path):
    lr = 1e-4
    jh, ph = harnesses(tiny_model_cfg, splits, tmp_path, lr=lr)
    state = jh.init_state()
    tree = jax.tree.map(np.asarray, state["params"])
    final = jh.fit(state)
    ours = ph.init_state()
    params_from_jax(ours["model"], tree)
    ours = ph.fit(ours)
    assert (ours["epoch"], ours["step"]) == (final["epoch"], final["step"]) == (2, 4)

    got = [(r["step"], r["train_loss"]) for r in records(ph.log_dir) if "train_loss" in r]
    want = [(r["step"], r["train_loss"]) for r in records(jh.log_dir) if "train_loss" in r]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], atol=1e-5)
    for log in (ph.log_dir, jh.log_dir):  # validated and checkpointed each epoch
        assert sum("valid_precision" in r for r in records(log)) == 2
    index = [json.load(open(os.path.join(h.log_dir, "checkpoints", "index.json")))
             for h in (ph, jh)]
    assert ([os.path.basename(e[1]) for e in index[0]["top"]]
            == [os.path.basename(e[1]) for e in index[1]["top"]])

    # Adam divides by the root of the second moment, so where a gradient is
    # as small as the two frameworks' summation noise the update's direction
    # is noise too (test_torch_step.py): every entry within 10 lr, most
    # within 1e-5
    close = total = 0
    mine = dict(leaves(params_to_numpy(ours["model"])))
    for name, want in leaves(jax.tree.map(np.asarray, final["params"])):
        np.testing.assert_allclose(mine[name], want, atol=10 * lr, err_msg=name)
        close += int((np.abs(mine[name] - want) <= 1e-5).sum())
        total += want.size
    assert close > 0.9 * total


# the lag-1 fit: a NaN step in each of two epochs (the sixth train sample
# poisoned, two steps of four rows an epoch), logged every step and every
# second one (then each epoch's last step alone, flushed before validation)
LOG_EVERY = (1, 2)


def poison_train(harness):
    """The harness's train split with a NaN in its sixth sample's input."""
    ds = harness.dataset("train")
    train = [ds[i] for i in range(len(ds))]
    train[5] = dict(train[5], input=np.array(train[5]["input"], copy=True))
    train[5]["input"].flat[0] = np.nan
    harness._datasets["train"] = train


@pytest.fixture(scope="module")
def jax_lag1_runs(tiny_model_cfg, splits, tmp_path_factory):
    """The JAX harness's fit at each of LOG_EVERY from one initial tree,
    its step and decode compiled once for both."""
    runs, first = {}, None
    for every in LOG_EVERY:
        jh, _ = harnesses(tiny_model_cfg, splits, tmp_path_factory.mktemp(f"lag{every}"),
                          lr=1e-3, checkpoint_period=2, log_every_n_steps=every)
        poison_train(jh)
        if first is None:
            first = jh
            tree = jax.tree.map(np.asarray, jh.init_state()["params"])
        else:
            jh._train_step, jh._decode_fn = first._train_step, first._decode_fn
        jh.fit(jh.init_state())
        runs[every] = records(jh.log_dir)
    return tree, runs


@pytest.mark.parametrize("every", LOG_EVERY)
def test_lag1_logged_pairs_with_nan_steps_match_jax(tiny_model_cfg, splits, tmp_path,
                                                    jax_lag1_runs, every):
    tree, runs = jax_lag1_runs
    _, ph = harnesses(tiny_model_cfg, splits, tmp_path, lr=1e-3, checkpoint_period=2,
                      log_every_n_steps=every)
    poison_train(ph)
    state = ph.init_state()
    params_from_jax(state["model"], tree)
    ph.fit(state)
    got = [(r["step"], r["train_loss"]) for r in records(ph.log_dir) if "train_loss" in r]
    want = [(r["step"], r["train_loss"]) for r in runs[every] if "train_loss" in r]
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(every, 5, every))
    assert [x is None for _, x in got] == [x is None for _, x in want]  # NaN logs as null
    if every == 1:
        assert sum(x is None for _, x in got) == 2  # a NaN step an epoch
    np.testing.assert_allclose([x for _, x in got if x is not None],
                               [x for _, x in want if x is not None], atol=1e-5)
    # each epoch's seconds split: the host's in the batches and in queueing
    # the steps, the steps' span (the host's clock on the CPU)
    timing = [r for r in records(ph.log_dir) if "epoch_train_seconds" in r]
    assert len(timing) == 2
    for r in timing:
        for key in ("train_host_batch_seconds", "train_host_dispatch_seconds",
                    "train_step_span_seconds"):
            assert 0.0 < r[key] <= r["epoch_train_seconds"], key


@pytest.mark.parametrize("n", [0, 1, 5])
def test_prefetch_uploads_one_batch_ahead(n):
    """The fit's lookahead-1 upload hands out every batch in order, and
    uploads the next batch before it hands out the current one."""
    from faceformer_tpu_torch.train.trainer import _prefetch_to_device

    uploaded = []

    def put(b):
        uploaded.append(b)
        return b * 10

    got = []
    for item in _prefetch_to_device(range(n), put):
        got.append(item)
        assert len(uploaded) == min(len(got) + 1, n)
    assert got == [10 * b for b in range(n)] and uploaded == list(range(n))


@pytest.mark.parametrize("mode", ["reference", "causal_cache", "fused"])
def test_validate_and_test_match_jax(tiny_model_cfg, splits, tmp_path, mode):
    jh, ph = harnesses(tiny_model_cfg, splits, tmp_path, mode)
    tree = jax_params(tiny_model_cfg, seed=4)
    state = ph.init_state()
    params_from_jax(state["model"], tree)
    params = jax.tree.map(jnp.asarray, tree)
    if mode == "fused":
        jax_ops.enable(True)  # JAX's fused engine runs its Pallas kernel (interpreted)
    try:
        want_valid = jh.validate(params)
        want_test = jh.test(params)
    finally:
        jax_ops.enable(None)
    assert ph.validate(state["model"]) == want_valid
    got_test = ph.test(state["model"])
    for key in ("test_precision", "test_recall", "test_type_acc", "num_samples"):
        assert got_test[key] == want_test[key], key
    ours, theirs = read_dir(os.path.join(ph.log_dir, "json")), read_dir(
        os.path.join(jh.log_dir, "json"))
    assert len(ours) == len(splits["test"])
    assert ours == theirs
    with open(os.path.join(ph.log_dir, "results.json")) as f:
        assert json.load(f) == got_test


def test_evaluate_batch_equals_jax(tiny_model_cfg, splits):
    """Per-sample metrics, faces and the token accuracy (its row-pairing
    quirk included) over a batch with a padded sample."""
    from faceformer_tpu.config import PostProcessConfig
    from faceformer_tpu.data.batching import collate
    from faceformer_tpu.train.metrics import FaceMetrics as JaxMetrics
    from faceformer_tpu_torch.train.metrics import FaceMetrics

    ds = JaxDataset.from_samples(splits["train"][:3], tiny_model_cfg)
    batch = collate([ds[0], ds[1], ds[2]])
    labels = np.asarray(batch["label"])
    rng = np.random.default_rng(2)
    predicts = labels.copy()
    flip = rng.random(labels.shape) < 0.05
    predicts[flip] = rng.integers(0, labels.max() + 1, int(flip.sum()))
    valid = np.array([True, False, True])
    want = JaxMetrics(PostProcessConfig(), tiny_model_cfg.token).evaluate_batch(
        predicts, labels, ds.raw_datas, valid)
    got = FaceMetrics(port_cfg(Config()).post_process, port_cfg(Config()).model.token
                      ).evaluate_batch(predicts, labels, ds.raw_datas, valid)
    assert got == want
    assert len(got["precision"]) == 2 and 0.0 < got["token_accuracy"] < 1.0


def test_resume_runs_the_remaining_epochs(tiny_model_cfg, splits, tmp_path):
    _, ph = harnesses(tiny_model_cfg, splits, tmp_path, max_epochs=1)
    ph.fit()
    last = os.path.join(ph.log_dir, "checkpoints", "last")
    state = ph.load(last)
    again = ph.load(last)
    for key, value in state["model"].state_dict().items():
        assert torch.equal(value, again["model"].state_dict()[key])
    assert (state["epoch"], state["step"]) == (1, 2)
    assert state["optimizer"].state_dict()["state"][0]["step"] == 2
    n_before = len(records(ph.log_dir))
    ph.fit(state, max_epochs=3)
    steps = [r["step"] for r in records(ph.log_dir)[n_before:] if "train_loss" in r]
    assert steps == [3, 4, 5, 6]
    tree, meta = load_checkpoint(last)
    assert (tree["epoch"], tree["step"], meta["epoch"]) == (3, 6, 3)
    assert meta["config"]["trainer"]["max_epochs"] == 1


def test_harness_refuses_what_is_not_ported(tiny_model_cfg):
    cfg = port_cfg(jax_cfg(tiny_model_cfg))
    # ranks and the model axis are ported (tests/test_torch_parallel.py,
    # test_torch_tensor_parallel.py); make_mesh holds JAX's rule on the axis
    with pytest.raises(ValueError, match="not divisible by model_axis=2"):
        make_mesh(3, "cpu", model_axis=2)
    assert make_mesh(1, "cpu", model_axis=1).size == 1
    # the flat SurfaceFormer is ported now: the harness builds it
    flat = Harness(config_from_dict({**config_to_dict(cfg), "model_class": "SurfaceFormer",
                                     "dataset_class": "ABCDataset"}), device="cpu")
    assert type(flat.init_state()["model"]).__name__ == "SurfaceFormer"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Harness(cfg)  # the card is the default


def test_state_dict_converters_equal_jax(tiny_model_cfg):
    tree = jax_params(tiny_model_cfg, seed=6)
    ours = export_torch_state_dict(tree)
    theirs = jax_checkpoint.export_torch_state_dict(jax.tree.map(jnp.asarray, tree))
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key])
    n_enc, n_dec = tiny_model_cfg.num_encoder_layers, tiny_model_cfg.num_decoder_layers
    back = dict(leaves(convert_torch_state_dict(ours, n_enc, n_dec)))
    want = dict(leaves(jax_checkpoint.convert_torch_state_dict(theirs, n_enc, n_dec)))
    assert back.keys() == want.keys() == dict(leaves(tree)).keys()
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value)
        np.testing.assert_array_equal(back[key], dict(leaves(tree))[key])


# -- the checkpoint manager (the cases of tests/test_train_loop_details.py) ----

TREE = {"w": torch.zeros(2)}


def kept(mgr):
    return sorted(e[1] for e in mgr._index["top"])


def test_crash_mid_save_keeps_previous_last(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), top_k=1)
    cfg = port_cfg(Config())
    mgr.save({"w": torch.zeros(2)}, cfg, 1)
    last = str(tmp_path / "last")
    real = CheckpointManager.save_tree

    def boom(path, tree):
        real(path, tree)  # the temporary file is whole...
        raise RuntimeError("simulated preemption before rename")

    monkeypatch.setattr(CheckpointManager, "save_tree", staticmethod(boom))
    with pytest.raises(RuntimeError):
        mgr.save({"w": torch.ones(2)}, cfg, 2)
    assert float(CheckpointManager.restore_tree(last)["w"].sum()) == 0.0


def test_newest_kept_on_tie(tmp_path):
    mgr = CheckpointManager(str(tmp_path), top_k=2)
    cfg = port_cfg(Config())
    for epoch in (1, 9, 17):  # ties spaced >= tie_refresh_epochs refresh
        mgr.save(TREE, cfg, epoch, metric_value=1.0)
    assert any("epoch=9-" in p for p in kept(mgr))
    assert any("epoch=17-" in p for p in kept(mgr))
    assert not any("epoch=1-" in p for p in kept(mgr))
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["index.json", "last", "last.meta.json", "epoch=9-valid_precision=1.0000",
         "epoch=9-valid_precision=1.0000.meta.json", "epoch=17-valid_precision=1.0000",
         "epoch=17-valid_precision=1.0000.meta.json"])


def test_fresh_tie_skips_the_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), top_k=2, tie_refresh_epochs=8)
    cfg = port_cfg(Config())
    mgr.save(TREE, cfg, 2, metric_value=1.0)
    mgr.save(TREE, cfg, 4, metric_value=1.0)  # fills top-2
    before = kept(mgr)
    mgr.save(TREE, cfg, 6, metric_value=1.0)  # 6 - 4 < 8: skipped
    assert kept(mgr) == before
    assert not any("epoch=6-" in p for p in before)
    mgr.save(TREE, cfg, 12, metric_value=1.0)  # 12 - 4 >= 8: refreshes
    assert any("epoch=12" in p for p in kept(mgr))
    assert mgr._index["last"].endswith("last")


def test_top_k_zero_disables_scored_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), top_k=0)
    cfg = port_cfg(Config())
    mgr.save(TREE, cfg, 1, metric_value=0.9)
    mgr.save(TREE, cfg, 2, metric_value=1.0)
    assert mgr._index["top"] == []
    assert mgr._index["last"].endswith("last")


def test_stale_index_entries_pruned_on_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), top_k=2)
    cfg = port_cfg(Config())
    mgr.save(TREE, cfg, 1, metric_value=0.9)
    mgr.save(TREE, cfg, 2, metric_value=0.8)
    gone = [e[1] for e in mgr._index["top"] if "epoch=1-" in e[1]][0]
    os.remove(gone)  # the weights are lost, the sidecar survives
    fresh = CheckpointManager(str(tmp_path), top_k=2)
    assert all("epoch=1-" not in e[1] for e in fresh._index["top"])
    assert not os.path.exists(gone + ".meta.json")
    assert CheckpointManager.restore_tree(fresh.best_path()) is not None


def test_best_path_opens_from_another_working_directory(tmp_path, monkeypatch):
    """A manager made with a relative directory, and one made later from
    elsewhere over the same index: best_path returns a path that opens
    from any working directory."""
    cfg = port_cfg(Config())
    (tmp_path / "run").mkdir()
    (tmp_path / "elsewhere").mkdir()
    monkeypatch.chdir(tmp_path / "run")
    mgr = CheckpointManager("ckpt", top_k=2)
    mgr.save(TREE, cfg, 1, metric_value=0.9)
    mgr.save(TREE, cfg, 2, metric_value=0.8)
    assert mgr._index["top"][0][1] == os.path.join("ckpt", "epoch=1-valid_precision=0.9000")
    monkeypatch.chdir(tmp_path / "elsewhere")
    for manager in (mgr, CheckpointManager(str(tmp_path / "run" / "ckpt"), top_k=2)):
        best = manager.best_path()
        assert best == str(tmp_path / "run" / "ckpt" / "epoch=1-valid_precision=0.9000")
        with open(best, "rb") as f:
            assert f.read(1)
        assert CheckpointManager.restore_tree(best) is not None
    unscored = CheckpointManager("fresh", top_k=0)
    assert unscored.best_path() is None
    unscored.save(TREE, cfg, 1, metric_value=0.5)
    monkeypatch.chdir(tmp_path)
    assert unscored.best_path() == str(tmp_path / "elsewhere" / "fresh" / "last")
    assert os.path.isfile(unscored.best_path())


def test_top_k_negative_keeps_all(tmp_path):
    mgr = CheckpointManager(str(tmp_path), top_k=-1)
    cfg = port_cfg(Config())
    for epoch, val in ((1, 0.5), (2, 0.9), (3, 0.7)):
        mgr.save(TREE, cfg, epoch, metric_value=val)
    assert len(kept(mgr)) == 3


def test_fresh_tie_still_loses_to_higher_metric(tmp_path):
    mgr = CheckpointManager(str(tmp_path), top_k=2, tie_refresh_epochs=8)
    cfg = port_cfg(Config())
    mgr.save(TREE, cfg, 2, metric_value=0.8)
    mgr.save(TREE, cfg, 4, metric_value=1.0)
    mgr.save(TREE, cfg, 6, metric_value=1.0)  # ties 4 but beats 0.8
    assert any("epoch=4" in p for p in kept(mgr))
    assert any("epoch=6" in p for p in kept(mgr))
    assert not os.path.exists(tmp_path / "epoch=2-valid_precision=0.8000")


def test_higher_metric_still_wins(tmp_path):
    mgr = CheckpointManager(str(tmp_path), top_k=2)
    cfg = port_cfg(Config())
    mgr.save(TREE, cfg, 1, metric_value=0.9)
    mgr.save(TREE, cfg, 2, metric_value=0.5)
    mgr.save(TREE, cfg, 3, metric_value=0.7)
    assert any("epoch=1" in p for p in kept(mgr))
    assert any("epoch=3" in p for p in kept(mgr))
    with open(str(tmp_path / "epoch=3-valid_precision=0.7000.meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 3 and meta["valid_precision"] == 0.7
    assert config_from_dict(meta["config"]) == cfg


# -- a reference Lightning checkpoint through both command lines ---------------

CONFIG_TEMPLATE = """\
model_class: 'SurfaceFormer_Parallel'
dataset_class: 'ABCDataset_Parallel'
root_dir: "{root}"
batch_size_train: 4
batch_size_valid: 4
trainer:
  name: 'lck'
  version: 'v0'
  num_devices: 1
  precision: 'fp32'
model:
  num_points_per_line: {p}
  num_lines: {lines}
  label_seq_length: {tlabel}
  max_num_faces: {faces}
  max_face_length: {tface}
  num_model: {e}
  num_head: {h}
  num_feedforward: {ffn}
  num_encoder_layers: {enc}
  num_decoder_layers: {dec}
  dropout: 0.0
decode:
  mode: 'reference'
  precision: 'fp32'
"""


def test_lightning_ckpt_through_both_command_lines(tmp_path, monkeypatch, tiny_model_cfg):
    cfg = tiny_model_cfg
    root = tmp_path / "data"
    generate(str(root), num=10, seed=3, split=(0.5, 0.2, 0.3))
    yml = tmp_path / "tiny.yml"
    yml.write_text(CONFIG_TEMPLATE.format(
        root=str(root), p=cfg.num_points_per_line, lines=cfg.num_lines,
        tlabel=cfg.label_seq_length, faces=cfg.max_num_faces, tface=cfg.max_face_length,
        e=cfg.num_model, h=cfg.num_head, ffn=cfg.num_feedforward,
        enc=cfg.num_encoder_layers, dec=cfg.num_decoder_layers))
    sd = export_torch_state_dict(jax_params(cfg, seed=5))
    blob = {"epoch": 7, "global_step": 1234, "pytorch-lightning_version": "1.3.5",
            "state_dict": OrderedDict((k, torch.tensor(v)) for k, v in sd.items()),
            "callbacks": {}, "optimizer_states": [], "lr_schedulers": []}
    ckpt = tmp_path / "epoch=7-valid_precision=0.9123.ckpt"
    torch.save(blob, str(ckpt))

    import main as jax_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["main.py", "--config-file", str(yml), "--test_ckpt",
                                      str(ckpt), "trainer.version", "jax"])
    jax_main.main()
    port_main.main(["--config-file", str(yml), "--test_ckpt", str(ckpt), "--device", "cpu",
                    "trainer.version", "port"])
    ours, theirs = (read_dir(tmp_path / "logs" / "lck" / v / "json") for v in ("port", "jax"))
    assert len(ours) == 3
    assert ours == theirs
    results = [json.load(open(tmp_path / "logs" / "lck" / v / "results.json"))
               for v in ("port", "jax")]
    for key in ("test_precision", "test_recall", "test_type_acc", "num_samples"):
        assert results[0][key] == results[1][key]

    # --valid_ckpt logs one validation; predict decodes the raw wireframes
    port_main.main(["--config-file", str(yml), "--valid_ckpt", str(ckpt), "--device", "cpu",
                    "trainer.version", "valid"])
    assert sum("valid_precision" in r
               for r in records(tmp_path / "logs" / "lck" / "valid")) == 1
    port_predict.main(["--config", str(yml), "--ckpt", str(ckpt), "--root", str(root),
                       "--out", str(tmp_path / "pred"), "--device", "cpu"])
    preds = read_dir(tmp_path / "pred" / "json")
    assert len(preds) == 10
    for name, data in ours.items():  # the test split's faces again
        assert json.loads(preds[name])["pred_faces"] == json.loads(data)["pred_faces"]
    # --reconstruct lifts the same predictions to PLYs beside them
    port_predict.main(["--config", str(yml), "--ckpt", str(ckpt), "--root", str(root),
                       "--device", "cpu", "--reconstruct"])
    assert read_dir(root / "pred" / "json") == preds
    assert os.path.isdir(root / "pred" / "ply")
