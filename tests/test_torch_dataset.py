"""PyTorch port: the data path against the JAX package (CPU): fixture
samples, the synthetic corpus on disk, dataset items and batch orders."""

import json
import os

import numpy as np
import pytest

from faceformer_tpu.data import batching as jax_batching
from faceformer_tpu.data import dataset as jax_dataset
from faceformer_tpu.geometry import fixtures as jax_fixtures
from faceformer_tpu.tools import synthetic_data as jax_synthetic
from faceformer_tpu_torch.data import batching, dataset
from faceformer_tpu_torch.geometry import fixtures
from faceformer_tpu_torch.tools import synthetic_data

from torch_port_helpers import port_model_cfg


# (seed, profile, coedge, direction_token): both profiles, both edge
# flavours and the direction-token flavour
SAMPLE_CASES = [(0, "classic", True, False), (1, "classic", False, False),
                (2, "rich", True, False), (3, "rich", True, False),
                (4, "rich", False, False), (5, "classic", False, True)]


@pytest.mark.parametrize("seed,profile,coedge,direction_token", SAMPLE_CASES)
def test_random_sample_equals_jax(seed, profile, coedge, direction_token):
    kw = dict(coedge=coedge, direction_token=direction_token, profile=profile)
    rng_j, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    ours = [fixtures.random_sample(rng_p, **kw) for _ in range(3)]
    theirs = [jax_fixtures.random_sample(rng_j, **kw) for _ in range(3)]
    assert json.dumps(ours) == json.dumps(theirs)
    assert rng_p.random() == rng_j.random()  # the same draws were consumed


def read_tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_generate_writes_byte_identical_trees(tmp_path):
    kw = dict(num=12, seed=1, profile="rich", max_edges=216, max_faces=42, max_face_len=36)
    jax_synthetic.generate(str(tmp_path / "jax"), **kw)
    synthetic_data.generate(str(tmp_path / "port"), **kw)
    ours, theirs = read_tree(tmp_path / "port"), read_tree(tmp_path / "jax")
    assert len(ours) == 12 + 4  # json/*.json, three splits, meta.json
    assert ours == theirs


def test_cli_writes_what_generate_writes(tmp_path):
    argv = ["--num", "6", "--seed", "4", "--max_faces", "20"]
    synthetic_data.main(["--root", str(tmp_path / "port")] + argv)
    jax_synthetic.main(["--root", str(tmp_path / "jax")] + argv)
    assert read_tree(tmp_path / "port") == read_tree(tmp_path / "jax")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    synthetic_data.generate(str(root), num=20, seed=3, split=(0.6, 0.2, 0.2))
    return str(root)


def assert_items_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for key, value in theirs.items():
        if isinstance(value, np.ndarray):
            assert ours[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value, key


def test_dataset_items_equal_jax(corpus, tiny_model_cfg, monkeypatch):
    monkeypatch.setenv("FACEFORMER_NATIVE_LOADER", "0")  # JAX's Python path
    cfg = port_model_cfg(tiny_model_cfg)
    for splits in (["train.txt"], "valid.txt test.txt", ["json/00000003.json"]):
        theirs = jax_dataset.ABCDatasetParallel(corpus, splits, tiny_model_cfg)
        ours = dataset.ABCDataset_Parallel(corpus, splits, cfg)
        assert ours.info_files == theirs.info_files
        assert list(ours.raw_datas) == theirs.raw_datas  # the port's loads lazily
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            assert_items_equal(ours[i], theirs[i])
            assert ours[i] is ours[i]  # memoized
    samples = theirs.raw_datas
    assert_items_equal(dataset.ABCDatasetParallel.from_samples(samples, cfg)[0],
                       jax_dataset.ABCDatasetParallel.from_samples(samples, tiny_model_cfg)[0])


def test_parse_splits_list_equals_jax(corpus, tmp_path):
    (tmp_path / "gaps.txt").write_text("json/a.json\n\n  \njson/b.json\n")
    for splits in ("train.txt valid.txt", ["test.txt", "json/x.json"]):
        assert (dataset.parse_splits_list(corpus, splits)
                == jax_dataset.parse_splits_list(corpus, splits))
    assert dataset.parse_splits_list(str(tmp_path), "gaps.txt") == ["json/a.json", "json/b.json"]
    with pytest.raises(NotImplementedError):
        dataset.parse_splits_list(corpus, ["train.csv"])


def test_flat_dataset_names_its_queue_item(tmp_path, tiny_model_cfg, monkeypatch):
    """The flat model's dataset, which named its queue item until the flat
    SurfaceFormer was ported, now packs a direction-token corpus on disk as
    the JAX package does (configs/synthetic-dirtok-big.yml's flavour)."""
    import dataclasses

    from faceformer_tpu.config import TokenConfig

    monkeypatch.setenv("FACEFORMER_NATIVE_LOADER", "0")  # JAX's Python path
    cfg = dataclasses.replace(tiny_model_cfg, label_seq_length=256,
                              token=TokenConfig(DIR0=4, DIR1=5, length=6))
    synthetic_data.generate(str(tmp_path), num=8, seed=2, direction_token=True,
                            max_edges=cfg.num_lines, max_label_len=250, split=(0.5, 0.25, 0.25))
    theirs = jax_dataset.ABCDataset(str(tmp_path), ["train.txt", "test.txt"], cfg)
    ours = dataset.ABCDataset(str(tmp_path), ["train.txt", "test.txt"], port_model_cfg(cfg))
    assert ours.info_files == theirs.info_files and len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        assert_items_equal(ours[i], theirs[i])
        assert (ours[i]["label"] == cfg.token.DIR0).any()


# (size, batch, shuffle, drop_last, pad_to_full, process_count)
BATCH_CASES = [(10, 4, True, True, False, 1), (10, 4, True, False, True, 1),
               (10, 3, False, False, True, 1), (9, 4, False, False, False, 1),
               (11, 2, True, True, False, 2)]


@pytest.mark.parametrize("size,batch,shuffle,drop_last,pad,procs", BATCH_CASES)
def test_iter_batches_equal_jax(size, batch, shuffle, drop_last, pad, procs):
    items = [{"id": i, "name": f"json/{i:08d}.json", "x": np.full(3, i, np.float32)}
             for i in range(size)]
    for seed in (0, 7):
        for epoch in (0, 1, 5):
            for proc in range(procs):
                kw = dict(shuffle=shuffle, drop_last=drop_last, seed=seed, epoch=epoch,
                          pad_to_full=pad, process_index=proc, process_count=procs)
                ours = list(batching.iter_batches(items, batch, **kw))
                theirs = list(jax_batching.iter_batches(items, batch, **kw))
                assert len(ours) == len(theirs) > 0
                for a, b in zip(ours, theirs):
                    assert_items_equal(a, b)
