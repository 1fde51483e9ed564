"""PyTorch port: the C++ data loader (``csrc/host/dataloader.cc``, bridged
by ``data/native_loader.py``) behind ``data/dataset.py``, against the JAX
package's Python packer (``FACEFORMER_NATIVE_LOADER=0`` on the JAX side)
and its native loader, on every label flavour: the same arrays, ``input``
bit for bit. Then per-file failures (a malformed JSON, a label that
overflows T, every file failed, an empty split) and the fuzz command.
The counterparts of tests/test_native_loader.py's cases come first."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from faceformer_tpu.config import TokenConfig
from faceformer_tpu.data import dataset as jax_dataset
from faceformer_tpu.data import native_loader as jax_native_loader
from faceformer_tpu_torch.data import dataset, native_loader
from faceformer_tpu_torch.data.dataset import ABCDataset, ABCDatasetParallel
from faceformer_tpu_torch.geometry.fixtures import random_sample

from torch_port_helpers import port_model_cfg

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is absent: the host library cannot be built")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRTOK = TokenConfig(DIR0=4, DIR1=5, length=6)


def write_dataset(root, samples):
    (root / "json").mkdir(parents=True)
    names = []
    for i, s in enumerate(samples):
        name = f"json/{i:08d}.json"
        with open(root / name, "w") as f:
            json.dump(s, f)
        names.append(name)
    with open(root / "all.txt", "w") as f:
        f.write("\n".join(names))
    return str(root), "all.txt"


@pytest.fixture(scope="module")
def flavor_samples():
    rng = np.random.default_rng(0)
    return [random_sample(rng) for _ in range(10)]


def assert_items_equal(fast, slow):
    assert len(fast) == len(slow)
    for i in range(len(slow)):
        a, b = fast[i], slow[i]
        assert set(a) == set(b)
        for key in b:
            if isinstance(b[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, key
                assert a[key].shape == b[key].shape, key
                assert a[key].tobytes() == b[key].tobytes(), key
            else:
                assert a[key] == b[key], key


# --- counterparts of tests/test_native_loader.py ------------------------------


class TestParity:
    def test_parallel(self, tmp_path, flavor_samples, tiny_model_cfg):
        cfg = port_model_cfg(tiny_model_cfg)
        root, split = write_dataset(tmp_path, flavor_samples)
        fast = ABCDatasetParallel(root, split, cfg)
        assert fast._packed is not None, "native path did not engage"
        assert_items_equal(fast, ABCDatasetParallel.from_samples(flavor_samples, cfg))

    def test_single_combined(self, tmp_path, tiny_model_cfg):
        rng = np.random.default_rng(1)
        samples = [random_sample(rng, coedge=False) for _ in range(8)]
        cfg = port_model_cfg(dataclasses.replace(tiny_model_cfg, label_seq_length=256))
        root, split = write_dataset(tmp_path, samples)
        fast = ABCDataset(root, split, cfg)
        assert fast._packed is not None
        assert_items_equal(fast, ABCDataset.from_samples(samples, cfg))

    def test_single_coedge_loops(self, tmp_path, tiny_model_cfg):
        rng = np.random.default_rng(2)
        samples = [random_sample(rng, no_face_type=True) for _ in range(8)]
        cfg = port_model_cfg(dataclasses.replace(tiny_model_cfg, label_seq_length=256))
        root, split = write_dataset(tmp_path, samples)
        fast = ABCDataset(root, split, cfg)
        assert fast._packed is not None
        assert_items_equal(fast, ABCDataset.from_samples(samples, cfg))

    def test_single_direction_token(self, tmp_path, tiny_model_cfg):
        rng = np.random.default_rng(3)
        samples = [random_sample(rng, direction_token=True) for _ in range(6)]
        cfg = port_model_cfg(dataclasses.replace(tiny_model_cfg, label_seq_length=512,
                                                 token=DIRTOK))
        root, split = write_dataset(tmp_path, samples)
        fast = ABCDataset(root, split, cfg)
        assert fast._packed is not None
        assert_items_equal(fast, ABCDataset.from_samples(samples, cfg))

    def test_parallel_extended_token_table(self, tmp_path, tiny_model_cfg):
        # 6-row token table: unused label rows carry the Other face-type
        # token, not tok.length - 1 (= DIR1 here)
        rng = np.random.default_rng(4)
        samples = [random_sample(rng) for _ in range(6)]
        cfg = port_model_cfg(dataclasses.replace(tiny_model_cfg, token=DIRTOK))
        root, split = write_dataset(tmp_path, samples)
        fast = ABCDatasetParallel(root, split, cfg)
        assert fast._packed is not None
        assert_items_equal(fast, ABCDatasetParallel.from_samples(samples, cfg))

    def test_raw_datas_lazy_but_correct(self, tmp_path, flavor_samples, tiny_model_cfg):
        root, split = write_dataset(tmp_path, flavor_samples)
        ds = ABCDatasetParallel(root, split, port_model_cfg(tiny_model_cfg))
        assert ds.raw_datas[3]["edges"] == flavor_samples[3]["edges"]
        assert len(ds.raw_datas) == len(flavor_samples)
        assert list(ds.raw_datas) == flavor_samples


class TestFallback:
    def test_malformed_json_falls_back_per_file(self, tmp_path, flavor_samples,
                                                tiny_model_cfg):
        # one bad file: the other 9 still load natively, the warning names
        # the offender, and indexing it raises what json.load raises
        cfg = port_model_cfg(tiny_model_cfg)
        root, split = write_dataset(tmp_path, flavor_samples)
        (tmp_path / "json" / "00000003.json").write_text("{ not json")
        with pytest.warns(UserWarning, match="00000003.json"):
            ds = ABCDatasetParallel(root, split, cfg)
        assert ds._packed is not None, "native path must stay engaged"
        assert ds._native_failed == {3}
        slow = ABCDatasetParallel.from_samples(flavor_samples, cfg)
        for i in (0, 1, 2, 4, 9):
            for key, val in slow[i].items():
                if isinstance(val, np.ndarray):
                    np.testing.assert_array_equal(ds[i][key], val, err_msg=key)
        with pytest.raises(json.JSONDecodeError):
            ds[3]

    def test_plain_impl_preloads(self, tmp_path, flavor_samples, tiny_model_cfg):
        # the counterpart of the JAX package's environment opt-out: the
        # port has no switch, only impl="plain" for comparisons
        cfg = port_model_cfg(tiny_model_cfg)
        root, split = write_dataset(tmp_path, flavor_samples)
        ds = ABCDatasetParallel(root, split, cfg, impl="plain")
        assert ds._packed is None
        assert ds.raw_datas == flavor_samples
        assert_items_equal(ds, ABCDatasetParallel(root, split, cfg))
        with pytest.raises(ValueError, match="impl"):
            ABCDatasetParallel(root, split, cfg, impl="fast")

    def test_overflow_label_falls_back(self, tmp_path, flavor_samples, tiny_model_cfg):
        # a face longer than max_face_length fails as the Python packer
        # does (ValueError), through the Python path
        cfg = port_model_cfg(dataclasses.replace(tiny_model_cfg, max_face_length=3))
        root, split = write_dataset(tmp_path, flavor_samples)
        with pytest.warns(UserWarning, match="native loader"):
            with pytest.raises(ValueError, match="max_face_length"):
                ds = ABCDatasetParallel(root, split, cfg)
                ds[0]


# --- the port against both JAX paths, every flavour --------------------------

# (dataset class name, random_sample kwargs, config changes)
FLAVOURS = {
    "parallel": ("ABCDatasetParallel", {}, {}),
    "flat_combined": ("ABCDataset", {"coedge": False}, {"label_seq_length": 256}),
    "coedge_loops": ("ABCDataset", {"no_face_type": True}, {"label_seq_length": 256}),
    "direction_token": ("ABCDataset", {"direction_token": True},
                        {"label_seq_length": 512, "token": DIRTOK}),
    "extended_token_table": ("ABCDatasetParallel", {"profile": "rich"},
                             {"token": DIRTOK, "num_lines": 216, "max_face_length": 64}),
    "no_face_type": ("ABCDataset", {"coedge": False, "no_face_type": True, "profile": "rich"},
                     {"label_seq_length": 1024, "num_lines": 216}),
}


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_flavour_equals_both_jax_paths(flavour, tmp_path, tiny_model_cfg, monkeypatch):
    cls_name, sample_kw, cfg_kw = FLAVOURS[flavour]
    rng = np.random.default_rng(sorted(FLAVOURS).index(flavour) + 20)
    samples = [random_sample(rng, **sample_kw) for _ in range(7)]
    jax_cfg = dataclasses.replace(tiny_model_cfg, **cfg_kw)
    cfg = port_model_cfg(jax_cfg)
    root, split = write_dataset(tmp_path, samples)
    ours = getattr(dataset, cls_name)(root, split, cfg)
    assert ours._packed is not None and not ours._native_failed
    plain = getattr(dataset, cls_name)(root, split, cfg, impl="plain")
    jax_cls = getattr(jax_dataset, cls_name)
    monkeypatch.setenv("FACEFORMER_NATIVE_LOADER", "1")
    jax_native = jax_cls(root, split, jax_cfg)
    assert jax_native._packed is not None, "the JAX native loader did not engage"
    monkeypatch.setenv("FACEFORMER_NATIVE_LOADER", "0")
    jax_python = jax_cls(root, split, jax_cfg)
    assert jax_python._packed is None
    for theirs in (jax_python, jax_native, plain):
        assert_items_equal(ours, theirs)
    assert list(ours.raw_datas) == jax_python.raw_datas
    # the loader's arrays themselves, against the JAX package's loader
    paths = [os.path.join(root, f) for f in ours.info_files]
    parallel = cls_name == "ABCDatasetParallel"
    got = native_loader.load_pack_files(paths, cfg, parallel, n_threads=3)
    want = jax_native_loader.load_pack_files(paths, jax_cfg, parallel)
    assert got.keys() == want.keys()
    for key in want:
        if key == "failed":
            assert got[key] == want[key] == ()
        else:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key


def test_label_overflowing_t_fails_its_file_only(tmp_path, tiny_model_cfg, monkeypatch):
    """One sample whose faces overflow the flat label: its file lands in
    ``failed`` and indexing it raises the JAX Python path's error."""
    rng = np.random.default_rng(5)
    samples = [random_sample(rng, coedge=False) for _ in range(5)]
    jax_cfg = dataclasses.replace(tiny_model_cfg, label_seq_length=256)
    long = dict(samples[2])
    long["faces_indices"] = long["faces_indices"] * 40
    samples[2] = long
    root, split = write_dataset(tmp_path, samples)
    with pytest.warns(UserWarning, match="00000002.json"):
        ours = ABCDataset(root, split, port_model_cfg(jax_cfg))
    assert ours._native_failed == {2}
    monkeypatch.setenv("FACEFORMER_NATIVE_LOADER", "0")
    theirs = jax_dataset.ABCDataset(root, split, jax_cfg)
    with pytest.raises(Exception) as jax_err:
        theirs[2]
    with pytest.raises(type(jax_err.value)) as port_err:
        ours[2]
    assert str(port_err.value) == str(jax_err.value)
    for i in (0, 1, 3, 4):
        assert ours[i]["input"].tobytes() == theirs[i]["input"].tobytes()
        assert ours[i]["label"].tobytes() == theirs[i]["label"].tobytes()


def test_every_file_failed(tmp_path, flavor_samples, tiny_model_cfg, monkeypatch):
    """Every file malformed: the loader returns None with the JAX package's
    warning, and the dataset raises at construction what the JAX Python
    path raises."""
    root, split = write_dataset(tmp_path, flavor_samples[:3])
    for i in range(3):
        (tmp_path / "json" / f"{i:08d}.json").write_text('{"edges": [')
    paths = [os.path.join(root, f"json/{i:08d}.json") for i in range(3)]
    cfg = port_model_cfg(tiny_model_cfg)
    with pytest.warns(UserWarning, match="all 3 files failed"):
        assert native_loader.load_pack_files(paths, cfg, True) is None
    monkeypatch.setenv("FACEFORMER_NATIVE_LOADER", "0")
    with pytest.raises(Exception) as jax_err:
        jax_dataset.ABCDatasetParallel(root, split, tiny_model_cfg)
    with pytest.warns(UserWarning, match="all 3 files failed"):
        with pytest.raises(type(jax_err.value)):
            ABCDatasetParallel(root, split, cfg)


def test_empty_split(tmp_path, tiny_model_cfg, monkeypatch):
    (tmp_path / "empty.txt").write_text("")
    cfg = port_model_cfg(tiny_model_cfg)
    ours = ABCDatasetParallel(str(tmp_path), "empty.txt", cfg)
    monkeypatch.setenv("FACEFORMER_NATIVE_LOADER", "1")
    theirs = jax_dataset.ABCDatasetParallel(str(tmp_path), "empty.txt", tiny_model_cfg)
    assert len(ours) == len(theirs) == 0
    assert (ours._packed is None) == (theirs._packed is None)
    got = native_loader.load_pack_files([], cfg, True)
    assert got["input"].shape == (0, cfg.num_lines, cfg.num_points_per_line, 2)
    assert got["failed"] == ()


def test_point_dim_3_takes_the_python_packer(tmp_path, flavor_samples, tiny_model_cfg):
    cfg = port_model_cfg(dataclasses.replace(tiny_model_cfg, point_dim=3))
    assert native_loader.load_pack_files([], cfg, True) is None
    root, split = write_dataset(tmp_path, flavor_samples[:2])
    ds = ABCDatasetParallel(root, split, cfg)
    assert ds._packed is None and isinstance(ds.raw_datas, list)


def test_fuzz_command(tmp_path):
    """24 byte-level mutations of a corpus sample and the pathological
    payloads through the fuzz command: each packs or lands in ``failed``,
    and the process exits 0."""
    from faceformer_tpu_torch.tools import synthetic_data

    synthetic_data.generate(str(tmp_path / "corpus"), num=2, seed=1, profile="rich",
                            max_edges=216, max_faces=42, max_face_len=36)
    out = subprocess.run(
        [sys.executable, "-m", "faceformer_tpu_torch.tools.fuzz_native_loader",
         "--root", str(tmp_path / "corpus"), "--num", "24", "--seed", "3",
         "--workdir", str(tmp_path / "fuzz")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    total, failed, parsed = (int(x) for x in re.fullmatch(
        r"(\d+) inputs: (\d+) failed cleanly, (\d+) parsed, no crash", line).groups())
    assert total == 24 + 8 and failed + parsed == total and failed > 0


def test_chip_smoke_host_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py [10] on a 24-solid corpus of [5]'s generator flags:
    both paths equal on every split, the timings returned; a plain path
    planted one off fails it."""
    import importlib.util

    from faceformer_tpu_torch.tools import synthetic_data

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    failures = []
    smoke.fail = failures.append
    root = str(tmp_path / "syn")
    synthetic_data.generate(root, num=24, seed=1, profile="rich", max_edges=216, max_faces=42,
                            max_face_len=36, split=(0.5, 0.25, 0.25))
    got = smoke.check_host_loader("corpus", root, smoke.CLI_CONFIG)
    assert got["samples"] == 24 and got["splits"] == [12, 6, 6]
    ms = smoke.time_host_kernels(root, smoke.CLI_CONFIG)
    assert set(ms) == {"resample_native", "resample_plain", "enclosedness_native",
                       "enclosedness_plain"}
    assert failures == []
    pack = dataset.ABCDatasetParallel._pack
    monkeypatch.setattr(dataset.ABCDatasetParallel, "_pack",
                        lambda self, i: {**pack(self, i), "input": pack(self, i)["input"] + 1})
    smoke.check_host_loader("corpus", root, smoke.CLI_CONFIG)
    assert len(failures) == 24 and all("input differs" in f for f in failures)
