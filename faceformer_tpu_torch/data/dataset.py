"""Dataset classes: load reference-format JSONs, emit packed samples
(PyTorch counterpart of faceformer_tpu/data/dataset.py; reference:
faceformer/datasets/data_para.py:28-131).

Same constructor (root_dir, splits, model config), same per-sample dict
keys as the JAX package. Items are numpy arrays; ``data.batching``
collates them and the harness moves a batch to the card. With
``impl="native"`` (the default) one threaded C++ pass of the host library
(``data/native_loader.py``) loads, parses, resamples and packs the whole
split at construction; a file it rejects re-packs through the Python path
when it is indexed, and the raw JSONs that eval reads load lazily.
``impl="plain"`` preloads every JSON to RAM and packs each sample in
Python with numpy resampling (the reference's behaviour, for comparisons).
``from_samples`` packs in-memory samples through the Python packer.
``ABCDataset`` packs the flat model's single-sequence labels,
``ABCDatasetParallel`` the anchor-parallel rows.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Union

from faceformer_tpu_torch.config import ModelConfig
from faceformer_tpu_torch.data import native_loader
from faceformer_tpu_torch.data.packing import (
    pack_input_edges,
    pack_label_parallel,
    pack_label_single,
)


def parse_splits_list(root_dir: str, splits: Union[str, Sequence[str]]) -> List[str]:
    """Resolve split entries to sample paths relative to root_dir.

    Each entry is either a .json sample path or a .txt file listing .json
    paths (reference: data.py:99-118).
    """
    if isinstance(splits, str):
        splits = splits.split()
    info_files: List[str] = []
    for split in splits:
        ext = os.path.splitext(split)[1]
        if ext == ".json":
            info_files.append(split)
        elif ext == ".txt":
            with open(os.path.join(root_dir, split), "r") as f:
                # skip blank lines: an empty entry would later open() the
                # data root itself and die with a misleading IsADirectoryError
                info_files += [line.rstrip() for line in f if line.strip()]
        else:
            raise NotImplementedError(f"{split} is not a valid info_file type")
    return info_files


class _LazyRawList:
    """Raw sample JSONs, loaded on first access. The native loader's
    training path never needs them; eval (metrics + prediction dump)
    touches only its split's samples, which load lazily here."""

    def __init__(self, root_dir: str, info_files: Sequence[str]):
        self._root_dir = root_dir
        self._info_files = list(info_files)
        self._cache: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return len(self._info_files)

    def __getitem__(self, index: int) -> Dict:
        if index not in self._cache:
            with open(os.path.join(self._root_dir, self._info_files[index])) as f:
                self._cache[index] = json.load(f)
        return self._cache[index]


class _BaseDataset:
    """Packed samples, memoized; subclasses name the label layout
    (``_parallel``, ``_pack_label``)."""

    _parallel = False

    def __init__(self, root_dir: str, splits: Union[str, Sequence[str]], config: ModelConfig,
                 impl: str = "native"):
        if impl not in ("native", "plain"):
            raise ValueError(f"impl must be 'native' or 'plain', not {impl!r}")
        self.root_dir = root_dir
        self.config = config
        self.info_files = parse_splits_list(root_dir, splits)
        self._impl = impl
        self._cache: Dict[int, Dict] = {}
        self._packed = None
        self._native_failed = frozenset()
        if impl == "native":
            paths = [os.path.join(root_dir, f) for f in self.info_files]
            self._packed = native_loader.load_pack_files(paths, config, parallel=self._parallel)
        if self._packed is not None:
            self._native_failed = frozenset(self._packed.pop("failed"))
            self.raw_datas = _LazyRawList(root_dir, self.info_files)
            return
        # reference behaviour: preload all JSONs to RAM (data.py:48-51)
        self.raw_datas: List[Dict] = []
        for info_file in self.info_files:
            with open(os.path.join(root_dir, info_file), "r") as f:
                self.raw_datas.append(json.load(f))

    @classmethod
    def from_samples(cls, samples: Sequence[Dict], config: ModelConfig, names=None):
        """Build a dataset directly from in-memory sample dicts (fixtures)."""
        obj = cls.__new__(cls)
        obj.root_dir = ""
        obj.config = config
        obj.raw_datas = list(samples)
        obj.info_files = (list(names) if names
                          else [f"json/{i:08d}.json" for i in range(len(samples))])
        obj._impl = "native"
        obj._cache = {}
        obj._packed = None
        obj._native_failed = frozenset()
        return obj

    def __len__(self) -> int:
        return len(self.raw_datas)

    def _from_packed(self, index: int) -> Dict:
        p = self._packed
        label = p["label"][index]
        sample = {
            "id": index,
            "name": self.info_files[index],
            "input": p["input"][index],
            "input_mask": p["input_mask"][index],
            "num_input": int(p["num_input"][index]),
            "label": label,
            "label_mask": label == self.config.token.PAD,
        }
        key = "num_faces" if self._parallel else "num_label"
        sample[key] = int(p[key][index])
        return sample

    def _pack(self, index: int) -> Dict:
        raw = self.raw_datas[index]
        sample = {"id": index, "name": self.info_files[index]}
        sample.update(pack_input_edges(raw["edges"], self.config, impl=self._impl))
        sample.update(self._pack_label(raw["faces_indices"], self.config))
        return sample

    def __getitem__(self, index: int) -> Dict:
        # packing is deterministic: memoize so epochs after the first skip
        # the host-side resample/pack work (the reference re-packs every
        # epoch in DataLoader workers)
        if index not in self._cache:
            use_native = self._packed is not None and index not in self._native_failed
            self._cache[index] = self._from_packed(index) if use_native else self._pack(index)
        return self._cache[index]


class ABCDataset(_BaseDataset):
    """Single-sequence dataset: all faces flattened into one token stream."""

    _pack_label = staticmethod(pack_label_single)


class ABCDatasetParallel(_BaseDataset):
    """Per-edge-anchor dataset: one label row per loop rotation."""

    _parallel = True
    _pack_label = staticmethod(pack_label_parallel)


# reference-compatible alias (configs name the dataset class by it)
ABCDataset_Parallel = ABCDatasetParallel
