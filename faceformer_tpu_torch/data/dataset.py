"""Dataset classes: preload reference-format JSONs, emit packed samples
(PyTorch counterpart of faceformer_tpu/data/dataset.py; reference:
faceformer/datasets/data_para.py:28-131).

Same constructor (root_dir, splits, model config), same preload-to-RAM
behaviour, same per-sample dict keys as the JAX package. Items are numpy
arrays; ``data.batching`` collates them and the harness moves a batch to
the card. Packing runs the Python path only: the JAX package's C++ fast
path (``native_loader``) is not ported, since the port's predicates and
packers are Python. ``ABCDataset`` packs the flat model's single-sequence
labels, ``ABCDatasetParallel`` the anchor-parallel rows.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Union

from faceformer_tpu_torch.config import ModelConfig
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


class _BaseDataset:
    """Preloaded raw samples and memoized packing; subclasses name the
    label layout (``_pack_label``)."""

    def __init__(self, root_dir: str, splits: Union[str, Sequence[str]], config: ModelConfig):
        self.root_dir = root_dir
        self.config = config
        self.info_files = parse_splits_list(root_dir, splits)
        self._cache: Dict[int, Dict] = {}
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
        obj._cache = {}
        return obj

    def __len__(self) -> int:
        return len(self.raw_datas)

    def __getitem__(self, index: int) -> Dict:
        # packing is deterministic: memoize so epochs after the first skip
        # the host-side resample/pack work (the reference re-packs every
        # epoch in DataLoader workers)
        if index not in self._cache:
            raw = self.raw_datas[index]
            sample = {"id": index, "name": self.info_files[index]}
            sample.update(pack_input_edges(raw["edges"], self.config))
            sample.update(self._pack_label(raw["faces_indices"], self.config))
            self._cache[index] = sample
        return self._cache[index]


class ABCDataset(_BaseDataset):
    """Single-sequence dataset: all faces flattened into one token stream."""

    _pack_label = staticmethod(pack_label_single)


class ABCDatasetParallel(_BaseDataset):
    """Per-edge-anchor dataset: one label row per loop rotation."""

    _pack_label = staticmethod(pack_label_parallel)


# reference-compatible alias (configs name the dataset class by it)
ABCDataset_Parallel = ABCDatasetParallel
