"""Host-side batching: collate packed samples into one dict of arrays, and
iterate a dataset in batches (a copy of faceformer_tpu/data/batching.py).

Batches are numpy dicts with a leading batch axis; the harness moves each
to the card in one pinned, non-blocking copy per field."""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


def collate(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts field-wise. String fields become lists."""
    batch: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            batch[key] = vals
        else:
            batch[key] = np.stack([np.asarray(v) for v in vals])
    return batch


def iter_batches(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int = 0,
    epoch: int = 0,
    pad_to_full: bool = False,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Iterate collated batches.

    pad_to_full repeats the last sample to fill a ragged final batch and adds
    a boolean ``sample_valid`` field so metrics can ignore the padding — the
    alternative to a ragged final batch that keeps one batch shape.

    process_index/process_count shard the (epoch-shuffled) sample order
    across processes for multi-process training: every process sees a
    disjoint stripe but the same global permutation.
    """
    order = np.arange(len(dataset))
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    if process_count > 1:
        # equal stripe length on every host: stride-sliced stripes can
        # differ by one sample, and under drop_last the per-host BATCH
        # counts then diverge (e.g. 7 samples / 2 hosts / batch 4 -> host 0
        # yields a batch, host 1 yields none) — one host blocks forever in
        # the step's cross-process collective while the other has left
        # the epoch. Truncating to the global minimum keeps every host in
        # lockstep; the dropped tail re-enters via the next epoch's shuffle.
        per_host = len(order) // process_count
        order = order[process_index::process_count][:per_host]
    for start in range(0, len(order), batch_size):
        idx: List[int] = order[start : start + batch_size].tolist()
        if len(idx) < batch_size:
            if drop_last:
                return
            if pad_to_full:
                valid = np.zeros(batch_size, dtype=bool)
                valid[: len(idx)] = True
                idx = idx + [idx[-1]] * (batch_size - len(idx))
                batch = collate([dataset[i] for i in idx])
                batch["sample_valid"] = valid
                yield batch
                continue
        batch = collate([dataset[i] for i in idx])
        batch["sample_valid"] = np.ones(len(idx), dtype=bool)
        yield batch
