"""Decompose the direction-token flavour's recall loss (the port's
counterpart of the root ``tools/diagnose_dirtok.py``).

A direction-token model can lose recall two ways: it emits too FEW faces
(an early EOS, skipped faces), or it emits faces whose oriented loops fail
the enclosedness filter that ``FaceMetrics`` applies to this flavour. This
tool decodes a test split and counts, over its samples, the raw predicted
faces (straight from the token stream), the faces that survive the
oriented-enclosedness filter, the label faces, and how many of the
filter-dropped faces would have matched a label as an undirected edge set
(the face was right; only its direction bits broke the chain).

    python -m faceformer_tpu_torch.tools.diagnose_dirtok --ckpt <checkpoint> \\
        [--config configs/synthetic-dirtok-big.yml] [--batch 32] [--out out.json] \\
        [--device cpu]

It decodes with the config's ``decode`` settings (``decode_grid``), on the
card unless ``--device cpu``. ``--out`` appends the result to the list the
file holds.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from faceformer_tpu_torch.config import TokenConfig, load_config
from faceformer_tpu_torch.data.batching import iter_batches
from faceformer_tpu_torch.geometry.native import filter_faces_by_encloseness_batch
from faceformer_tpu_torch.train.metrics import parse_directed_faces
from faceformer_tpu_torch.train.trainer import Harness, decode_grid

COUNT_KEYS = ("samples", "pred_raw", "pred_kept", "label", "dropped_but_matches_label",
              "kept_matches_label")
NOTE = ("dropped_but_matches_label counts filter-dropped predicted faces whose UNDIRECTED "
        "edge set equals a label face: the face was found, only its direction bits broke "
        "the chain.")


def count_sample(tokens: np.ndarray, labels: np.ndarray, raw: Dict, tok: TokenConfig,
                 tol: float) -> Dict[str, int]:
    """One sample's counts (``COUNT_KEYS``) from its decoded token row and
    its label row."""
    pred, label = parse_directed_faces(np.asarray(tokens), np.asarray(labels),
                                       len(raw["edges"]), tok)
    # direction-token faces carry (edge, orientation) pairs, so the filter
    # takes the Python predicate, as FaceMetrics does for this flavour
    kept = filter_faces_by_encloseness_batch(raw["edges"], pred, tol)
    # the parser's faces are flat pair tuples; the survivors carry loops of pairs
    kept_keys = {tuple(sorted({e for loop in loops for (e, _o) in loop})) for _t, loops in kept}
    label_keys = {tuple(sorted({e for (e, _o) in pairs})) for _t, pairs in label}
    pred_keys = [tuple(sorted({e for (e, _o) in pairs})) for _t, pairs in pred]
    return {
        "samples": 1,
        "pred_raw": len(pred),
        "pred_kept": len(kept),
        "label": len(label),
        "dropped_but_matches_label": sum(1 for k in pred_keys
                                         if k not in kept_keys and k in label_keys),
        "kept_matches_label": sum(1 for k in kept_keys if k in label_keys),
    }


def diagnose(model, cfg, ds, batch_size: int) -> Dict[str, int]:
    """The counts summed over every sample of ``ds``, decoded ``batch_size``
    at a time on the model's device."""
    dev = next(model.parameters()).device
    tok, tol = cfg.model.token, cfg.post_process.enclosedness_tol
    counts = dict.fromkeys(COUNT_KEYS, 0)
    items = [ds[i] for i in range(len(ds))]
    for b in iter_batches(items, batch_size, pad_to_full=True):
        batch = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
                 for k, v in b.items() if not isinstance(v, (list, str))}
        grid = decode_grid(model, cfg, batch).cpu().numpy()
        labels = np.asarray(b["label"])
        for i, ok in enumerate(b["sample_valid"]):
            if not ok:
                continue
            one = count_sample(grid[i], labels[i], ds.raw_datas[b["id"][i]], tok, tol)
            for key in COUNT_KEYS:
                counts[key] += one[key]
    return counts


def _git_rev() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                              text=True).stdout.strip()
    except OSError:  # no git on the host
        return ""


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--config", default="configs/synthetic-dirtok-big.yml")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    # one process on one card, whatever ranks the training config asked for
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, num_devices=1))
    harness = Harness(cfg, device=args.device)
    model = harness.load(args.ckpt)["model"]
    counts = diagnose(model, cfg, harness.dataset("test"), args.batch)

    result = {
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "git_rev": _git_rev(),
        "ckpt": args.ckpt, "config": args.config,
        **counts,
        "filter_drop_rate": round(1 - counts["pred_kept"] / max(counts["pred_raw"], 1), 4),
        "note": NOTE,
    }
    for k, v in result.items():
        print(f"{k}: {v}")
    if args.out:
        runs = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                prev = json.load(f)
            runs = prev if isinstance(prev, list) else [prev]
        runs.append(result)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return result


if __name__ == "__main__":
    main()
