"""Label-free inference: wireframe dicts -> predicted faces (PyTorch
counterpart of faceformer_tpu/tools/predict.py).

Any dict with an "edges" list of 2D polylines decodes to per-sample face
lists, post-processed exactly as the test loop does: (F, T) anchor-parallel
rows parsed at their first face-type token, or (T,) flat grids split at SEP
(direction-token pairs for that flavor), then the enclosedness filter,
coedge mapping and the majority vote on types.

    python -m faceformer_tpu_torch.tools.predict --config configs/ours.yml \
        --ckpt <checkpoint> --root <dir with json/*.json> [--out DIR] [--device cpu] \
        [--reconstruct]

writes <out>/json/<id>.json with {edges, dominant_directions, pred_faces,
label_faces=[]}, and with --reconstruct also <out>/ply/<id>.ply (lifted
serially in this process: a fork after the card's context exists is
unsafe). The checkpoint is one the port wrote or a reference .ckpt/.pt/.pth
file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from faceformer_tpu_torch.config import Config, load_config
from faceformer_tpu_torch.data.batching import collate
from faceformer_tpu_torch.data.packing import pack_input_edges
from faceformer_tpu_torch.device import require_device
from faceformer_tpu_torch.train.metrics import FaceMetrics
from faceformer_tpu_torch.train.trainer import Harness, NumpyJSONEncoder, decode_grid


def predict_faces(model, cfg: Config, raw_samples: Sequence[Dict], device="cuda",
                  early_stop: bool = True) -> List[List]:
    """Decode predicted faces for raw samples (no labels needed).

    Batches of ``cfg.batch_size_valid`` samples (the last one filled by
    repeating its final sample) decode as the harness decodes
    (``trainer.decode_grid``: ``cfg.decode``'s mode, precision and, for the
    parallel model, anchor mode) on ``device``, where ``model`` must live.
    Returns per-sample lists of (majority-vote type, sorted unique edge
    ids). early_stop=False decodes the full token budget (benchmarking)."""
    dev = require_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, inputs would go to {dev}")
    engine = FaceMetrics(cfg.post_process, cfg.model.token)
    batch_size = min(cfg.batch_size_valid, len(raw_samples))

    results: List[List] = []
    for start in range(0, len(raw_samples), batch_size):
        chunk = list(raw_samples[start:start + batch_size])
        valid = len(chunk)
        chunk += [chunk[-1]] * (batch_size - valid)
        batch = collate([pack_input_edges(s["edges"], cfg.model) for s in chunk])
        batch = {k: torch.as_tensor(v).to(model_dev) for k, v in batch.items()}
        predict = decode_grid(model, cfg, batch, early_stop=early_stop).cpu().numpy()
        for i in range(valid):
            grid = predict[i]  # (F, T) parallel, (T,) flat
            out = engine.evaluate_sample(grid, np.zeros_like(grid), chunk[i])
            results.append(out["predictions"])
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="label-free face prediction")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--root", required=True,
                        help="directory containing json/<id>.json wireframes")
    parser.add_argument("--out", default=None,
                        help="output dir (default <root>/pred)")
    parser.add_argument("--reconstruct", action="store_true",
                        help="also lift predictions to PLY wireframes")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    # one process on one card, whatever ranks the training config asked for
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, num_devices=1))
    harness = Harness(cfg, device=args.device)
    state = harness.load(args.ckpt)

    json_dir = os.path.join(args.root, "json")
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(json_dir))
    samples = []
    for name in names:
        with open(os.path.join(json_dir, f"{name}.json")) as f:
            samples.append(json.load(f))

    t0 = time.perf_counter()
    predictions = predict_faces(state["model"], cfg, samples, device=args.device)
    dt = time.perf_counter() - t0
    print(f"decoded {len(samples)} samples in {dt:.2f}s "
          f"({dt / max(len(samples), 1):.3f} s/sample)")

    out_dir = args.out or os.path.join(args.root, "pred")
    os.makedirs(os.path.join(out_dir, "json"), exist_ok=True)
    for name, raw, pred in zip(names, samples, predictions):
        record = {
            "edges": raw["edges"],
            "dominant_directions": raw.get("dominant_directions", []),
            "pred_faces": pred,
            "label_faces": [],
        }
        with open(os.path.join(out_dir, "json", f"{name}.json"), "w") as f:
            json.dump(record, f, cls=NumpyJSONEncoder)

    if args.reconstruct:
        from faceformer_tpu_torch.reconstruction.wireframe import reconstruct_file

        os.makedirs(os.path.join(out_dir, "ply"), exist_ok=True)
        done = sum(reconstruct_file(name, out_dir) for name in names)
        print(f"reconstructed {done}/{len(names)} wireframes -> {out_dir}/ply")


if __name__ == "__main__":
    main()
