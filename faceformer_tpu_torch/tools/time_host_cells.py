"""Time the two host-bound cells of ``chip_smoke.py`` on one card: the
parallel model's reference decode and the flat model's training step.

    python -m faceformer_tpu_torch.tools.time_host_cells [--reps 7]

- reference decode: ``configs/ours.yml``, 4 random wireframes (numpy seed
  0), bf16, early stop off: faces/s, ``N × num_lines / decode s``;
- flat training step: ``configs/synthetic-dirtok-big.yml``, 32 seeded
  direction-token solids, bf16, dropout 0.2, Adam: samples/s.

Weights are random from seed 0. Each cell runs once untimed (it builds and
loads the kernels), then ``--reps`` timed calls, each synchronized; then
one call under ``torch.profiler``, whose device busy time (the union of
kernel intervals) against its wall time tells the device's work from the
host's. The script uses only entry points that the port has had since its
flat model came (``forward_eval``, ``train_step`` without a world), so it
times an older checkout's package too: copy the file into that checkout's
``faceformer_tpu_torch/tools/`` and run it there, alternating with this
one's. Prints the package's path, the card and its power limit, a line a
cell, and one JSON line of every reading.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PARALLEL_CONFIG = os.path.join(REPO, "configs", "ours.yml")
FLAT_CONFIG = os.path.join(REPO, "configs", "synthetic-dirtok-big.yml")


def busy_ms(fn) -> tuple:
    """(wall ms, device busy ms) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall * 1e3, busy / 1e3


def timed(fn, reps: int) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def reference_cell(dev, reps: int) -> dict:
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.data.batching import collate
    from faceformer_tpu_torch.data.packing import pack_input_edges
    from faceformer_tpu_torch.geometry.fixtures import random_sample
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel

    mc = load_config(PARALLEL_CONFIG).model
    model = SurfaceFormerParallel(mc, generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    samples = []
    while len(samples) < 4:
        sample = random_sample(rng)
        if len(sample["edges"]) <= mc.num_lines:
            samples.append(sample)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             collate([pack_input_edges(s["edges"], mc) for s in samples]).items()
             if not isinstance(v, (list, str))}

    def run():
        with torch.no_grad():
            model.forward_eval(batch, precision="bf16", mode="reference", early_stop=False)

    secs = timed(run, reps)
    wall, busy = busy_ms(run)
    rows = len(samples) * mc.num_lines
    return {"faces_per_s": [rows / s for s in secs], "profiled_wall_ms": wall,
            "device_busy_ms": busy}


def flat_cell(dev, reps: int) -> dict:
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.data.batching import collate
    from faceformer_tpu_torch.data.dataset import ABCDataset
    from faceformer_tpu_torch.data.packing import pack_label_single
    from faceformer_tpu_torch.geometry.fixtures import random_sample
    from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
    from faceformer_tpu_torch.train.step import make_optimizer, train_step

    cfg = load_config(FLAT_CONFIG)
    mc = cfg.model
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, precision="bf16"))
    model = SurfaceFormer(mc, generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    samples = []
    while len(samples) < 32:
        sample = random_sample(rng, profile="rich", direction_token=True)
        if len(sample["edges"]) > mc.num_lines:
            continue
        try:
            pack_label_single(sample["faces_indices"], mc)
        except ValueError:
            continue
        samples.append(sample)
    ds = ABCDataset.from_samples(samples, mc)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             collate([ds[i] for i in range(len(samples))]).items()
             if not isinstance(v, (list, str))}
    optimizer = make_optimizer(model, cfg.trainer)
    dgen = torch.Generator().manual_seed(1)

    def run():
        train_step(model, optimizer, batch, dgen, cfg)

    run()  # a second untimed step: Adam's state exists from here on
    secs = timed(run, reps)
    wall, busy = busy_ms(run)
    return {"samples_per_s": [len(samples) / s for s in secs], "profiled_wall_ms": wall,
            "device_busy_ms": busy}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--label", default="", help="a name for this run in the JSON line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card visible", flush=True)
        return 2
    import faceformer_tpu_torch

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"package {os.path.dirname(faceformer_tpu_torch.__file__)}; {smi.strip()}",
          flush=True)
    out = {"label": args.label, "reference": reference_cell(dev, args.reps),
           "flat_train": flat_cell(dev, args.reps)}
    for cell, key in (("reference", "faces_per_s"), ("flat_train", "samples_per_s")):
        r = out[cell]
        print(f"{args.label} {cell}: {key} median {float(np.median(r[key])):.2f} "
              f"(min {min(r[key]):.2f}, max {max(r[key]):.2f}); one profiled call: wall "
              f"{r['profiled_wall_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms",
              flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
