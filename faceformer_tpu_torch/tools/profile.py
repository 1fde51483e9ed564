"""Trace the decode or the training step under torch.profiler (PyTorch
counterpart of faceformer_tpu/tools/profile.py): a Chrome trace, viewable in
Perfetto or chrome://tracing, the device time by the port's kernel (each
kernel's wrapper launches inside a profiler range, ``ops.launching``) and
the top rows by CUDA kernel name.

    python -m faceformer_tpu_torch.tools.profile --what decode --mode fused --out logs/profile
    python -m faceformer_tpu_torch.tools.profile --what train --config configs/ours.yml

The model is SurfaceFormerParallel drawn from seed 0; the batch is ``--batch``
random wireframes from ``random_sample`` with numpy seed 0, packed by
``ABCDatasetParallel.from_samples`` (the JAX tool's batch, array for array).
``decode`` is a bf16 greedy decode with early stop off; ``train`` is the
bf16 forward, the pointer loss and the backward (the gradients, no
optimizer step), with dropout drawn from seed 1. One untimed call first
(it builds and loads the kernels), then ``--iters`` calls under the
profiler. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

TOP = 10  # rows of the kernel table

# the kernel each wrapper launches, by its LAUNCHES key (ops.launching)
KERNELS = {
    "pointer_argmax": "K1 pointer argmax",
    "pointer_argmax_gather": "K1 pointer argmax",
    "flash_fwd": "K2 flash forward",
    "flash_bwd": "K3 flash backward",
    "decode_step": "K4 fused decode step",
    "decode_gemm": "K4 fused decode step",
}
# trace categories of host calls that launch device work, and of that work
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def synthetic_batch(model_cfg, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """``batch_size`` random wireframes from numpy seed ``seed``, packed and
    collated; the array fields only."""
    from faceformer_tpu_torch.data.batching import collate
    from faceformer_tpu_torch.data.dataset import ABCDatasetParallel
    from faceformer_tpu_torch.geometry.fixtures import random_sample

    rng = np.random.default_rng(seed)
    samples = [random_sample(rng) for _ in range(batch_size)]
    ds = ABCDatasetParallel.from_samples(samples, model_cfg)
    batch = collate([ds[i] for i in range(batch_size)])
    return {k: v for k, v in batch.items() if not isinstance(v, (list, str))}


def device_us_by_kernel(events) -> Dict[str, float]:
    """Device microseconds of a Chrome trace's ``events``, by the kernel
    whose wrapper issued them: a device event belongs to the wrapper whose
    launch range (``ops.launching``) holds, on the same thread, the host
    call that launched it (the two share a ``correlation`` id). So K4's
    attention and pointer phases, which run K2's and K1's device code from
    K4's C entry, count as K4. Device work no wrapper issued (the library's
    and PyTorch's) comes under "other"."""
    import bisect

    from faceformer_tpu_torch import ops

    ranges: Dict[tuple, list] = {}  # (pid, tid) -> sorted (start, end, kernel)
    for ev in events:
        name = ev.get("name", "")
        if ev.get("cat") == "user_annotation" and name.startswith(ops.RANGE):
            ranges.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], ev["ts"] + ev["dur"], KERNELS[name[len(ops.RANGE):]]))
    for spans in ranges.values():
        spans.sort()
    owner: Dict[int, str] = {}  # correlation id -> kernel
    for ev in events:
        corr = ev.get("args", {}).get("correlation")
        spans = ranges.get((ev.get("pid"), ev.get("tid")))
        if ev.get("cat") in _LAUNCH_CATS and corr is not None and spans:
            i = bisect.bisect_right(spans, (ev["ts"], float("inf"), "")) - 1
            if i >= 0 and ev["ts"] <= spans[i][1]:
                owner[corr] = spans[i][2]
    out: Dict[str, float] = {}
    for ev in events:
        if ev.get("cat") in _DEVICE_CATS:
            kernel = owner.get(ev.get("args", {}).get("correlation"), "other")
            out[kernel] = out.get(kernel, 0.0) + ev["dur"]
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--what", choices=["decode", "train"], default="decode")
    parser.add_argument("--config", default="configs/ours.yml")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--out", default=os.path.join("logs", "profile"),
                        help="directory of the Chrome trace")
    parser.add_argument("--mode", default="causal_cache", help="decode engine")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.device import require_device
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.train.loss import pointer_cross_entropy

    dev = require_device(args.device)
    cuda = dev.type == "cuda"
    cfg = load_config(args.config)
    model = SurfaceFormerParallel(cfg.model, generator=torch.Generator().manual_seed(0),
                                  device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg.model, args.batch).items()}

    if args.what == "decode":
        def run():
            with torch.no_grad():
                return model.forward_eval(batch, precision="bf16", mode=args.mode,
                                          early_stop=False)["predict"].cpu()
    else:
        def run():
            model.zero_grad(set_to_none=True)
            out = model.forward_train(batch, generator=torch.Generator().manual_seed(1),
                                      precision="bf16")
            pointer_cross_entropy(out, cfg.model.token)[0].backward()
            return next(model.parameters()).grad.cpu()

    run()  # builds and loads the kernels, fills the allocator's caches
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        dt = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, f"{args.what}.json")
    prof.export_chrome_trace(trace)
    print(f"{args.what}: {args.iters} iters in {dt:.3f}s ({dt / args.iters * 1e3:.1f} ms/iter); "
          f"trace -> {trace}", flush=True)

    rows = prof.key_averages()
    if cuda:
        # CUDA activity rows: the kernels (and copies) the card ran, not the
        # launch ranges' spans on the card, which would count them twice
        kernels = [r for r in rows if r.device_type == torch.autograd.DeviceType.CUDA
                   and not r.key.startswith(ops.RANGE)]
        key, what = (lambda r: r.self_device_time_total), "device"
        with open(trace) as f:
            by_kernel = device_us_by_kernel(json.load(f)["traceEvents"])
        print(f"device ms over {args.iters} iters by the wrapper that launched it: "
              + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in sorted(by_kernel.items())),
              flush=True)
    else:
        kernels, key, what = list(rows), (lambda r: r.self_cpu_time_total), "host (CPU run)"
    total = sum(key(r) for r in kernels) or 1.0
    print(f"{what} ms over {args.iters} iters: total {total / 1e3:.3f}; the top rows by name:",
          flush=True)
    for r in sorted(kernels, key=key, reverse=True)[:TOP]:
        print(f"  {key(r) / 1e3:9.3f} ms {100 * key(r) / total:5.1f} % {r.count:6d}x "
              f"{r.key[:110]}", flush=True)


if __name__ == "__main__":
    main()
