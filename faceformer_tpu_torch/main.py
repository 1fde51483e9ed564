"""Command line of the port: the same surface as the JAX package's main.py,
plus ``--device``.

    python -m faceformer_tpu_torch.main --config-file configs/ours.yml          # train
    python -m faceformer_tpu_torch.main --config-file ... --test_ckpt  <path>   # test
    python -m faceformer_tpu_torch.main --config-file ... --valid_ckpt <path>   # validate
    python -m faceformer_tpu_torch.main --config-file ... --resume_ckpt <path>  # resume
    ... [key value ...]                                                        # overrides

Flags go before the key/value overrides: everything after the first
override is read as overrides. Runs on the card unless ``--device cpu``.
Checkpoint paths ending in .ckpt/.pt/.pth are reference PyTorch
checkpoints, converted on load; any other path is one the port wrote.

``trainer.num_devices`` N > 1 runs N ranks (``parallel/mesh.py``): on one
host this command starts them itself (0 means one a visible card; with
``--device cpu``, N gloo ranks on the CPU); under ``torchrun`` it is one of
the ranks torchrun started. A rank that fails ends the run with an error
and no rank left running.

``main(argv, rank_stats=DIR)`` (what ``tools.train_demos`` calls) has each
process that runs the command, the only one or each rank, write
``DIR/rank<r>.json``: its kernel launches and peak device memory over the
command.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from faceformer_tpu_torch import ops
from faceformer_tpu_torch.config import load_config
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.train.logging import MetricsLogger
from faceformer_tpu_torch.train.trainer import Harness


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SurfaceFormer training (PyTorch port)")
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--valid_ckpt", default="", help="checkpoint to validate")
    parser.add_argument("--test_ckpt", default="", help="checkpoint to test")
    parser.add_argument("--resume_ckpt", default="",
                        help="checkpoint to resume training from")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides as key value pairs")
    return parser


def main(argv: Optional[Sequence[str]] = None, rank_stats: Optional[str] = None) -> None:
    args = get_parser().parse_args(argv)
    cfg = load_config(args.config_file, args.opts)
    ranks = mesh.local_ranks(cfg.trainer.num_devices, args.device)
    if ranks > 1 and "WORLD_SIZE" not in os.environ:
        mesh.spawn(ranks, run, args, rank_stats)
        return
    try:
        run(args, rank_stats)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(args: argparse.Namespace, rank_stats: Optional[str] = None) -> None:
    """The command on this process: the only one, or one of the ranks; with
    ``rank_stats``, then this process's launches and peak memory there."""
    if rank_stats is not None:
        ops.reset_launches()
        if torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats()
    command(args)
    if rank_stats is None:
        return
    rank = int(os.environ.get("RANK", 0))
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
    stats = {"rank": rank, "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
             "max_memory_allocated": peak}
    os.makedirs(rank_stats, exist_ok=True)
    path = os.path.join(rank_stats, f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(stats, f)
    os.replace(path + ".tmp", path)


def command(args: argparse.Namespace) -> None:
    """The command itself, on this process."""
    cfg = load_config(args.config_file, args.opts)
    harness = Harness(cfg, device=args.device)

    if args.test_ckpt:
        state = harness.load(args.test_ckpt)
        harness.test(state["model"])
    elif args.valid_ckpt:
        state = harness.load(args.valid_ckpt)
        logger = MetricsLogger(harness.log_dir) if harness.world.is_writer else None
        harness.validate(state["model"], logger=logger)
        if logger is not None:
            logger.close()
    elif args.resume_ckpt:
        state = harness.load(args.resume_ckpt)
        harness.fit(state)
    else:
        harness.fit()


if __name__ == "__main__":
    main()
