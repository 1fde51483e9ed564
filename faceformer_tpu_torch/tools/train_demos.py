"""The demo-training queue: each stage trains one recipe at one seed, then
tests its best checkpoint (the port's counterpart of the root
``tools/train_demos.sh``, ``tools/best_ckpt.py`` and
``tools/aggregate_results.py``).

    python -m faceformer_tpu_torch.tools.train_demos run flat-s0 flat-s1 flat-s2 \\
        [--jobs 3] [--out DIR] [--device cpu] [key value ...]
    python -m faceformer_tpu_torch.tools.train_demos summary \\
        torch-seq2seq-big-s0 torch-seq2seq-big-s1 [--log_root logs/SurfaceFormer]
    python -m faceformer_tpu_torch.tools.train_demos digest data/synthetic-flat-big

``run``: flags go before the stages, and the key/value overrides after
them are passed on to ``faceformer_tpu_torch.main`` (``root_dir``,
``trainer.max_epochs``, ...); the stage's ``trainer.version`` and
``trainer.seed`` come last and win. A stage ``<family>-s<seed>`` takes the
family's config (``STAGES``; paths from the repository's root) with
version ``torch-<version>-s<seed>``, and runs in a process of its own:
it fits, then tests the checkpoint ``CheckpointManager.best_path`` names
(top-1 by ``valid_precision``, else ``last``), prints that path and one
``STAGE {...}`` JSON line (the tested checkpoint, ``results.json``, and
each phase's seconds, rank count and each rank's kernel launches and peak
device memory, which every process of the phase writes under the log's
``rank_stats/``, with the launches summed over the ranks; and the fit's
epochs, each with its seconds split as ``metrics.jsonl`` records it:
``fit_epochs``). A stage
whose fit fails is not tested, so no stale checkpoint writes
``results.json``. ``--jobs N`` runs N stages at a time, each its own
process on the same card; the command waits for every stage and exits
non-zero if any failed. ``--out DIR`` copies each version's audit files
(``metrics.jsonl``, ``results.json``, ``checkpoints/*.meta.json``,
``checkpoints/index.json``: what ``.gitignore`` keeps of a log) into
``DIR/<version>/``. Logs land under ``logs/`` of the working directory,
as ``main`` writes them. Stages run on the card unless ``--device cpu``.

``summary``: per metric the mean, min and max over the versions'
``results.json``, as one JSON line. ``digest``: sha256 over a corpus's
``json/*.json`` (name and bytes, in name order) and its three split files.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

MODULE = "faceformer_tpu_torch.tools.train_demos"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: family -> (config from the repository's root, version stem): the root
#: tools/train_demos.sh's table
STAGES = {
    "flagship": ("configs/synthetic-big.yml", "big"),
    "flat": ("configs/synthetic-seq2seq-big.yml", "seq2seq-big"),
    "dirtok": ("configs/synthetic-dirtok-big.yml", "dirtok-big"),
    "coedge": ("configs/synthetic-coedge-big.yml", "coedge-big"),
}
VERSION_PREFIX = "torch-"
STAGE_NAME = re.compile(r"^([a-z]+)-s(\d+)$")
METRICS = ("test_precision", "test_recall", "test_type_acc")
SPLIT_FILES = ("train.txt", "valid.txt", "test.txt")


def stage_spec(stage: str) -> Tuple[str, str, int]:
    """(config path, version, seed) of a stage named ``<family>-s<seed>``."""
    match = STAGE_NAME.match(stage)
    if match is None or match.group(1) not in STAGES:
        raise ValueError(f"unknown stage {stage!r}: expected <family>-s<seed> with family "
                         f"in {sorted(STAGES)}")
    config, stem = STAGES[match.group(1)]
    seed = int(match.group(2))
    return os.path.join(REPO, config), f"{VERSION_PREFIX}{stem}-s{seed}", seed


def stage_options(stage: str, overrides: Sequence[str]) -> Tuple[str, List[str], str]:
    """(config path, key/value options, log directory) of a stage under
    ``overrides``."""
    from faceformer_tpu_torch.config import load_config

    config, version, seed = stage_spec(stage)
    opts = [*overrides, "trainer.version", version, "trainer.seed", str(seed)]
    cfg = load_config(config, opts)
    return config, opts, os.path.join("logs", cfg.trainer.name, cfg.trainer.version)


def best_ckpt(log_dir: str) -> str:
    """The checkpoint a fit in ``log_dir`` offers for testing:
    ``CheckpointManager.best_path`` over its index."""
    from faceformer_tpu_torch.train.checkpoint import CheckpointManager

    path = CheckpointManager(os.path.join(log_dir, "checkpoints")).best_path()
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {log_dir}")
    return path


def _phase(argv: Sequence[str], stats_dir: str, ranks: int) -> Dict:
    """``main.main(argv)``; its seconds, and each of its ``ranks`` processes'
    kernel launches and peak device memory (``by_rank``, from the file each
    wrote under ``stats_dir``: ranks are processes of their own), with the
    launches summed over the ranks and the largest peak."""
    from faceformer_tpu_torch import main

    shutil.rmtree(stats_dir, ignore_errors=True)
    t0 = time.perf_counter()
    main.main(argv, rank_stats=stats_dir)
    seconds = time.perf_counter() - t0
    by_rank = []
    for r in range(ranks):
        path = os.path.join(stats_dir, f"rank{r}.json")
        if not os.path.isfile(path):
            raise RuntimeError(f"rank {r} of {ranks} wrote no counts to {stats_dir}")
        with open(path) as f:
            by_rank.append(json.load(f))
    launches: Dict[str, int] = {}
    for stats in by_rank:
        for k, v in stats["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"seconds": seconds, "ranks": ranks, "launches": launches,
            "max_memory_allocated": max(s["max_memory_allocated"] for s in by_rank),
            "by_rank": by_rank}


#: an epoch record's seconds (train/trainer.py::Harness.fit)
EPOCH_SECONDS = ("epoch_train_seconds", "train_host_batch_seconds",
                 "train_host_dispatch_seconds", "train_step_span_seconds")


def fit_epochs(log_dir: str) -> List[Dict]:
    """The last fit's epochs from the version's ``metrics.jsonl``: each
    epoch's steps, its EPOCH_SECONDS (the wall; the host's seconds in the
    batches and in queueing the steps; the steps' span on the card's
    stream, by CUDA events) and the same as ms a step."""
    epochs: List[Dict] = []
    last = 0
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            record = json.loads(line)
            if "epoch_train_seconds" not in record:
                continue
            if record["step"] <= last:  # an earlier run's records end here
                epochs, last = [], 0
            steps, last = record["step"] - last, record["step"]
            seconds = {k: record[k] for k in EPOCH_SECONDS}
            epochs.append({"steps": steps, "seconds": seconds,
                           "ms_a_step": {k.replace("_seconds", "_ms"): v * 1e3 / steps
                                         for k, v in seconds.items()}})
    return epochs


def run_stage(stage: str, device: str, overrides: Sequence[str]) -> Dict:
    """One stage in this process: fit, then test the best checkpoint. A
    failed fit raises before any test."""
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.parallel import mesh

    config, opts, log_dir = stage_options(stage, overrides)
    _, version, seed = stage_spec(stage)
    ranks = mesh.local_ranks(load_config(config, opts).trainer.num_devices, device)
    flags = ["--config-file", config, "--device", device]
    stats = os.path.join(log_dir, "rank_stats")
    fit = _phase([*flags, *opts], os.path.join(stats, "fit"), ranks)
    fit["epochs"] = fit_epochs(log_dir)
    ckpt = best_ckpt(log_dir)
    print(f"{stage}: testing {ckpt}", flush=True)
    test = _phase([*flags, "--test_ckpt", ckpt, *opts], os.path.join(stats, "test"), ranks)
    with open(os.path.join(log_dir, "results.json")) as f:
        results = json.load(f)
    record = {"stage": stage, "config": os.path.relpath(config, REPO),
              "version": version, "seed": seed, "log_dir": log_dir,
              "tested_ckpt": ckpt, "results": results, "fit": fit, "test": test}
    print("STAGE " + json.dumps(record), flush=True)
    return record


def copy_audit_files(log_dir: str, out: str) -> None:
    """Copy those of a version's audit files that exist into ``out``."""
    rels = [rel for rel in ("metrics.jsonl", "results.json", "checkpoints/index.json")
            if os.path.isfile(os.path.join(log_dir, rel))]
    pattern = os.path.join(glob.escape(log_dir), "checkpoints", "*.meta.json")
    rels += [os.path.relpath(p, log_dir) for p in glob.glob(pattern)]
    for rel in rels:
        os.makedirs(os.path.join(out, os.path.dirname(rel)), exist_ok=True)
        shutil.copyfile(os.path.join(log_dir, rel), os.path.join(out, rel))


def _child_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def run_stages(stages: Sequence[str], device: str, overrides: Sequence[str], jobs: int = 1,
               out: Optional[str] = None) -> int:
    """Every stage in a process of its own, ``jobs`` at a time; 0 when all
    succeeded, else 1, after every stage has ended."""
    # every name and config read before any stage starts
    log_dirs = [stage_options(stage, overrides)[2] for stage in stages]

    def one(stage: str) -> int:
        print(f"=== stage {stage} start {time.strftime('%H:%M:%S')}", flush=True)
        rc = subprocess.run([sys.executable, "-m", MODULE, "stage", "--device", device, stage,
                             *overrides], env=_child_env()).returncode
        word = "done" if rc == 0 else f"FAILED (exit code {rc})"
        print(f"=== stage {stage} {word} {time.strftime('%H:%M:%S')}", flush=True)
        return rc

    with concurrent.futures.ThreadPoolExecutor(max_workers=jobs) as pool:
        rcs = dict(zip(stages, pool.map(one, stages)))
    if out is not None:
        for log_dir in log_dirs:
            copy_audit_files(log_dir, os.path.join(out, os.path.basename(log_dir)))
    failed = [s for s, rc in rcs.items() if rc != 0]
    if failed:
        print(f"failed stages: {' '.join(failed)}", file=sys.stderr, flush=True)
    return 1 if failed else 0


def aggregate(versions: Sequence[str], log_root: str = "logs/SurfaceFormer") -> Dict:
    """Per metric the mean, min and max over the versions' ``results.json``
    (rounded to 4 places), the rows themselves, the seed count and the test
    sample count (a list when the versions differ)."""
    rows = {}
    for v in versions:
        with open(os.path.join(log_root, v, "results.json")) as f:
            rows[v] = json.load(f)
    summary = {"versions": rows, "n_seeds": len(versions)}
    for m in METRICS:
        vals = [rows[v][m] for v in versions]
        summary[m] = {"mean": round(sum(vals) / len(vals), 4), "min": round(min(vals), 4),
                      "max": round(max(vals), 4)}
    ns = {rows[v]["num_samples"] for v in versions}
    summary["num_samples"] = ns.pop() if len(ns) == 1 else sorted(ns)
    return summary


def corpus_digest(root: str) -> Dict:
    """sha256 over ``root/json/*.json`` (each file's name and bytes, in name
    order) and the three split files, with the counts."""
    h = hashlib.sha256()
    names = sorted(os.listdir(os.path.join(root, "json")))
    for name in names:
        with open(os.path.join(root, "json", name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    split = []
    for name in SPLIT_FILES:
        with open(os.path.join(root, name), "rb") as f:
            data = f.read()
        h.update(name.encode() + b"\0" + data + b"\0")
        split.append(len(data.split()))
    return {"json": len(names), "split": split, "sha256": h.hexdigest()}


def split_stages(args: Sequence[str]) -> Tuple[List[str], List[str]]:
    """The leading stage names of ``args``, and the key/value overrides after them."""
    n = 0
    while n < len(args) and STAGE_NAME.match(args[n]):
        n += 1
    stages, overrides = list(args[:n]), list(args[n:])
    if len(overrides) % 2:
        raise SystemExit(f"overrides come in key value pairs: {overrides}")
    return stages, overrides


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("run", "stage"):
        p = sub.add_parser(name, help="train and test stages" if name == "run"
                           else "one stage in this process (what run starts)")
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default: the card)")
        if name == "run":
            p.add_argument("--jobs", type=int, default=1, help="stages run at a time")
            p.add_argument("--out", default=None,
                           help="copy each version's audit files into OUT/<version>/")
        p.add_argument("args", nargs=argparse.REMAINDER,
                       help="stage names, then config overrides as key value pairs")
    p = sub.add_parser("summary", help="mean/min/max of versions' results.json")
    p.add_argument("versions", nargs="+")
    p.add_argument("--log_root", default="logs/SurfaceFormer")
    p = sub.add_parser("digest", help="sha256 of a corpus's JSONs and splits")
    p.add_argument("root")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    if args.command == "summary":
        print(json.dumps(aggregate(args.versions, args.log_root)), flush=True)
        return 0
    if args.command == "digest":
        print(json.dumps({"root": args.root, **corpus_digest(args.root)}), flush=True)
        return 0
    stages, overrides = split_stages(args.args)
    if not stages:
        raise SystemExit("name at least one stage, e.g. flat-s0")
    if len(set(stages)) != len(stages):
        raise SystemExit(f"a stage named twice would write one log twice: {stages}")
    if args.command == "stage":
        if len(stages) != 1:
            raise SystemExit("stage runs one stage")
        run_stage(stages[0], args.device, overrides)
        return 0
    if args.jobs < 1:
        raise SystemExit(f"--jobs must be at least 1, not {args.jobs}")
    return run_stages(stages, args.device, overrides, jobs=args.jobs, out=args.out)


if __name__ == "__main__":
    sys.exit(main())
