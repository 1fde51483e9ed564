"""Shared CLI scaffolding for the reconstruction pipelines (a copy of
faceformer_tpu/reconstruction/runner.py).

Both reconstruct_to_wireframe and reconstruct_to_mesh use the same
per-file contract — idempotent resume-by-skip on existing outputs,
per-item error swallowing with a logged name, and a host process-pool
fan-out (reference: reconstruct_to_wireframe.py:27-31,366-368 and
reconstruct_to_mesh.py:447-451) — differing only in the output subdir,
the reconstructor, and the writer.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence


def process_file(name: str, root: str, out_subdir: str, ext: str,
                 reconstruct_fn: Callable, write_fn: Callable) -> bool:
    """Idempotent per-file step; errors are swallowed and logged so the
    pipeline continues past bad items."""
    out_path = os.path.join(root, out_subdir, f"{name}.{ext}")
    if os.path.exists(out_path):
        return True
    try:
        with open(os.path.join(root, "json", f"{name}.json")) as f:
            data = json.load(f)
        result = reconstruct_fn(data)
        if result is None:
            return False
        write_fn(out_path, result)
        return True
    except Exception as exc:  # per-item fault tolerance
        print(f"{name} failed: {exc}")
        return False


def run_cli(description: str, out_subdir: str, per_file: Callable,
            argv: Optional[Sequence[str]] = None) -> None:
    """argparse + pool runner; ``per_file(name, root) -> bool`` must be a
    module-level callable so the process pool can pickle it."""
    import argparse
    from concurrent.futures import ProcessPoolExecutor

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--root", type=str, default="/root/data")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--num_cores", type=int, default=10)
    args = parser.parse_args(argv)

    os.makedirs(os.path.join(args.root, out_subdir), exist_ok=True)
    if args.name is not None:
        per_file(args.name, args.root)
        return
    names = [os.path.splitext(n)[0]
             for n in os.listdir(os.path.join(args.root, "json"))]
    if args.num_cores > 1:
        with ProcessPoolExecutor(max_workers=args.num_cores) as pool:
            list(pool.map(per_file, names, [args.root] * len(names)))
    else:
        for name in names:
            per_file(name, args.root)
