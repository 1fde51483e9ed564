"""Byte-level fuzz of the port's C++ JSON loader (csrc/host/dataloader.cc;
the PyTorch port's counterpart of the root tools/fuzz_native_loader.py).

Mutates a real corpus sample (flip/delete/insert bytes), adds pathological
payloads (empty, truncated, oversized numbers, out-of-range indices) and
feeds them all through the threaded pack path of ``data/native_loader.py``.
Every input must either pack or land in ``failed``, and the process must
not crash:

    python -m faceformer_tpu_torch.tools.fuzz_native_loader --root data/synthetic-big --num 300

Prints one line, "<n> inputs: <f> failed cleanly, <p> parsed, no crash",
and exits 0; exits 1 when the root holds no sample.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import sys
import tempfile
import warnings
from typing import List


def pathological(base: bytes) -> List[bytes]:
    return [
        b"", b"{", b"[", b'{"edges":', base[: len(base) // 2],
        b'{"edges": [[[1e400, 2]]], "faces_indices": []}',
        b'{"edges": [], "faces_indices": [[0]]}',
        b'{"edges": [[[0,0],[1,1]]], "faces_indices": [[999]]}',
    ]


def mutate(base: bytes, rng: random.Random) -> bytes:
    buf = bytearray(base)
    for _ in range(rng.randint(1, 20)):
        i = rng.randrange(len(buf))
        op = rng.random()
        if op < 0.4:
            buf[i] = rng.randrange(256)
        elif op < 0.7:
            del buf[i]
        else:
            buf.insert(i, rng.randrange(256))
    return bytes(buf)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default="data/synthetic-big")
    parser.add_argument("--config", default="configs/synthetic-big.yml")
    parser.add_argument("--num", type=int, default=300, help="mutated inputs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--workdir", default="",
                        help="where the inputs are written (default: a new temporary directory)")
    args = parser.parse_args(argv)

    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.data import native_loader

    cfg = load_config(args.config).model
    paths = sorted(glob.glob(os.path.join(args.root, "json", "*.json")))
    if not paths:
        print(f"no samples under {args.root}/json")
        return 1
    with open(paths[0], "rb") as f:
        base = f.read()
    workdir = args.workdir or tempfile.mkdtemp(prefix="fuzz_native_")
    os.makedirs(workdir, exist_ok=True)
    rng = random.Random(args.seed)
    payloads = [(f"{k:05d}", mutate(base, rng)) for k in range(args.num)]
    payloads += [(f"p{k}", p) for k, p in enumerate(pathological(base))]
    fuzz_paths = []
    for name, payload in payloads:
        path = os.path.join(workdir, f"{name}.json")
        with open(path, "wb") as f:
            f.write(payload)
        fuzz_paths.append(path)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the per-file warning
        out = native_loader.load_pack_files(fuzz_paths, cfg, parallel=True,
                                            n_threads=args.threads)
    n_fail = len(out["failed"]) if out is not None else len(fuzz_paths)
    print(f"{len(fuzz_paths)} inputs: {n_fail} failed cleanly, "
          f"{len(fuzz_paths) - n_fail} parsed, no crash")
    return 0


if __name__ == "__main__":
    sys.exit(main())
