"""Dataset (re)organization helpers.

A copy of faceformer_tpu/tools/split_jsons.py with its imports renamed to
the port's modules: the same inputs write the same files.

- regenerate seeded train/valid/test splits over an existing json/ directory
  (reference: split_jsons.py:6-34)
- flatten ABC's per-id subfolder layout into flat directories
  (reference: dataset/reorganize_dataset_dirs.py:5-30)
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

from faceformer_tpu_torch.tools.synthetic_data import prepare_splits


def move_flat_jsons(root: str) -> None:
    """Move downloaded flat *.json files into root/json/."""
    json_dir = os.path.join(root, "json")
    os.makedirs(json_dir, exist_ok=True)
    for name in os.listdir(root):
        if name.endswith(".json"):
            shutil.move(os.path.join(root, name), os.path.join(json_dir, name))


def reorganize_abc_dirs(src: str, dst: str, kind: str) -> None:
    """ABC ships <src>/<id>/<files>; flatten to <dst>/<id>.<ext>."""
    os.makedirs(dst, exist_ok=True)
    for obj_id in sorted(os.listdir(src)):
        obj_dir = os.path.join(src, obj_id)
        if not os.path.isdir(obj_dir):
            continue
        for fname in os.listdir(obj_dir):
            if kind in fname or fname.endswith(kind):
                ext = os.path.splitext(fname)[1]
                shutil.move(os.path.join(obj_dir, fname),
                            os.path.join(dst, f"{obj_id}{ext}"))
                break


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="split/reorganize dataset dirs")
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--split", nargs=3, type=float, default=[0.93, 0.02, 0.05])
    parser.add_argument("--move_flat", action="store_true",
                        help="move flat *.json files into root/json first")
    args = parser.parse_args(argv)
    if args.move_flat:
        move_flat_jsons(args.root)
    names = [os.path.splitext(n)[0]
             for n in sorted(os.listdir(os.path.join(args.root, "json")))]
    prepare_splits(args.root, names, split=tuple(args.split), seed=args.seed)
    print(f"split {len(names)} samples")


if __name__ == "__main__":
    main()
