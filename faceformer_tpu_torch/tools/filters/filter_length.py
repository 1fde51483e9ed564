"""Length filter: drop shapes whose flat face sequence would exceed the
label budget or whose edge count exceeds the encoder budget
(reference: dataset/filters/filter_length.py:17-29).

A copy of faceformer_tpu/tools/filters/filter_length.py with its imports renamed to
the port's modules: the same inputs write the same files.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence


def sequence_length(faces_indices) -> int:
    """[SOS] + per-face (tokens + SEP) with the final SEP as EOS.

    Reference-literal count (filters/filter_length.py:22-24): 1+len(face)
    per face. For nested no_face_type faces this counts LOOPS, and for
    direction_token faces it misses the 2-tokens-per-pair packing — the
    reference's shipped filtered_id_list.json was built with exactly this
    count, so it is kept as the selection contract. True packed-budget
    enforcement lives where it is exact: synthetic_data's acceptance
    limits and pack_label_single's explicit budget error."""
    total = 1
    for face in faces_indices:
        total += 1 + len(face)
    return total


def filter_length(root: str, names: Sequence[str], face_seq_max: int = 128,
                  num_edge_max: int = 64) -> List[str]:
    kept = []
    for name in names:
        with open(os.path.join(root, "json", f"{name}.json")) as f:
            data = json.load(f)
        if (sequence_length(data["faces_indices"]) < face_seq_max
                and len(data["edges"]) < num_edge_max):
            kept.append(name)
    return kept


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--face_seq_max", type=int, default=128)
    parser.add_argument("--num_edge_max", type=int, default=64)
    parser.add_argument("--id_list", type=str, default="",
                        help="optional id-list JSON to start from")
    parser.add_argument("--out", type=str, default="filtered_id_list.json")
    args = parser.parse_args(argv)

    if args.id_list and os.path.exists(args.id_list):
        with open(args.id_list) as f:
            names = json.load(f)
    else:
        names = [os.path.splitext(n)[0]
                 for n in os.listdir(os.path.join(args.root, "json"))]
    kept = filter_length(args.root, names, args.face_seq_max, args.num_edge_max)
    with open(args.out, "w") as f:
        json.dump(kept, f)
    print(f"kept {len(kept)}/{len(names)}")


if __name__ == "__main__":
    main()
