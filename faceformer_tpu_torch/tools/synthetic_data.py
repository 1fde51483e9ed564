"""Synthetic dataset generator CLI: analytic solids -> reference-layout dataset.

A copy of faceformer_tpu/tools/synthetic_data.py, kept so the port imports
nothing of the JAX package: the same arguments write the same files, byte for byte.

Produces the same on-disk layout as the reference's prepare_data.py
(dataset/prepare_data.py:349-375): root/json/<id>.json samples plus
train.txt/valid.txt/test.txt splits (seeded 0.93/0.02/0.05 shuffle,
prepare_data.py:329-346). Works without any CAD kernel; use
tools/prepare_data.py for real ABC STEP files (requires pythonocc).

Acceptance limits mirror the reference's generation-time filters (>64-edge
shapes rejected, prepare_data.py:284-292; overlong face sequences dropped,
filters/filter_length.py:17-29) but are expressed directly against the
target model dims so a corpus provably fits its config:

    # flagship corpus at the reference `ours` dims (L=216, F=42, T=37)
    python -m faceformer_tpu_torch.tools.synthetic_data --root data/synthetic-big \
        --num 8192 --profile rich --max_edges 216 --max_faces 42 --max_face_len 36
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from faceformer_tpu_torch.geometry.fixtures import random_sample


def prepare_splits(root: str, names: Sequence[str], split=(0.93, 0.02, 0.05),
                   seed: int = 42) -> None:
    """Seeded shuffle -> train/valid/test txt files
    (reference: prepare_data.py:329-346)."""
    names = list(names)
    np.random.seed(seed)
    np.random.shuffle(names)
    train_ratio, valid_ratio, _ = split
    n = len(names)
    cut1, cut2 = int(n * train_ratio), int(n * (train_ratio + valid_ratio))
    for fname, chunk in (("train.txt", names[:cut1]),
                         ("valid.txt", names[cut1:cut2]),
                         ("test.txt", names[cut2:])):
        with open(os.path.join(root, fname), "w") as f:
            f.writelines(f"json/{name}.json\n" for name in chunk)


def _face_token_lengths(sample: Dict, direction_token: bool) -> list:
    """Per-face label token counts (excluding the type/terminator token)."""
    lengths = []
    for face in sample["faces_indices"]:
        if direction_token:
            lengths.append(2 * sum(len(loop) for loop in face))
        elif (len(face) == 2 and isinstance(face[0], (int, np.integer))
              and isinstance(face[1], (list, tuple))):
            # coedge flavor with face type: [type, [loop, ...]]
            _ftype, loops = face
            lengths.append(sum(len(loop) for loop in loops))
        elif not len(face) or isinstance(face[0], (int, np.integer)):
            lengths.append(len(face))  # combined flavor: flat sorted list
        else:
            # coedge --no_face_type flavor: bare loop lists
            lengths.append(sum(len(loop) for loop in face))
    return lengths


def sample_stats(sample: Dict, direction_token: bool = False) -> Dict[str, int]:
    lengths = _face_token_lengths(sample, direction_token)
    return {
        "edges": len(sample["edges"]),
        "faces": len(sample["faces_indices"]),
        "max_face_len": max(lengths),
        # flat-sequence label length: each face + 1 SEP, + 1 EOS slot
        "label_len": sum(lengths) + len(lengths) + 1,
    }


def accepts(stats: Dict[str, int], max_edges: int, max_faces: int,
            max_face_len: int, max_label_len: Optional[int]) -> bool:
    if stats["edges"] > max_edges or stats["faces"] > max_faces:
        return False
    if stats["max_face_len"] > max_face_len:
        return False
    if max_label_len is not None and stats["label_len"] > max_label_len:
        return False
    return True


def generate(root: str, num: int, seed: int = 0, coedge: bool = True,
             no_face_type: bool = False, direction_token: bool = False,
             focus: float = 0.0, profile: str = "classic",
             max_edges: int = 64, max_faces: int = 64,
             max_face_len: int = 10 ** 9, max_label_len: Optional[int] = None,
             split=(0.93, 0.02, 0.05)) -> list:
    os.makedirs(os.path.join(root, "json"), exist_ok=True)
    rng = np.random.default_rng(seed)
    names, all_stats, rejected = [], [], 0
    consecutive_rejects = 0
    while len(names) < num:
        sample = random_sample(rng, coedge=coedge, no_face_type=no_face_type,
                               direction_token=direction_token, focus=focus,
                               profile=profile)
        stats = sample_stats(sample, direction_token)
        if not accepts(stats, max_edges, max_faces, max_face_len, max_label_len):
            rejected += 1
            consecutive_rejects += 1
            if consecutive_rejects >= 10_000:
                # unsatisfiable limits would otherwise spin forever with no
                # output (e.g. --max_faces 5 when the smallest solid has 6)
                raise RuntimeError(
                    f"acceptance limits rejected {consecutive_rejects} "
                    f"consecutive samples ({len(names)}/{num} accepted, "
                    f"{rejected} rejected total) — loosen max_edges/"
                    "max_faces/max_face_len/max_label_len")
            continue
        consecutive_rejects = 0
        name = f"{len(names):08d}"
        with open(os.path.join(root, "json", f"{name}.json"), "w") as f:
            json.dump(sample, f)
        names.append(name)
        all_stats.append(stats)
    prepare_splits(root, names, split=split)

    edges = np.array([s["edges"] for s in all_stats])
    faces = np.array([s["faces"] for s in all_stats])
    flen = np.array([s["max_face_len"] for s in all_stats])
    meta = {
        "num": num, "seed": seed, "profile": profile,
        "flavor": ("direction_token" if direction_token
                   else "coedge" if coedge else "combined"),
        "focus": focus, "rejected": rejected,
        "limits": {"max_edges": max_edges, "max_faces": max_faces,
                   "max_face_len": max_face_len, "max_label_len": max_label_len},
        "edges": {"min": int(edges.min()), "mean": float(edges.mean()),
                  "p90": int(np.percentile(edges, 90)), "max": int(edges.max())},
        "faces": {"min": int(faces.min()), "mean": float(faces.mean()),
                  "max": int(faces.max())},
        "face_len": {"mean": float(flen.mean()), "max": int(flen.max())},
    }
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return names


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="synthetic dataset generator")
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--num", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", type=str, default="classic",
                        choices=("classic", "rich"),
                        help="solid families: classic = 6 basic fixtures; "
                             "rich adds composite solids (holes/bosses/"
                             "pockets/towers/notched extrusions/shafts)")
    parser.add_argument("--combine_coedge", action="store_true",
                        help="one token per undirected edge (seq2seq flavor)")
    parser.add_argument("--no_face_type", action="store_true")
    parser.add_argument("--direction_token", action="store_true",
                        help="combined edges + (index, orientation) labels")
    parser.add_argument("--focus", type=float, default=0.0,
                        help="0 = orthographic; >0 = perspective focal length")
    parser.add_argument("--max_edges", type=int, default=None,
                        help="reject samples with more interned edges than "
                             "this (default: 128 coedge flavor, 64 combined "
                             "— the reference's 64-edge generation filter)")
    parser.add_argument("--max_faces", type=int, default=64)
    parser.add_argument("--max_face_len", type=int, default=10 ** 9,
                        help="reject samples whose longest face exceeds this "
                             "many label tokens (parallel models: <= T-1)")
    parser.add_argument("--max_label_len", type=int, default=None,
                        help="reject samples whose flat label sequence "
                             "exceeds this (flat models: <= label_seq_length)")
    args = parser.parse_args(argv)
    coedge = not args.combine_coedge and not args.direction_token
    max_edges = args.max_edges
    if max_edges is None:
        max_edges = 128 if coedge else 64
    names = generate(args.root, args.num, seed=args.seed, coedge=coedge,
                     no_face_type=args.no_face_type,
                     direction_token=args.direction_token, focus=args.focus,
                     profile=args.profile, max_edges=max_edges,
                     max_faces=args.max_faces, max_face_len=args.max_face_len,
                     max_label_len=args.max_label_len)
    with open(os.path.join(args.root, "meta.json")) as f:
        print(json.dumps(json.load(f)))
    print(f"wrote {len(names)} samples under {args.root}")


if __name__ == "__main__":
    main()
