"""Dataset integrity checker CLI: verify every face of every sample is a
closed loop chain; optionally delete offenders
(reference: dataset/tests/check_faces_enclosed.py:48-94).

A copy of faceformer_tpu/tools/check_faces_enclosed.py with its imports renamed to
the port's modules: the same inputs write the same files.

Flavor-aware beyond the reference: the reference checker only understands
the directed-coedge JSON layout (its combined/direction_token corpora are
asserted enclosed pre-merge during generation, prepare_data.py:155-158, and
cannot be re-validated from disk). Here every flavor written by
tools/synthetic_data.py or tools/prepare_data.py is checked:

  coedge + face type   faces_indices entry = [type, [loop, ...]]
  coedge --no_face_type entry = [loop, ...]               (directed walk)
  --combine_coedge      entry = flat sorted SET of undirected edges (order-
                        free cycle check, is_face_enclosed_undirected)
  --direction_token     entry = [[(edge, orient), ...], ...] loops of pairs

The flavor comes from the corpus meta.json when present, else from the
entry structure; --flavor overrides both.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence, Tuple

from faceformer_tpu_torch.geometry.enclosedness import is_face_enclosed

FLAVORS = ("coedge", "combined", "direction_token")


def is_face_enclosed_undirected(
    edges: Sequence[Sequence[Sequence[float]]],
    face_indices: Sequence[int],
    tol: float,
):
    """Enclosedness check for UNDIRECTED edge-token faces (combined flavor).

    A copy of faceformer_tpu/geometry/enclosedness.py's, kept here since
    the port's enclosedness module holds only the directed walk.

    The combined-coedge data flavor (reference prepare_data.py
    --combine_coedge) stores each face as a *sorted set* of undirected edge
    tokens — no chain order, no orientation — so the reference only asserts
    enclosedness *before* coedges are merged (prepare_data.py:155-158) and
    its checker CLI cannot re-validate the merged corpora from disk. The
    order-free invariant: the face's edge multiset decomposes into closed
    loops, which holds iff no endpoint vertex has odd degree (endpoints
    clustered within per-axis ``tol``). Out-of-range indices are skipped
    like :func:`is_face_enclosed`. Returns the decomposition as connected
    components (index lists) or False.
    """
    idx = [i for i in face_indices if i < len(edges)]
    reps: List[Tuple[float, float]] = []  # vertex-cluster representatives

    def vert(p) -> int:
        for vi, q in enumerate(reps):
            if abs(p[0] - q[0]) < tol and abs(p[1] - q[1]) < tol:
                return vi
        reps.append((p[0], p[1]))
        return len(reps) - 1

    degree: dict = {}
    endpoints: List[Tuple[int, int, int]] = []
    for i in idx:
        a, b = vert(edges[i][0]), vert(edges[i][-1])
        degree[a] = degree.get(a, 0) + 1
        degree[b] = degree.get(b, 0) + 1
        endpoints.append((i, a, b))
    if any(d % 2 for d in degree.values()):
        return False

    parent = list(range(len(reps)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for _, a, b in endpoints:
        parent[find(a)] = find(b)
    components: dict = {}
    for i, a, _ in endpoints:
        components.setdefault(find(a), []).append(i)
    return list(components.values())


def _detect_flavor(entry) -> str:
    """Structural flavor guess for one faces_indices entry."""
    if not entry:
        return "coedge"
    if isinstance(entry[0], int):
        # [type, [loops]] is the face-typed coedge layout; a flat int list
        # is the combined (undirected single-sequence) layout
        if len(entry) == 2 and isinstance(entry[1], list):
            return "coedge"
        return "combined"
    first_loop = entry[0]
    if (first_loop and isinstance(first_loop[0], (list, tuple))
            and len(first_loop[0]) == 2 and first_loop[0][1] in (0, 1)):
        return "direction_token"
    return "coedge"


def _faces_for_check(data: dict, flavor: str) -> List[Tuple[list, bool]]:
    """Flatten faces_indices into (face_index_list, undirected) pairs."""
    faces: List[Tuple[list, bool]] = []
    for entry in data["faces_indices"]:
        kind = flavor if flavor in FLAVORS else _detect_flavor(entry)
        if kind == "combined":
            faces.append((entry, True))
        elif kind == "direction_token":
            faces.append(([tuple(p) for loop in entry for p in loop], False))
        elif entry and isinstance(entry[0], int):
            faces.append(([i for loop in entry[1] for i in loop], False))
        else:
            faces.append(([i for loop in entry for i in loop], False))
    return faces


def check_sample(path: str, tol: float, flavor: str = "auto") -> bool:
    with open(path) as f:
        data = json.load(f)
    edges = data["edges"]
    for face, undirected in _faces_for_check(data, flavor):
        check = is_face_enclosed_undirected if undirected else is_face_enclosed
        if not check(edges, face, tol):
            return False
    return True


def _corpus_flavor(root: str) -> str:
    meta = os.path.join(root, "meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            flavor = json.load(f).get("flavor")
        if flavor in FLAVORS:
            return flavor
    return "auto"


def _check_one(args: Tuple[str, float, str]) -> bool:
    return check_sample(*args)


def check_dataset(root: str, tol: float = 3e-4, remove: bool = False,
                  names: Optional[Sequence[str]] = None,
                  flavor: str = "auto", num_cores: int = 1,
                  chunksize: int = 10) -> List[str]:
    """Returns the names that FAILED the check."""
    if flavor == "auto":
        flavor = _corpus_flavor(root)
    json_dir = os.path.join(root, "json")
    if names is None:
        names = [os.path.splitext(n)[0] for n in sorted(os.listdir(json_dir))]
    paths = [os.path.join(json_dir, f"{name}.json") for name in names]
    if num_cores > 1:  # host-pool fan-out, reference process_map surface
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(max_workers=num_cores) as pool:
            oks = list(pool.map(_check_one, [(p, tol, flavor) for p in paths],
                                chunksize=chunksize))
    else:
        oks = [check_sample(p, tol, flavor) for p in paths]
    bad = []
    for name, path, ok in zip(names, paths, oks):
        if not ok:
            bad.append(name)
            print(f"{name} contains unclosed face")
            if remove:
                os.remove(path)
    return bad


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="face enclosedness integrity check")
    parser.add_argument("--root", type=str, default="./data")
    parser.add_argument("--name", type=str, default=None)
    # discretization tolerance is 1e-4 -> default check tolerance 3e-4
    parser.add_argument("--tol", type=float, default=3e-4)
    parser.add_argument("--flavor", type=str, default="auto",
                        choices=("auto",) + FLAVORS,
                        help="face layout; default reads the corpus "
                             "meta.json, falling back to per-entry structure")
    parser.add_argument("--remove", action="store_true")
    # host fan-out, same surface as the reference's process_map
    # (check_faces_enclosed.py:81-85)
    parser.add_argument("--num_cores", type=int, default=1)
    parser.add_argument("--num_chunks", type=int, default=10)
    args = parser.parse_args(argv)
    names = [args.name] if args.name else None
    bad = check_dataset(args.root, args.tol, args.remove, names, args.flavor,
                        args.num_cores, args.num_chunks)
    print(f"{len(bad)} bad samples")


if __name__ == "__main__":
    main()
