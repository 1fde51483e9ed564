"""Thickness filter: drop near-double-wall shapes where two annotated
feature curves run closer than a threshold in both directions
(reference: dataset/filters/filter_thickness.py:27-118). trimesh-free:
meshes load through the minimal OBJ reader.

A copy of faceformer_tpu/tools/filters/filter_thickness.py with its imports renamed to
the port's modules: the same inputs write the same files.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
from scipy.spatial.distance import cdist

from faceformer_tpu_torch.tools.objio import load_obj, scale_to_unit_sphere

MAX_VALUE = 10.0
EPS = 1e-8


def dist_p2p(vertices, verts_i, verts_j) -> float:
    d = cdist(vertices[verts_i], vertices[verts_j])
    return float(np.mean(np.min(d, axis=1)))


def dist_p2l(vertices, verts_i, verts_j) -> float:
    """Mean distance from curve-i samples to the polyline of curve j
    (reference :27-53): point-to-segment where the projection falls inside
    the segment, point-to-endpoint otherwise."""
    edges = np.stack([verts_j[:-1], verts_j[1:]], axis=1)
    vec = vertices[edges[:, 1]] - vertices[edges[:, 0]]
    length = np.linalg.norm(vec, axis=1, keepdims=True) + EPS
    tangent = vec / length

    rel = vertices[verts_i][:, None] - vertices[edges[:, 0]][None]
    prop = np.sum(rel * tangent[None], axis=-1) / length.reshape(1, -1)
    perp = prop[..., None] * vec[None] - rel
    pl = np.linalg.norm(perp, axis=-1)
    pl[~((prop > 0) & (prop < 1))] = MAX_VALUE

    pp = cdist(vertices[verts_i], vertices[edges].reshape(-1, 3))
    pp = pp.reshape(-1, len(edges), 2).min(axis=-1)
    return float(np.mean(np.min(np.minimum(pl, pp), axis=1)))


def passes_thickness(root: str, name: str, threshold: float = 0.05,
                     p2p: bool = False) -> Optional[str]:
    import yaml

    vertices, _ = load_obj(os.path.join(root, "obj", f"{name}.obj"))
    vertices = scale_to_unit_sphere(vertices)
    with open(os.path.join(root, "feat", f"{name}.yml")) as f:
        annos = yaml.full_load(f)
    curves = [np.asarray(c["vert_indices"]).reshape(-1) for c in annos["curves"]]
    if any(c.max(initial=-1) >= len(vertices) for c in curves):
        print(f"{name} has out-of-range curve vertices")
        return None

    metric = dist_p2p if p2p else dist_p2l
    for i in range(len(curves)):
        for j in range(i + 1, len(curves)):
            if (metric(vertices, curves[i], curves[j]) < threshold
                    and metric(vertices, curves[j], curves[i]) < threshold):
                return None
    return name


def main(argv: Optional[Sequence[str]] = None) -> None:
    from concurrent.futures import ProcessPoolExecutor
    from functools import partial

    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--id_list", type=str, default="filtered_id_list.json")
    parser.add_argument("--threshold", type=float, default=0.05)
    parser.add_argument("--num_cores", type=int, default=10)
    parser.add_argument("--p2p", action="store_true")
    parser.add_argument("--out", type=str, default="filtered_thickness.json")
    args = parser.parse_args(argv)

    with open(args.id_list) as f:
        names = json.load(f)
    fn = partial(passes_thickness, args.root, threshold=args.threshold, p2p=args.p2p)
    if args.num_cores > 1:
        with ProcessPoolExecutor(max_workers=args.num_cores) as pool:
            rets = list(pool.map(fn, names))
    else:
        rets = [fn(n) for n in names]
    kept = [r for r in rets if r is not None]
    with open(args.out, "w") as f:
        json.dump(kept, f)
    print(f"kept {len(kept)}/{len(names)}")


if __name__ == "__main__":
    main()
