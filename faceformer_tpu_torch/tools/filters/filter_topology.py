"""Topology filter: bin objects with identical/near-identical topology stats
(reference: dataset/filters/filter_topology.py:21-71).

A copy of faceformer_tpu/tools/filters/filter_topology.py with its imports renamed to
the port's modules: the same inputs write the same files.

Feature per object = (#edges, #parts, #sharp, #surfs) + curve-type and
surface-type histograms from ABC `stat/*.yml`; bins come from radius
neighbors over those integer features; error-log ids are excluded first.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

TYPES_OF_CURVES = {"Line": 0, "Circle": 1, "Ellipse": 2, "BSpline": 3, "Other": 4}
TYPES_OF_SURFS = {"Plane": 0, "Cylinder": 1, "Cone": 2, "Sphere": 3, "Torus": 4,
                  "Revolution": 5, "Extrusion": 6, "BSpline": 7, "Other": 8}


def topology_feature(stat: dict) -> List[int]:
    # unlisted types (OCC also produces Hyperbola/Parabola/Bezier/...)
    # histogram under "Other" instead of KeyError-aborting the whole run —
    # the reference indexes directly (filter_topology.py:47-48) but its
    # Other entry makes the intended fallback clear
    curves_hist = [0] * len(TYPES_OF_CURVES)
    for curve in stat["curves"]:
        curves_hist[TYPES_OF_CURVES.get(curve, TYPES_OF_CURVES["Other"])] += 1
    surfs_hist = [0] * len(TYPES_OF_SURFS)
    for surf in stat["surfs"]:
        surfs_hist[TYPES_OF_SURFS.get(surf, TYPES_OF_SURFS["Other"])] += 1
    return [stat["#edges"], stat["#parts"], stat["#sharp"], stat["#surfs"],
            *curves_hist, *surfs_hist]


def bin_by_topology(features, names, threshold: float = 0.0) -> List[List[str]]:
    from sklearn.neighbors import NearestNeighbors

    neigh = NearestNeighbors()
    neigh.fit(features)
    _, indices = neigh.radius_neighbors(features, threshold)
    bins = {tuple(sorted(ind)) for ind in indices}
    return [[names[i] for i in b] for b in bins]


def main(argv: Optional[Sequence[str]] = None) -> None:
    import yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--error_log", type=str, default="")
    parser.add_argument("--similarity_threshold", type=float, default=0.0)
    parser.add_argument("--out", type=str, default="topo_matching_bins.json")
    args = parser.parse_args(argv)

    names = sorted(n[:8] for n in os.listdir(os.path.join(args.root, "stat")))
    if args.error_log and os.path.exists(args.error_log):
        with open(args.error_log) as f:
            errors = {line[:8] for line in f.read().splitlines() if line[:8].isdigit()}
        names = [n for n in names if n not in errors]

    features = []
    for name in names:
        with open(os.path.join(args.root, "stat", f"{name}.yml")) as f:
            features.append(topology_feature(yaml.safe_load(f)))

    bins = bin_by_topology(features, names, args.similarity_threshold)
    with open(args.out, "w") as f:
        json.dump(bins, f)
    print(f"{len(names)} objects -> {len(bins)} topology bins")


if __name__ == "__main__":
    main()
