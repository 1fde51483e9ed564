"""3-view similarity filter: within each topology bin, cluster objects by
Jaccard distance of binarized canonical-view renders and keep the smallest
id per cluster (reference: dataset/filters/filter_3view.py:17-88).

A copy of faceformer_tpu/tools/filters/filter_3view.py with its imports renamed to
the port's modules: the same inputs write the same files.

Rendering the views needs a CAD kernel (tools/prepare_data.py --three_view,
OCC-gated); this stage only needs the PNGs.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

import numpy as np


def view_feature(root: str, name: str, views=(1, 2, 3)) -> np.ndarray:
    """Concatenate binarized half-resolution views (reference :48-61)."""
    import cv2

    feature = []
    for i in views:
        path = os.path.join(root, "3view_png", f"{name}-{i}.png")
        img = cv2.imread(path)
        if img is None:
            feature.append(None)  # placeholder sized after the loop
            continue
        half = cv2.resize(img, (0, 0), fx=0.5, fy=0.5)
        gray = cv2.cvtColor(half, cv2.COLOR_BGR2GRAY)
        _, binary = cv2.threshold(gray, 254, 255, cv2.THRESH_BINARY)
        feature.append(binary.flatten())
    # missing views get an all-white placeholder matching the loaded views'
    # size (a hardcoded 128*128 only fits 256px renders; other --width/
    # --height values would crash the np.stack in cluster_bin)
    size = next((f.size for f in feature if f is not None), 128 * 128)
    feature = [np.ones(size) * 255 if f is None else f for f in feature]
    return np.concatenate([np.asarray(f).flatten() for f in feature])


def cluster_bin(root: str, names: Sequence[str], threshold: float) -> List[List[str]]:
    from sklearn.cluster import AgglomerativeClustering
    from sklearn.metrics import pairwise_distances

    X = np.stack([view_feature(root, n) for n in names]) == 0
    dist = pairwise_distances(X, metric="jaccard")
    labels = AgglomerativeClustering(
        n_clusters=None, metric="precomputed",
        distance_threshold=threshold, linkage="single").fit(dist).labels_
    out: List[List[str]] = [[] for _ in range(labels.max() + 1)]
    for name, c in zip(names, labels):
        out[c].append(name)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--bins", type=str, default="topo_matching_bins.json")
    parser.add_argument("--error_log", type=str, default="")
    parser.add_argument("--similarity_threshold", type=float, default=0.1)
    parser.add_argument("--out", type=str, default="filtered_id_list.json")
    args = parser.parse_args(argv)

    with open(args.bins) as f:
        bins = json.load(f)

    errors = set()
    if args.error_log and os.path.exists(args.error_log):
        with open(args.error_log) as f:
            errors = {l[:8] for l in f.read().splitlines() if l[:8].isdigit()}

    final_bins: List[List[str]] = []
    for b in bins:
        clean = [n for n in b if n not in errors]
        if not clean:
            continue
        if len(clean) == 1:
            final_bins.append(clean)
        else:
            final_bins += cluster_bin(args.root, clean, args.similarity_threshold)

    # keep the smallest id per cluster (reference :85). Dedup: overlapping
    # topology bins can elect the same object from two bins, and a
    # duplicated id would leak into multiple dataset splits downstream
    kept = sorted({min(b, key=int) for b in final_bins})
    with open(args.out, "w") as f:
        json.dump(kept, f)
    print(f"{sum(len(b) for b in bins)} objects -> {len(kept)} unique")


if __name__ == "__main__":
    main()
