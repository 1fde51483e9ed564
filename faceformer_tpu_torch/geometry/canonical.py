"""Canonical ordering rules for discretized wireframe edges.

A copy of faceformer_tpu/geometry/canonical.py, kept so the port imports
nothing of the JAX package: the same edges order the same way.

Behavior contracts (reference: dataset/utils/discretize_edge.py:16-88):
  - open edges point from the lexicographically smaller endpoint (x, then y)
    to the larger;
  - closed edges drop the repeated endpoint, roll so the min-x point leads,
    and run clockwise by y, re-appending the closing point;
  - edges sort lexicographically by their point sequences; faces sort by
    their index sequences.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np


def comp_points(p1, p2) -> float:
    return (p1[1] - p2[1]) if p1[0] == p2[0] else (p1[0] - p2[0])


def comp_point_seqs(e1: Sequence, e2: Sequence) -> float:
    for a, b in zip(e1, e2):
        diff = comp_points(a, b)
        if diff != 0:
            return diff
    return 0.0


def sort_key_edges(edges: Sequence[Sequence]) -> List[int]:
    """Indices that lexicographically sort point-sequence edges."""
    return sorted(range(len(edges)),
                  key=functools.cmp_to_key(lambda i, j: comp_point_seqs(edges[i], edges[j])))


def is_closed(points: Sequence, tolerance: float = 1e-10) -> bool:
    return (abs(points[0][0] - points[-1][0]) < tolerance
            and abs(points[0][1] - points[-1][1]) < tolerance)


def canonicalize_closed_edge(points: Sequence) -> List:
    """Roll a closed polyline so the min-x point leads and the walk runs
    clockwise by y (reference discretize_edge.py:33-49)."""
    ring = list(points[1:])  # drop the repeated start
    arr = np.asarray(ring)
    # x-only argmin: ties between equal-x points resolve by input rotation,
    # exactly as the reference does (discretize_edge.py:40-41,
    # np.roll(edge_array, -np.argmin(edge_array[:, 0]))) — bug-for-bug so
    # canonical forms match reference-generated data
    rolled = np.roll(arr, -int(np.argmin(arr[:, 0])), axis=0).tolist()
    if rolled[1][1] > rolled[-1][1]:
        rolled.append(rolled[0])
    else:
        rolled = [rolled[0]] + list(reversed(rolled))
    return rolled


def correct_edge_direction(points: Sequence, tolerance: float = 1e-10) -> List:
    """Canonical direction for one edge: closed edges get the rolled
    clockwise form; open edges point small-to-large endpoint."""
    if is_closed(points, tolerance):
        return canonicalize_closed_edge(points)
    if comp_points(points[0], points[-1]) > 0:
        return list(reversed(points))
    return list(points)


def sort_faces_by_indices(faces: Sequence[Sequence[int]]) -> List:
    """Lexicographic face ordering by index sequences
    (reference discretize_edge.py:77-88)."""

    def comp(f1, f2):
        for a, b in zip(f1, f2):
            if a != b:
                return a - b
        return 0

    return sorted(faces, key=functools.cmp_to_key(comp))
