"""Loop assembly and canonicalization for unordered edge sets.

A copy of faceformer_tpu/geometry/loops.py, kept so the port imports
nothing of the JAX package: the same edges assemble into the same cycles.

Behavior contracts:
  - ``canonicalize_loops``: roll each loop so the smallest index leads, then
    order loops by first index (reference: faceformer/post_processing.py:8-20,
    dataset/prepare_data.py:147-160).
  - ``assemble_cycles`` / ``assemble_cylinder_cycle``: chain edges into closed
    cycles by endpoint proximity, returning oriented point lists, the edge
    indices in walk order, and +1/-1 traversal directions (reference:
    reconstruction/reconstruction_utils.py:7-164).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def canonicalize_loops(loops: Sequence[Sequence[int]]) -> Tuple[Tuple[int, ...], ...]:
    """Roll every loop so its min index is first; sort loops by first index.

    Loop entries are plain edge indices or (index, orientation) pairs (the
    --direction_token flavor; rolled by the index component, reference
    prepare_data.py:236-239)."""
    rolled = []
    for loop in loops:
        arr = np.asarray(loop)
        if arr.ndim == 2:
            r = np.roll(arr, -int(np.argmin(arr[:, 0])), axis=0).astype(int)
            rolled.append(tuple(map(tuple, r.tolist())))
        else:
            rolled.append(tuple(
                np.roll(arr, -int(np.argmin(arr)), axis=0).astype(int).tolist()))
    return tuple(sorted(rolled, key=lambda lp: lp[0]))


def _point_distance(p1, p2) -> float:
    return float(np.linalg.norm(np.asarray(p1, dtype=float) - np.asarray(p2, dtype=float)))


class _EndpointGraph:
    """Groups edge endpoints into junctions by first-match proximity clustering.

    Insertion order of junction keys is preserved (dict ordering), mirroring
    the reference's walk order so assembled cycles come out identically.
    """

    def __init__(self, edges, edge_inds, tol: float):
        self.tol = tol
        # junction point -> list of (edge points, direction, edge index);
        # direction +1 means the edge leaves this junction from its start,
        # -1 means it arrives here at its end.
        self.junctions: Dict[tuple, List[tuple]] = {}
        # edge index -> its two junction keys, in (start, end) insertion order
        self.edge_junctions: Dict[int, List[tuple]] = {}
        for edge, ind in zip(edges, edge_inds):
            for point, direction in ((tuple(edge[0]), 1), (tuple(edge[-1]), -1)):
                key = self._find_or_add(point)
                self.junctions[key].append((edge, direction, ind))
                self.edge_junctions.setdefault(ind, []).append(key)

    def _find_or_add(self, point: tuple) -> tuple:
        for key in self.junctions:
            if _point_distance(point, key) < self.tol:
                return key
        self.junctions[point] = []
        return point

    def other_end(self, edge_ind: int, current: tuple) -> tuple:
        for junction in self.edge_junctions[edge_ind]:
            if tuple(current) != tuple(junction):
                return junction
        return current  # degenerate self-loop: stay (reference behavior)

    def unused_edge_at(self, junction: tuple, used: Sequence[int]):
        entry = None
        for entry in self.junctions[junction]:
            if entry[2] not in used:
                return entry
        return entry  # all used: fall back to last, like the reference walk


def assemble_cylinder_cycle(edges, edge_inds, tol: float = 1e-4):
    """Assemble the single 4-ish-edge cycle of a cylinder face.

    The walk starts at a junction where a straight line (2-point edge) meets
    any other edge, so the two straight outlines land at deterministic
    positions in the output (reference: reconstruction_utils.py:52-83).
    Returns (oriented point lists, edge indices, directions).
    """
    graph = _EndpointGraph(edges, edge_inds, tol)
    origin = None
    for junction, entries in graph.junctions.items():
        if len(entries) != 2:
            raise ValueError("more than two edges intersect at one junction")
        e1, e2 = entries[0][0], entries[1][0]
        if len(e1) == 2 or len(e2) == 2:
            origin = junction
            break
    if origin is None:
        raise ValueError("no line/curve junction found")

    cycle, cycle_inds, dirs = [], [], []
    current = origin
    for _ in range(10):  # bounded walk (reference guard, :78-81)
        edge, direction, ind = graph.unused_edge_at(current, cycle_inds)
        cycle.append(edge[::direction])
        cycle_inds.append(ind)
        dirs.append(direction)
        current = graph.other_end(ind, current)
        if current == origin:
            break
    else:
        raise ValueError("cylinder cycle did not close")
    return cycle, cycle_inds, dirs


def assemble_cycles(edges, edge_inds, tol: float = 1e-4):
    """Assemble ALL closed cycles from an unordered edge set.

    Junctions are consumed as the walk visits them; walks that leave the
    known junction set are dropped (reference: reconstruction_utils.py:132-163).
    Returns (list of cycles, list of index lists, list of direction lists).
    """
    graph = _EndpointGraph(edges, edge_inds, tol)
    remaining = dict(graph.junctions)

    all_cycles, all_inds, all_dirs = [], [], []
    while remaining:
        origin = next(iter(remaining))
        cycle, cycle_inds, dirs = [], [], []
        current = origin
        broken = False
        while True:
            if current not in remaining:
                broken = True
                break
            # remaining[current] aliases graph.junctions[current], so this
            # is exactly the graph's first-unused walk (same all-used
            # fallback to the junction's last entry)
            edge, direction, ind = graph.unused_edge_at(current, cycle_inds)
            cycle.append(edge[::direction])
            cycle_inds.append(ind)
            dirs.append(direction)
            del remaining[current]
            current = graph.other_end(ind, current)
            if current == origin:
                break
        if not broken:
            all_cycles.append(cycle)
            all_inds.append(cycle_inds)
            all_dirs.append(dirs)
    return all_cycles, all_inds, all_dirs
