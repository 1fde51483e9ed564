"""Eval-time face post-processing (a copy of faceformer_tpu/post_processing.py;
reference: faceformer/post_processing.py).

Predicted faces are kept only if their edge sequence chains into closed
loops; enclosed faces are canonicalized (loops rolled to min index, sorted);
faces that reuse an undirected edge an earlier face claimed can be dropped;
coedge indices are mapped to canonical edge ids via the dataset's pairings.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from faceformer_tpu_torch.geometry.enclosedness import is_face_enclosed
from faceformer_tpu_torch.geometry.loops import canonicalize_loops


def filter_faces_by_encloseness(
    edges: Sequence, faces: Sequence[Tuple[int, Sequence[int]]], tol: float
) -> List[Tuple[int, tuple]]:
    """Keep enclosed faces; canonicalize their loop decomposition
    (reference: post_processing.py:8-20)."""
    filtered = []
    for face_type, face in faces:
        loops = is_face_enclosed(edges, face, tol)
        if loops:
            filtered.append((face_type, canonicalize_loops(loops)))
    return filtered


def filter_faces_by_coedge(pairings: Dict, faces: Sequence) -> List:
    """Drop faces that reuse an undirected edge already claimed by an earlier
    face (reference: post_processing.py:23-39). ``pairings`` maps lower
    coedge index -> higher twin (int keys); ``faces`` are (type, loops)."""
    filtered = []
    used = set()
    for face in faces:
        indices = [i for loop in face[1] for i in loop]
        drop = False
        for index in indices:
            if index in pairings:
                index = pairings[index]
                if index in used:
                    drop = True
                    break
            used.add(index)
        if not drop:
            filtered.append(face)
    return filtered


def map_coedge_into_edges(pairings: Dict[str, int], indices: Sequence[int]) -> List[int]:
    """Map each coedge index to its canonical twin. JSON round-trips turn
    the pairing keys into strings — looked up as strings on purpose
    (reference: post_processing.py:41-48)."""
    return [pairings[str(i)] if str(i) in pairings else i for i in indices]
