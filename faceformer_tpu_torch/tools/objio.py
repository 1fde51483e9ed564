"""Tiny OBJ reader (vertices + faces) — replaces the reference's trimesh
dependency for the thickness/thinness filters, which only need raw vertex
positions and bounding boxes (reference: filter_thickness.py:12-20).

A copy of faceformer_tpu/tools/objio.py with its imports renamed to
the port's modules: the same inputs write the same files.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, List[List[int]]]:
    vertices: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vertices.append([float(v) for v in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(tok.split("/")[0]) - 1 for tok in line.split()[1:]])
    return np.asarray(vertices, dtype=float), faces


def bounding_extents(vertices: np.ndarray) -> np.ndarray:
    return vertices.max(axis=0) - vertices.min(axis=0)


def scale_to_unit_sphere(vertices: np.ndarray) -> np.ndarray:
    """Center on the bbox centroid and scale the bbox diagonal to 2
    (reference: filter_thickness.py:12-20)."""
    lo, hi = vertices.min(axis=0), vertices.max(axis=0)
    centered = vertices - (lo + hi) / 2
    return centered * (2.0 / np.linalg.norm(hi - lo))
