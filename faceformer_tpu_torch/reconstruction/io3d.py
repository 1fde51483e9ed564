"""Minimal 3D file writers: ASCII PLY point clouds and OBJ meshes
(a copy of faceformer_tpu/reconstruction/io3d.py).

Replaces open3d's PLY writer (reference: reconstruct_to_wireframe.py:360-365)
and the hand-rolled OBJ text after OCC tessellation
(reference: reconstruct_to_mesh.py:399-444) with direct, dependency-free IO.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def write_ply_points(path: str, points: np.ndarray) -> None:
    points = np.asarray(points, dtype=float)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property double x\nproperty double y\nproperty double z\n")
        f.write("end_header\n")
        for x, y, z in points:
            f.write(f"{x:.10g} {y:.10g} {z:.10g}\n")


def read_ply_points(path: str) -> np.ndarray:
    with open(path) as f:
        line = f.readline()
        assert line.strip() == "ply"
        n = 0
        while True:
            line = f.readline()
            if not line:  # EOF: truncated header (e.g. interrupted writer)
                raise ValueError(f"{path}: PLY header has no end_header")
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        return np.array([[float(v) for v in f.readline().split()[:3]] for _ in range(n)])


def write_obj_mesh(path: str, vertices: np.ndarray, faces: Sequence[Sequence[int]]) -> None:
    """faces hold 0-based vertex indices; OBJ is 1-based."""
    with open(path, "w") as f:
        for x, y, z in np.asarray(vertices, dtype=float):
            f.write(f"v {x:.10g} {y:.10g} {z:.10g}\n")
        for face in faces:
            f.write("f " + " ".join(str(i + 1) for i in face) + "\n")
