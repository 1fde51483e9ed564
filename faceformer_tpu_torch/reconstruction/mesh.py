"""Prediction JSON -> triangulated surface mesh (OBJ).

A copy of faceformer_tpu/reconstruction/mesh.py.

    python -m faceformer_tpu_torch.reconstruction.mesh --root <dir> \
        [--name ID] [--num_cores K]

reads <root>/json/*.json and writes <root>/obj/<id>.obj.

Capability parity with the reference's reconstruct_to_mesh.py, rebuilt
CAD-kernel-free: the reference constructs OCC B-Rep faces (planar wires with
holes, B-spline cylinder halves) and tessellates them
(reconstruct_to_mesh.py:446-575). Here:

  - planar faces: assemble cycles from the face's lifted edges, pick the
    outer cycle by 2D area, ear-clip it in screen space (planes are depth
    graphs z = ax + by + c, so screen-xy triangulation is valid), and drop
    triangles whose centroid falls inside an inner (hole) cycle;
  - cylinder halves: the two lifted arcs are resampled to a common count and
    bridged with a ruled quad strip.

The reference maintains a hardcoded blocklist of 5 ids that crash OCC
(reconstruct_to_mesh.py:447-449); no blocklist is needed here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from faceformer_tpu_torch.geometry.loops import assemble_cycles
from faceformer_tpu_torch.reconstruction.wireframe import (
    INTERMEDIATE_TYPE,
    _flatten_face,
    is_straight_line,
    solve_prediction,
)


# ---------------------------------------------------------------------------
# 2D triangulation
# ---------------------------------------------------------------------------


def polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def point_in_polygon(point, poly: np.ndarray) -> bool:
    x, y = point
    j = len(poly) - 1
    inside = False
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    return inside


def ear_clip(poly: np.ndarray) -> List[Tuple[int, int, int]]:
    """Triangulate a simple 2D polygon by ear clipping. Returns index
    triples into the input ring."""
    n = len(poly)
    if n < 3:
        return []
    indices = list(range(n))
    if polygon_area(poly) < 0:  # enforce CCW
        indices.reverse()
    triangles: List[Tuple[int, int, int]] = []
    guard = 0
    while len(indices) > 3 and guard < 10 * n:
        guard += 1
        clipped = False
        for k in range(len(indices)):
            i0, i1, i2 = (indices[k - 1], indices[k],
                          indices[(k + 1) % len(indices)])
            a, b, c = poly[i0], poly[i1], poly[i2]
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            if cross <= 1e-14:
                continue  # reflex or degenerate
            # no remaining vertex inside the candidate ear
            ok = True
            for other in indices:
                if other in (i0, i1, i2):
                    continue
                p = poly[other]
                if _in_triangle(p, a, b, c):
                    ok = False
                    break
            if ok:
                triangles.append((i0, i1, i2))
                indices.pop(k)
                clipped = True
                break
        if not clipped:
            break  # self-intersecting input: emit what we have
    if len(indices) == 3:
        triangles.append(tuple(indices))
    return triangles


def _segments_intersect(p1, p2, p3, p4) -> bool:
    """Proper intersection of open segments p1p2 and p3p4."""

    def orient(a, b, c):
        return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])

    d1, d2 = orient(p3, p4, p1), orient(p3, p4, p2)
    d3, d4 = orient(p1, p2, p3), orient(p1, p2, p4)
    return ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0))


def _ring_edges(ring: np.ndarray):
    n = len(ring)
    for i in range(n):
        yield ring[i], ring[(i + 1) % n]


def merge_holes(outer: np.ndarray, holes) -> np.ndarray:
    """Bridge each hole into the outer ring via a mutually visible vertex
    pair, producing one simple polygon ear_clip can handle (the standard
    bridge construction; the reference delegates holes to OCC's
    ShapeFix_Face, reconstruct_to_mesh.py:479-516)."""
    outer = np.asarray(outer, dtype=float)
    if polygon_area(outer) < 0:
        outer = outer[::-1]
    # process holes right-to-left (classic ordering for bridge insertion)
    holes = sorted((np.asarray(h, dtype=float) for h in holes),
                   key=lambda h: -float(h[:, 0].max()))
    for hi, hole in enumerate(holes):
        if polygon_area(hole) > 0:
            hole = hole[::-1]  # holes run clockwise
        m = int(np.argmax(hole[:, 0]))
        mp = hole[m]
        # the bridge must not cross the not-yet-merged holes either — a
        # bridge through another hole makes the spliced ring self-intersect
        # and ear_clip leaves triangles straddling that hole's boundary
        obstacles = [hole, outer] + list(holes[hi + 1:])
        best, best_d = None, np.inf
        for i, op in enumerate(outer):
            d = float(np.hypot(*(op - mp)))
            if d >= best_d:
                continue
            blocked = False
            for ring in obstacles:
                for a, b in _ring_edges(ring):
                    if (np.allclose(a, op) or np.allclose(b, op)
                            or np.allclose(a, mp) or np.allclose(b, mp)):
                        continue
                    if _segments_intersect(mp, op, a, b):
                        blocked = True
                        break
                if blocked:
                    break
            if not blocked:
                best, best_d = i, d
        if best is None:
            continue  # no visible bridge: leave the hole filled
        # splice: outer[..best], bridge to hole at m, walk the hole, bridge back
        hole_walk = np.vstack([hole[m:], hole[: m + 1]])
        outer = np.vstack([outer[: best + 1], hole_walk, outer[best:]])
    return outer


def _in_triangle(p, a, b, c) -> bool:
    """Containment test for ear candidates: interior and edge-interior
    points block an ear; points coincident with an ear vertex do not
    (required for the duplicated bridge vertices merge_holes introduces)."""
    for v in (a, b, c):
        if p[0] == v[0] and p[1] == v[1]:
            return False

    def side(p1, p2, p3):
        return (p1[0] - p3[0]) * (p2[1] - p3[1]) - (p2[0] - p3[0]) * (p1[1] - p3[1])

    d1, d2, d3 = side(p, a, b), side(p, b, c), side(p, c, a)
    has_neg = (d1 < 0) or (d2 < 0) or (d3 < 0)
    has_pos = (d1 > 0) or (d2 > 0) or (d3 > 0)
    return not (has_neg and has_pos)


# ---------------------------------------------------------------------------
# mesh assembly
# ---------------------------------------------------------------------------


class MeshBuilder:
    def __init__(self):
        self.vertices: List[np.ndarray] = []
        self.faces: List[Tuple[int, int, int]] = []

    def add_triangles(self, pts3d: np.ndarray, triangles) -> None:
        base = len(self.vertices)
        self.vertices.extend(np.asarray(pts3d, dtype=float))
        self.faces.extend((base + a, base + b, base + c) for a, b, c in triangles)

    def arrays(self):
        return np.asarray(self.vertices), self.faces


def _lifted_polyline(result, edge_ind: int) -> Optional[np.ndarray]:
    if edge_ind not in result.ind_to_3d:
        return None
    s, n = result.ind_to_3d[edge_ind]
    return result.xyz[s : s + n]


def _lift_with_plane(points2d: np.ndarray, plane: np.ndarray) -> np.ndarray:
    ones = np.hstack([points2d, np.ones((len(points2d), 1))])
    depth = ones @ plane
    return np.hstack([points2d, depth[:, None]])


def _mesh_planar_face(builder: MeshBuilder, result, face_ind: int, face) -> None:
    inds = _flatten_face(face)
    plane = result.params[face_ind]
    edges2d = [result.edges[i] for i in inds]
    cycles, cycle_inds, _ = assemble_cycles(edges2d, inds)
    if not cycles:
        return
    rings = []
    for cyc in cycles:
        ring = []
        for oriented in cyc:
            ring.extend([p[:2] for p in oriented[:-1]])
        rings.append(np.asarray(ring, dtype=float))
    areas = [abs(polygon_area(r)) for r in rings]
    outer = int(np.argmax(areas))
    holes = [r for k, r in enumerate(rings) if k != outer and len(r) >= 3]

    ring = rings[outer]
    if holes:
        ring = merge_holes(ring, holes)
    triangles = ear_clip(ring)
    if holes:
        # bridge splicing can leave degenerate slivers on pathological
        # inputs; drop triangles whose centroid landed inside a hole
        kept = []
        for tri in triangles:
            centroid = ring[list(tri)].mean(axis=0)
            if not any(point_in_polygon(centroid, h) for h in holes):
                kept.append(tri)
        triangles = kept
    if triangles:
        builder.add_triangles(_lift_with_plane(ring, plane), triangles)


def _mesh_cylinder_face(builder: MeshBuilder, result, face) -> None:
    """Ruled surface between the face's two lifted arcs."""
    inds = _flatten_face(face)
    arcs = [i for i in inds if not is_straight_line(result.edges[i])]
    arcs = [a for a in (_lifted_polyline(result, i) for i in arcs) if a is not None]
    if len(arcs) < 2:
        return
    a, b = arcs[0], arcs[1]
    k = max(len(a), len(b), 8)

    def resample(poly, k):
        t = np.linspace(0, len(poly) - 1, k)
        i0 = np.floor(t).astype(int)
        i1 = np.minimum(i0 + 1, len(poly) - 1)
        frac = (t - i0)[:, None]
        return poly[i0] * (1 - frac) + poly[i1] * frac

    a, b = resample(a, k), resample(b, k)
    # orient consistently: minimize endpoint travel
    if np.linalg.norm(a[0] - b[0]) + np.linalg.norm(a[-1] - b[-1]) > \
       np.linalg.norm(a[0] - b[-1]) + np.linalg.norm(a[-1] - b[0]):
        b = b[::-1]
    pts = np.vstack([a, b])
    triangles = []
    for i in range(k - 1):
        triangles.append((i, i + 1, k + i))
        triangles.append((i + 1, k + i + 1, k + i))
    builder.add_triangles(pts, triangles)


def reconstruct_mesh(data: Dict):
    """Build (vertices, triangle index triples) from one prediction record,
    or None if unreconstructible."""
    result = solve_prediction(data)
    if result is None:
        return None
    builder = MeshBuilder()
    for face_ind, (face_type, face) in enumerate(result.faces):
        if face_type == INTERMEDIATE_TYPE:
            continue
        if face_type == 0:
            _mesh_planar_face(builder, result, face_ind, face)
    for face_type, face in result.removed:
        if face_type == 1:
            _mesh_cylinder_face(builder, result, face)
    vertices, faces = builder.arrays()
    if len(faces) == 0:
        return None
    vertices = vertices.copy()
    vertices[:, 1] = -vertices[:, 1]  # same y-flip as the wireframe output
    return vertices, faces


def _write_mesh(out_path: str, mesh) -> None:
    from faceformer_tpu_torch.reconstruction.io3d import write_obj_mesh

    write_obj_mesh(out_path, mesh[0], mesh[1])


def reconstruct_file(name: str, root: str) -> bool:
    """Idempotent per-file wrapper (shared scaffolding: runner.py)."""
    from faceformer_tpu_torch.reconstruction.runner import process_file

    return process_file(name, root, "obj", "obj", reconstruct_mesh, _write_mesh)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from faceformer_tpu_torch.reconstruction.runner import run_cli

    run_cli("mesh reconstruction", "obj", reconstruct_file, argv)


if __name__ == "__main__":
    main()
