"""Prediction JSON -> 3D wireframe point cloud (PLY).

A copy of faceformer_tpu/reconstruction/wireframe.py: the LP's rows are
gathered in the same order and vertices cluster first-match in the same
order, since HiGHS may return another of several optimal points for
reordered rows.

    python -m faceformer_tpu_torch.reconstruction.wireframe --root <dir> \
        [--name ID] [--num_cores K]

reads <root>/json/*.json and writes <root>/ply/<id>.ply.

Faithful re-expression of the reference pipeline
(reconstruction/reconstruct_to_wireframe.py:27-368):

  1. every predicted cylinder face (type 1) is decomposed: its cycle is
     assembled, the two straight outlines located, a mid-edge synthesized by
     displacing a curve midpoint along the outline, and two INTERMEDIATE
     planes (type 11) added so the LP can solve their depths; cap faces
     sharing the cylinder's arcs get a predetermined normal direction;
  2. per-face plane parameters f = (a_i, b_i, c_i) solve
     min ||P f + b||_1 s.t. C f >= 0 with rows from (i) edges parallel to a
     dominant direction => face perpendicular to it, (ii) faces sharing a
     vertex agree on depth there, (iii) positive depth;
  3. sampled edge points lift to 3D via z = ax + by + c; cylinder arcs are
     re-fit as circles through three lifted points.

Known deviation (documented on purpose): when constraint-stage face removals
occur, the reference decrements the face index once PER CONSTRAINT ROW
(reconstruct_to_wireframe.py:205-208), mis-indexing the second row of
multi-constraint faces; here the index is adjusted once per face.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from faceformer_tpu_torch.geometry.circles import fit_arc_through_points
from faceformer_tpu_torch.geometry.loops import assemble_cylinder_cycle
from faceformer_tpu_torch.reconstruction.lp import solve_l1_plane_fit

INTERMEDIATE_TYPE = 11  # cylinder helper planes, excluded from final output
SAMPLE_DIST = 5e-3
VERTEX_TOL = 1e-4


def is_straight_line(edge) -> bool:
    return len(edge) == 2


def sample_line_points(line, sample_dist: float = SAMPLE_DIST) -> np.ndarray:
    """Resample a straight 2-point line at ~sample_dist spacing
    (reference: reconstruct_to_wireframe.py:19-25)."""
    (x1, y1), (x2, y2) = line[0][:2], line[1][:2]
    num = int(np.hypot(x1 - x2, y1 - y2) / sample_dist) + 1
    t = np.linspace(0.0, 1.0, num)
    return np.stack([x1 + (x2 - x1) * t, y1 + (y2 - y1) * t], axis=1)


def _flatten_face(face) -> List[int]:
    """pred_faces store either flat index tuples or loop tuples."""
    if len(face) and isinstance(face[0], (list, tuple)):
        return [int(i) for loop in face for i in loop]
    return [int(i) for i in face]


def _decompose_cylinders(faces: List, edges: List, dom_2d: List[np.ndarray]):
    """Stage 1: replace cylinder faces with intermediate planes + mid edges.

    Returns (faces, edges, removed_faces, circle_jobs, face_to_normal) where
    circle_jobs carry (line_ind, other_line_ind, mid_edge_ind, curve_ind,
    other_curve_ind, dirs) for arc re-fitting after the solve."""
    num_edges = len(edges)
    new_planes: List = []
    new_edges: List = []
    removal: List[int] = []
    circle_jobs: List[Tuple] = []
    face_to_normal: Dict[tuple, int] = {}

    for i, (face_type, face) in enumerate(faces):
        if face_type not in (0, 1):
            removal.append(i)
            continue
        if face_type != 1:
            continue
        removal.append(i)

        inds = _flatten_face(face)
        cyc_edges = [edges[j] for j in inds]
        if sum(is_straight_line(e) for e in cyc_edges) != 2:
            continue  # not a reconstructible cylinder
        try:
            walk, walk_inds, walk_dirs = assemble_cylinder_cycle(cyc_edges, inds)
        except Exception:
            continue

        # merge adjacent curves until the cycle has exactly 4 edges
        # (reference: :74-88)
        if len(walk) != 4:
            j = 0
            while j < len(walk):
                nj = (j + 1) % len(walk)
                if not is_straight_line(walk[j]) and not is_straight_line(walk[nj]):
                    walk[j] = list(walk[j]) + list(walk[nj])
                    walk.pop(nj)
                    walk_inds.pop(nj)
                    walk_dirs.pop(nj)
                    continue
                j += 1
            if len(walk) != 4:
                continue

        if is_straight_line(walk[0]):
            line, line_ind, line_dir = walk[0], walk_inds[0], walk_dirs[0]
            curve, curve_ind = walk[1], walk_inds[1]
            other_line, other_line_ind, other_line_dir = walk[2], walk_inds[2], walk_dirs[2]
            other_curve_ind = walk_inds[3]
        else:
            curve, curve_ind = walk[0], walk_inds[0]
            other_line, other_line_ind, other_line_dir = walk[1], walk_inds[1], walk_dirs[1]
            other_curve_ind = walk_inds[2]
            line, line_ind, line_dir = walk[3], walk_inds[3], walk_dirs[3]

        direction = np.asarray(line[0], float) - np.asarray(line[1], float)
        mid_point = np.asarray(curve[len(curve) // 2], float)
        next_point = (mid_point + direction).tolist()
        mid_point = mid_point.tolist()

        off = len(new_edges) + num_edges
        new_edges += [
            [mid_point, next_point],
            [list(line[0]), next_point],
            [list(line[1]), mid_point],
            [list(other_line[1]), next_point],
            [list(other_line[0]), mid_point],
        ]
        new_planes += [
            (INTERMEDIATE_TYPE, [line_ind, 2 + off, off, 1 + off]),
            (INTERMEDIATE_TYPE, [other_line_ind, 3 + off, off, 4 + off]),
        ]
        circle_jobs.append(
            (line_ind, other_line_ind, off, curve_ind, other_curve_ind,
             (line_dir, other_line_dir, 1)))

        # the cylinder axis aligns with the dominant direction most parallel
        # to the outline: cap faces sharing the arcs inherit that normal
        normal_ind = int(np.argmax(
            [abs(float(np.dot(direction, d))) for d in dom_2d]))
        for face_type2, face2 in faces:
            inds2 = _flatten_face(face2)
            if curve_ind in inds2 or other_curve_ind in inds2:
                face_to_normal[tuple(inds2)] = normal_ind

    faces = faces + new_planes
    edges = edges + new_edges
    removed = []
    for k, ind in enumerate(removal):
        removed.append(faces.pop(ind - k))
    return faces, edges, removed, circle_jobs, face_to_normal


def _build_constraints(faces, edges, dom_2d, origin_dirs, face_to_normal, num_vars_faces):
    """Stage 2a: perpendicularity rows; drop faces parallel to all dominant
    directions (wrong predictions). Returns (faces, P_rows, b_rows)."""
    P_rows, b_rows = [], []
    removal = []
    kept_index = 0
    for face_type, face in faces:
        inds = _flatten_face(face)
        counts = [0, 0, 0]
        for edge_ind in inds:
            edge = edges[edge_ind]
            if not is_straight_line(edge):
                continue
            d = np.asarray(edge[0], float)[:2] - np.asarray(edge[1], float)[:2]
            norm = np.linalg.norm(d)
            if norm == 0:
                continue
            d = d / norm
            for k, dom in enumerate(dom_2d):
                if abs(float(np.dot(d, dom))) > 1 - 1e-10:
                    counts[k] += 1

        if tuple(inds) in face_to_normal:
            normal_ind = face_to_normal[tuple(inds)]
            for k in range(3):
                if k != normal_ind:
                    counts[k] += 1

        if 0 not in counts:
            removal.append((face_type, face))
            continue

        for k, count in enumerate(counts):
            if count != 0:
                row = np.zeros(3 * num_vars_faces)
                d3 = origin_dirs[k]
                row[3 * kept_index : 3 * kept_index + 2] = [d3[0], d3[1]]
                P_rows.append(row)
                b_rows.append(d3[2])
        kept_index += 1

    kept = [f for f in faces if not any(f is r for r in removal)]
    return kept, P_rows, b_rows


def _vertex_constraints(faces, edges, num_vars_faces):
    """Stage 2b: shared-vertex depth agreement + positive-depth rows
    (reference: :224-256)."""
    used = sorted({i for _, face in faces for i in _flatten_face(face)})
    all_vertices = []
    for ind in used:
        all_vertices += [tuple(p[:2]) for p in edges[ind]]

    # greedy first-seen dedup, exactly as a full pairwise scan would do it,
    # but backed by a spatial hash (cell = VERTEX_TOL): any vertex within
    # VERTEX_TOL of a point lies in the 3x3 cell neighborhood, so the
    # nearest-candidate search over those cells reproduces the full argmin
    # (ties break to the smallest index, matching np.argmin). The previous
    # O(V^2)-with-revstack version dominated solve wall-clock on cluttered
    # predictions.
    unique: List[tuple] = []
    cells: Dict[Tuple[int, int], List[int]] = {}

    def nearest(p):
        cx = int(np.floor(p[0] / VERTEX_TOL))
        cy = int(np.floor(p[1] / VERTEX_TOL))
        best_i, best_d = -1, np.inf
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for i in cells.get((cx + dx, cy + dy), ()):
                    q = unique[i]
                    d = ((q[0] - p[0]) ** 2 + (q[1] - p[1]) ** 2) ** 0.5
                    if d < best_d or (d == best_d and i < best_i):
                        best_i, best_d = i, d
        return best_i, best_d

    def add(p):
        i = len(unique)
        unique.append(p)
        key = (int(np.floor(p[0] / VERTEX_TOL)), int(np.floor(p[1] / VERTEX_TOL)))
        cells.setdefault(key, []).append(i)

    for v in all_vertices:
        _, d = nearest(v)
        if d >= VERTEX_TOL:
            add(v)

    groups: List[set] = [set() for _ in unique]
    for face_ind, (_, face) in enumerate(faces):
        for edge_ind in _flatten_face(face):
            for p in edges[edge_ind]:
                vi = nearest((float(p[0]), float(p[1])))[0]
                groups[vi].add(face_ind)

    P_rows, b_rows, C_rows = [], [], []
    import itertools

    for v, group in zip(unique, groups):
        group = sorted(group)
        if len(group) < 2:
            continue
        for f1, f2 in itertools.combinations(group, 2):
            row = np.zeros(3 * num_vars_faces)
            row[3 * f1 : 3 * f1 + 3] = [v[0], v[1], 1.0]
            row[3 * f2 : 3 * f2 + 3] = [-v[0], -v[1], -1.0]
            P_rows.append(row)
            b_rows.append(0.0)
        for f in group:
            row = np.zeros(3 * num_vars_faces)
            row[3 * f : 3 * f + 3] = [-v[0], -v[1], -1.0]
            C_rows.append(row)
    return P_rows, b_rows, C_rows


class SolveResult:
    """Everything the exporters need from one LP solve: kept faces, the
    cylinder-stage removals, plane params, lifted points and per-edge
    ranges."""

    def __init__(self, faces, removed, edges, params, xyz, ind_to_3d,
                 mid_edge_inds):
        self.faces = faces
        self.removed = removed
        self.edges = edges
        self.params = params
        self.xyz = xyz
        self.ind_to_3d = ind_to_3d
        self.mid_edge_inds = mid_edge_inds


def solve_prediction(data: Dict) -> Optional[SolveResult]:
    """Stages 1-4: cylinder decomposition, LP solve, depth lift, arc re-fit.
    Shared by the wireframe (PLY) and mesh (OBJ) exporters."""
    faces = [(int(t), f) for t, f in data["pred_faces"]]
    edges = [list(e) for e in data["edges"]]

    dom_2d = [np.asarray(d[:2], float) / np.linalg.norm(np.asarray(d[:2], float))
              for d in data["dominant_directions"]]
    origin_dirs = [np.asarray(d, float) / np.linalg.norm(np.asarray(d, float))
                   for d in data["dominant_directions"]]

    faces, edges, removed, circle_jobs, face_to_normal = _decompose_cylinders(
        faces, edges, dom_2d)
    num_vars_faces = len(faces)
    if num_vars_faces == 0:
        return None

    faces, P_rows, b_rows = _build_constraints(
        faces, edges, dom_2d, origin_dirs, face_to_normal, num_vars_faces)
    vp, vb, C_rows = _vertex_constraints(faces, edges, num_vars_faces)
    P_rows += vp
    b_rows += vb
    if not P_rows or not C_rows:
        return None

    # stage 3: sample points to lift (reference: :264-297)
    pts_chunks: List[np.ndarray] = []
    pts_label: List[int] = []
    ind_to_3d: Dict[int, Tuple[int, int]] = {}
    mid_edge_inds: List[int] = []

    def add_edge_samples(edge_ind: int, face_ind: int):
        sampled = sample_line_points(edges[edge_ind])
        ind_to_3d[edge_ind] = (len(pts_label), len(sampled))
        pts_chunks.append(sampled)
        pts_label.extend([face_ind] * len(sampled))

    for face_ind, (face_type, face) in enumerate(faces):
        inds = _flatten_face(face)
        if face_type == INTERMEDIATE_TYPE:
            add_edge_samples(inds[0], face_ind)  # outline
            add_edge_samples(inds[2], face_ind)  # mid edge
            mid_edge_inds.append(inds[2])
            continue
        for edge_ind in inds:
            if is_straight_line(edges[edge_ind]):
                add_edge_samples(edge_ind, face_ind)

    if not pts_chunks:
        return None
    pts = np.vstack(pts_chunks)
    labels = np.asarray(pts_label)

    f = solve_l1_plane_fit(np.asarray(P_rows), np.asarray(b_rows), np.asarray(C_rows))
    if f is None:
        return None
    params = f.reshape(-1, 3)

    ones = np.hstack([pts, np.ones((len(pts), 1))])
    depth = np.sum(params[labels] * ones, axis=1, keepdims=True)
    xyz = np.hstack([pts, depth])

    # stage 4: re-fit the cylinder arcs through lifted points (reference: :322-342)
    for line_ind, other_line_ind, mid_ind, curve_ind, other_curve_ind, dirs in circle_jobs:
        line_dir, other_dir, mid_dir = dirs
        try:
            s, n = ind_to_3d[line_ind]
            line_pts = xyz[s : s + n][::line_dir]
            s, n = ind_to_3d[other_line_ind]
            other_pts = xyz[s : s + n][::other_dir]
            s, n = ind_to_3d[mid_ind]
            mid_pts = xyz[s : s + n][::mid_dir]

            arc = fit_arc_through_points(line_pts[0], other_pts[-1], mid_pts[-1])
            ind_to_3d[other_curve_ind] = (len(xyz), len(arc))
            xyz = np.vstack([xyz, arc])

            arc = fit_arc_through_points(line_pts[-1], other_pts[0], mid_pts[0])
            ind_to_3d[curve_ind] = (len(xyz), len(arc))
            xyz = np.vstack([xyz, arc])
        except Exception:
            continue

    return SolveResult(faces, removed, edges, params, xyz, ind_to_3d,
                       mid_edge_inds)


def reconstruct_wireframe(data: Dict) -> Optional[np.ndarray]:
    """Lift one prediction record to a 3D point cloud. Returns (M, 3) points
    or None when the record is unreconstructible."""
    result = solve_prediction(data)
    if result is None:
        return None
    xyz, ind_to_3d = result.xyz, result.ind_to_3d
    # stage 5: gather final wireframe points (skip helper mid-edges)
    faces = result.faces + result.removed
    drawn = set(result.mid_edge_inds)
    chunks = []
    for face_type, face in faces:
        if face_type == INTERMEDIATE_TYPE:
            continue
        for ind in _flatten_face(face):
            if ind in ind_to_3d and ind not in drawn:
                s, n = ind_to_3d[ind]
                chunks.append(xyz[s : s + n])
                drawn.add(ind)
    if not chunks:
        return None
    points = np.vstack(chunks)
    points[:, 1] = -points[:, 1]  # flip y (reference: :363)
    return points


def reconstruct_file(name: str, root: str) -> bool:
    """Idempotent per-file wrapper (shared scaffolding: runner.py)."""
    from faceformer_tpu_torch.reconstruction.io3d import write_ply_points
    from faceformer_tpu_torch.reconstruction.runner import process_file

    return process_file(name, root, "ply", "ply",
                        reconstruct_wireframe, write_ply_points)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from faceformer_tpu_torch.reconstruction.runner import run_cli

    run_cli("wireframe reconstruction", "ply", reconstruct_file, argv)


if __name__ == "__main__":
    main()
