"""ABC-style per-object topology stats for native corpora.

A copy of faceformer_tpu/tools/stats.py with its imports renamed to
the port's modules: the same inputs write the same files.

The reference's topology filter bins objects by integer features read
from ABC's ``stat/<id>.yml`` sidecars (dataset/filters/filter_topology.py:
41-59: ``#edges``, ``#parts``, ``#sharp``, ``#surfs`` plus per-edge curve
-type and per-face surface-type name lists). ABC ships those files; a
generated corpus has none, so the filter chain could never execute on the
native pipeline's output. This module derives the same stats straight
from the parsed B-Rep (step21.read_brep), letting
``prepare_data --backend native`` emit ``stat/*.yml`` and the full
topology -> 3-view dedup chain run CAD-free.

Sharpness: an edge is SMOOTH when the surface normals of its two incident
face-uses agree (up to sign) at the edge midpoint — seams (both uses on
one face) and tangential joins like a hemisphere cap on its cylinder wall
or a fillet torus on its wall. Analytic kinds compare exact normals;
freeform faces (B-spline walls/patches/revolutions) count as sharp against
any DIFFERENT face, which is exact for every writer in step21 (their
freeform joins are profile corners or cap circles, never tangential).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from faceformer_tpu_torch.tools import step21
from faceformer_tpu_torch.tools.step21 import (
    BSPLINE, CONE, CYLINDER, EXTRUSION, PLANE, REVOLUTION, SPHERE, TORUS,
    BEdge, BFace, BSolid)

CURVE_NAMES = {"line": "Line", "circle": "Circle", "bspline": "BSpline"}
SURF_NAMES = {PLANE: "Plane", CYLINDER: "Cylinder", CONE: "Cone",
              SPHERE: "Sphere", TORUS: "Torus", REVOLUTION: "Revolution",
              EXTRUSION: "Extrusion", BSPLINE: "BSpline"}

#: normals within this many radians (mod sign) make an edge smooth; OCC
#: uses ~0.01 rad for its sharp-edge stat
_SMOOTH_TOL = 1e-3


def curve_name(curve) -> str:
    return CURVE_NAMES.get(curve.kind, "Other")


def surf_name(face: BFace) -> str:
    return SURF_NAMES.get(face.surface_kind, "Other")


def _analytic_normal(face: BFace, p: np.ndarray) -> Optional[np.ndarray]:
    """Unsigned surface normal of an analytic face at an on-surface point;
    None for freeform kinds (B-spline walls / patches / revolutions)."""
    o, z = face.frame.origin, face.frame.z
    if face.surface_kind == PLANE:
        return z
    r = p - o
    if face.surface_kind == SPHERE:
        n = r
    elif face.surface_kind in (CYLINDER, CONE, TORUS):
        rad = r - np.dot(r, z) * z
        nrad = float(np.linalg.norm(rad))
        if nrad < 1e-12:
            return None  # on the axis: degenerate sample, treat as sharp
        ur = rad / nrad
        if face.surface_kind == CYLINDER:
            n = ur
        elif face.surface_kind == CONE:
            n = ur - np.tan(face.semi_angle) * z
        else:  # TORUS: normal points from the tube-circle center
            n = p - (o + face.radius * ur)
    else:
        return None
    nn = float(np.linalg.norm(n))
    return n / nn if nn > 1e-12 else None


def _edge_midpoint(edge: BEdge, tol: float) -> np.ndarray:
    from faceformer_tpu_torch.tools.step_native import discretize_bedge

    pts = np.asarray(discretize_bedge(edge, tol))
    return pts[len(pts) // 2]


def count_sharp(solid: BSolid, tol: float = 1e-3) -> int:
    incident: Dict[int, List[BFace]] = {}
    edges: Dict[int, BEdge] = {}
    for face in solid.faces:
        for loop in face.loops:
            for edge, _ in loop:
                incident.setdefault(id(edge), []).append(face)
                edges[id(edge)] = edge
    sharp = 0
    for key, faces in incident.items():
        distinct = {id(f) for f in faces}
        if len(distinct) < 2:
            continue  # seam (or boundary): both uses on one face -> smooth
        f0, f1 = faces[0], faces[1]
        p = _edge_midpoint(edges[key], tol)
        n0, n1 = _analytic_normal(f0, p), _analytic_normal(f1, p)
        if n0 is None or n1 is None:
            sharp += 1  # freeform join: sharp in every step21 writer
            continue
        if float(np.linalg.norm(np.cross(n0, n1))) > _SMOOTH_TOL:
            sharp += 1
    return sharp


def solid_stat(solids: List[BSolid], tol: float = 1e-3) -> dict:
    """The reference stat schema for one object (its list of solids)."""
    curves: List[str] = []
    surfs: List[str] = []
    n_edges = n_sharp = 0
    for solid in solids:
        solid_edges = solid.edges()
        n_edges += len(solid_edges)
        curves += [curve_name(e.curve) for e in solid_edges]
        surfs += [surf_name(f) for f in solid.faces]
        n_sharp += count_sharp(solid, tol)
    return {"#edges": n_edges, "#parts": len(solids), "#sharp": n_sharp,
            "#surfs": len(surfs), "curves": curves, "surfs": surfs}


def write_stat(step_path: str, out_path: str, tol: float = 1e-3) -> dict:
    """read_brep a STEP file and write its stat yml; returns the stat."""
    import yaml

    stat = solid_stat(step21.read_brep(step_path), tol)
    with open(out_path, "w") as f:
        yaml.safe_dump(stat, f, sort_keys=False)
    return stat


def main(argv=None) -> None:
    """Backfill stat/*.yml for an existing corpus (step/ already on disk):

        python -m faceformer_tpu_torch.tools.stats --root data/step4k
    """
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--tol", type=float, default=1e-3)
    args = parser.parse_args(argv)

    step_dir = os.path.join(args.root, "step")
    out_dir = os.path.join(args.root, "stat")
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(step_dir)
                   if n.endswith(".step"))
    done = failed = 0
    for name in names:
        out = os.path.join(out_dir, f"{name}.yml")
        if os.path.exists(out):
            done += 1
            continue
        try:
            write_stat(os.path.join(step_dir, f"{name}.step"), out,
                       tol=args.tol)
            done += 1
        except Exception as exc:  # per-item fault tolerance
            failed += 1
            print(f"{name} stat failed: {exc}")
    print(f"{done} stats written, {failed} failed")


if __name__ == "__main__":
    main()
