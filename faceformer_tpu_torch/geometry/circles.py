"""Circle fitting and arc discretization in pure numpy (no CAD kernel).

A copy of faceformer_tpu/geometry/circles.py, kept so the port imports
nothing of the JAX package: the same points give the same arcs.

The reference leans on OpenCascade to discretize a fitted circle
(reconstruction/reconstruction_utils.py:171-221). Circles are cheap analytic
objects, so we do the whole job in numpy: fit the circumcircle of three 3D
points, discretize it to a chordal deflection, and slice out the arc passing
through the middle point.
"""

from __future__ import annotations

import numpy as np


def circle_through_points(p1, p2, p3):
    """Circumcircle of three 3D points: (center, radius, unit normal).

    Same algebra as the reference's find_circle_center
    (reconstruction_utils.py:187-206).
    """
    p1, p2, p3 = (np.asarray(p, dtype=float) for p in (p1, p2, p3))
    t = p2 - p1
    u = p3 - p1
    v = p3 - p2
    w = np.cross(t, u)
    wsl = float(w.dot(w))
    if wsl <= 0.0:
        raise ValueError("collinear points have no circumcircle")
    inv2 = 1.0 / (2.0 * wsl)
    tt, uu = float(t.dot(t)), float(u.dot(u))
    center = p1 + (u * tt * float(u.dot(v)) - t * uu * float(t.dot(v))) * inv2
    radius = float(np.sqrt(tt * uu * float(v.dot(v)) * inv2 / 2.0))
    normal = w / np.sqrt(wsl)
    return center, radius, normal


def discretize_circle(center, radius, normal, deflection: float = 1e-5) -> np.ndarray:
    """Discretize a full 3D circle to points whose chords deviate < deflection.

    Returns a closed polyline: first point repeated at the end, mirroring
    OCC's discretized circular edge so downstream arc slicing can treat the
    array as cyclic with ``len(pts)-1`` unique points.
    """
    center = np.asarray(center, dtype=float)
    normal = np.asarray(normal, dtype=float)
    normal = normal / np.linalg.norm(normal)
    # orthonormal in-plane basis
    helper = np.array([1.0, 0.0, 0.0])
    if abs(normal[0]) > 0.9:
        helper = np.array([0.0, 1.0, 0.0])
    e1 = np.cross(normal, helper)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(normal, e1)
    # chordal deflection d = r (1 - cos(step/2))  =>  step = 2 acos(1 - d/r)
    frac = min(max(deflection / max(radius, 1e-30), 0.0), 2.0)
    step = 2.0 * np.arccos(1.0 - frac) if frac < 1.0 else np.pi / 2
    n = max(int(np.ceil(2.0 * np.pi / max(step, 1e-9))), 8)
    theta = np.linspace(0.0, 2.0 * np.pi, n + 1)  # closed: endpoint included
    return center + radius * (np.cos(theta)[:, None] * e1 + np.sin(theta)[:, None] * e2)


def arc_between_points(pts: np.ndarray, p1, p2, p3) -> np.ndarray:
    """Slice the arc of a discretized circle running p1 -> p3 -> p2.

    Same selection rule as the reference (reconstruction_utils.py:208-221):
    find the nearest discretized points to p1 and p2, then keep the side of
    the circle whose initial direction points toward p3.
    """
    pts = np.asarray(pts, dtype=float)
    p1, p2, p3 = (np.asarray(p, dtype=float) for p in (p1, p2, p3))
    i1 = int(np.argmin(np.linalg.norm(pts - p1, axis=1)))
    i2 = int(np.argmin(np.linalg.norm(pts - p2, axis=1)))
    i1, i2 = min(i1, i2), max(i1, i2)
    toward_mid = p3 - pts[i1]
    v1 = pts[(i1 + 1) % (len(pts) - 1)] - pts[i1]
    if float(np.dot(v1, toward_mid)) > 0:
        return pts[i1 : i2 + 1]
    # wraparound: drop the closed polyline's seam point (pts[-1] ~= pts[0])
    # so the returned arc doesn't contain a near-zero-length segment
    return np.vstack([pts[i2:-1], pts[: i1 + 1]])


def fit_arc_through_points(p1, p2, p3, deflection: float = 1e-5) -> np.ndarray:
    """Fit the circumcircle of (p1, p2, p3) and return the p1 -> p3 -> p2 arc
    as a discretized 3D polyline (reference fit_curve semantics,
    reconstruction_utils.py:171-185)."""
    center, radius, normal = circle_through_points(p1, p2, p3)
    pts = discretize_circle(center, radius, normal, deflection)
    return arc_between_points(pts, p1, p2, p3)
