"""CAD-free STEP -> topology pipeline: the native backend of
tools/prepare_data.py.

A copy of faceformer_tpu/tools/step_native.py with its imports renamed to
the port's modules, but for one change: the torus, revolution and patch
splitters start each silhouette trace from the first open end in event
order, where the JAX module takes the first a set of object ids yields.
A trace run from its other end samples other points, so there the output
varied from run to run with the objects' addresses; here the same inputs
write the same files on every run and at any --num_cores, and the same
faces, types and vertices as the JAX module's.

Reproduces the reference generation algorithm (dataset/prepare_data.py,
dataset/utils/TopoMapper.py) for plane/cylinder/cone/sphere/torus B-Reps
plus freeform B-spline extrusion walls and B-spline surfaces of
revolution WITHOUT OpenCascade, using the Part 21 reader in
``step21.py``:

  1. bbox-normalize the solid (center + scale so the extent diagonal is 2,
     reference prepare_data.py:294-300);
  2. analytic hidden-line-removal outline computation: the silhouette
     rulings of every cylindrical/conical face, the silhouette circles of
     spherical faces, and the traced silhouette branches of toroidal
     bands under the camera (the outline curves OCC's OutLineVCompound3d
     finds, TopoMapper.py:38-43), and face splitting along them
     (TopoMapper.py:58-83 does this through BRepFeat_SplitShape; here
     the split is exact for ruled/spherical faces — arcs divide at the
     silhouette angles and new ruling/arc edges bound the sub-faces —
     and deflection-sampled polylines for torus outlines, which are
     quartics OCC's HLR also hands over discretized);
  3. topology mapping: ordered oriented edge loops per face -> shared
     EdgeRecord/FaceRecord graph (TopoMapper.py:85-116);
  4. edge discretization (deflection-controlled arc sampling, OCC
     discretize_edge semantics) + camera projection;
  5. sewn-edge removal: seam edges (an edge used twice within one face)
     are removed and their faces merged through the SAME machinery the
     OCC backend uses (TopoMapper._remove_sewn_edges — inherited, it is
     pure record arithmetic; reference TopoMapper.py:118-185).

Surfaces/curves outside the plane/cylinder/cone/sphere/ring-torus/
B-spline-extrusion/B-spline-revolution + line/circle/B-spline subset —
and view configurations the analytic sweeps cannot certify (silhouette
islands from a near camera, grazing tangencies, partial-revolution
bands, weaving revolution silhouettes whose region structure the band
assembler cannot pin) — raise step21.UnsupportedStep, routing those
shapes to the optional OCC backend (or a camera re-roll).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from faceformer_tpu_torch.tools import step21
from faceformer_tpu_torch.tools.step21 import (
    BCurve, BEdge, BFace, BSolid, BVertex, Frame, UnsupportedStep,
    BSPLINE, CONE, CYLINDER, EXTRUSION, PLANE, REVOLUTION, SPHERE, TORUS,
    bspline_domain, bspline_eval, bspline_hodograph,
    patch_boundary_curve, patch_eval, patch_partials,
)
from faceformer_tpu_torch.tools.occ_pipeline import (
    EdgeRecord, FaceRecord, ProjectionArgs, TopoMapper,
)

TWO_PI = 2.0 * np.pi
_EPS_ANGLE = 1e-6


# ---------------------------------------------------------------------------
# edge discretization (OCC discretize_edge semantics: chordal deflection)
# ---------------------------------------------------------------------------


def ensure_arc_span(edge: BEdge) -> Tuple[float, float]:
    """Circle parameter interval (t0, t1) traversed in the edge's natural
    direction (CCW in the curve frame). Full circle when the endpoints
    coincide."""
    if edge.arc_span is not None:
        return edge.arc_span
    c = edge.curve
    f = c.frame
    q0, q1 = edge.v0.point - f.origin, edge.v1.point - f.origin
    t0 = float(np.arctan2(q0 @ f.y, q0 @ f.x))
    t1 = float(np.arctan2(q1 @ f.y, q1 @ f.x))
    if float(np.linalg.norm(edge.v0.point - edge.v1.point)) < 1e-9:
        span = (t0, t0 + TWO_PI)
    else:
        delta = (t1 - t0) % TWO_PI
        if delta < _EPS_ANGLE:
            delta = TWO_PI
        span = (t0, t0 + delta)
    edge.arc_span = span
    return span


def discretize_bedge(edge: BEdge, tol: float,
                     max_points: int = 512) -> np.ndarray:
    """3D polyline of the edge in its natural direction. Lines are their
    two endpoints; arcs sample at the chordal deflection ``tol``
    (reference: OCC.Extend.TopologyUtils.discretize_edge(edge, tol))."""
    if edge.curve.kind == "line":
        return np.stack([edge.v0.point, edge.v1.point])
    if edge.curve.kind == "poly":
        # silhouette polylines carry their own tol-deflection sampling
        return np.asarray(edge.curve.points, dtype=float)
    if edge.curve.kind == "bspline":
        return _discretize_bspline(edge, tol, max_points)
    c = edge.curve
    t0, t1 = ensure_arc_span(edge)
    r = max(c.radius, 1e-12)
    dt = 2.0 * np.arccos(np.clip(1.0 - tol / r, -1.0, 1.0))
    npts = int(np.ceil((t1 - t0) / max(dt, 1e-6))) + 1
    npts = int(np.clip(npts, 3, max_points))
    t = np.linspace(t0, t1, npts)
    f = c.frame
    pts = (f.origin[None, :]
           + c.radius * np.cos(t)[:, None] * f.x[None, :]
           + c.radius * np.sin(t)[:, None] * f.y[None, :])
    # exact shared endpoints (vertex coincidence is what the downstream
    # enclosedness chaining keys on, check_faces_enclosed.py:18-46)
    pts[0], pts[-1] = edge.v0.point, edge.v1.point
    return pts


def _discretize_bspline(edge: BEdge, tol: float,
                        max_points: int = 512) -> np.ndarray:
    """Chordal-deflection sampling of a (sub-span of a) B-spline edge:
    seed with the knot lines, then bisect every chord whose midpoint
    deviates more than ``tol`` (OCC discretize_edge semantics on freeform
    curves)."""
    c = edge.curve
    lo, hi = (edge.arc_span if edge.arc_span is not None
              else bspline_domain(c))
    interior = [float(k) for k in c.knots if lo + 1e-12 < k < hi - 1e-12]
    ts = sorted(set([float(lo), float(hi)] + interior))
    while len(ts) < 9:
        ts = sorted(set(ts) | {(a + b) / 2 for a, b in zip(ts, ts[1:])})
    for _ in range(16):
        pts = bspline_eval(c, ts)
        mids_t = [(a + b) / 2 for a, b in zip(ts, ts[1:])]
        mids = bspline_eval(c, mids_t)
        dev = np.linalg.norm(mids - (pts[:-1] + pts[1:]) / 2, axis=1)
        bad = [m for m, d in zip(mids_t, dev) if d > tol]
        if not bad or len(ts) + len(bad) > max_points:
            break
        ts = sorted(set(ts) | set(bad))
    pts = bspline_eval(c, ts)
    # exact shared endpoints (enclosedness chaining keys on coincidence)
    pts[0], pts[-1] = edge.v0.point, edge.v1.point
    return pts


# ---------------------------------------------------------------------------
# normalization (reference prepare_data.py:294-300)
# ---------------------------------------------------------------------------


def solid_bbox(solid: BSolid, tol: float = 1e-3) -> Tuple[np.ndarray, np.ndarray]:
    pts = [np.concatenate([discretize_bedge(e, tol, max_points=128)
                           for e in solid.edges()])]
    for face in solid.faces:
        if face.surface_kind == SPHERE:
            # a sphere cap bulges past its boundary edges: include the cap
            # pole (or, unclassifiable caps, the conservative full-sphere
            # corners)
            try:
                cap = _sphere_cap(face, face.loops[0])
                pts.append(face.frame.origin[None, :]
                           + face.radius * cap.w[None, :])
            except UnsupportedStep:
                corner = np.full(3, face.radius)
                pts.append(np.stack([face.frame.origin - corner,
                                     face.frame.origin + corner]))
        elif face.surface_kind == TORUS:
            pts.append(_torus_band_extremes(face))
        elif face.surface_kind == REVOLUTION:
            pts.append(_revolution_extremes(face))
        elif face.patch is not None:
            # a doubly-curved patch bulges past its boundary edges: sample
            # the surface densely (the control hull would over-estimate)
            (ul, uh), (vl, vh) = face.patch.domain()
            uv = np.stack(np.meshgrid(np.linspace(ul, uh, 33),
                                      np.linspace(vl, vh, 33),
                                      indexing="ij"), axis=-1)
            pts.append(patch_eval(face.patch, uv.reshape(-1, 2)))
    pts = np.concatenate(pts)
    return pts.min(axis=0), pts.max(axis=0)


def _revolution_extremes(face: BFace, samples: int = 256) -> np.ndarray:
    """Axis-aligned extreme points of a full revolution band: the belly of
    the profile sweeps circles its boundary edges never visit (only the
    u = u_s meridian and the end rings are edges), so sample the profile
    and emit each station circle's per-world-axis extremes (same recipe as
    _torus_band_extremes)."""
    C, Z = face.frame.origin, face.frame.z
    lo, hi = bspline_domain(face.profile)
    p = bspline_eval(face.profile, np.linspace(lo, hi, samples)) - C[None, :]
    rho = p @ face.frame.x
    z = p @ Z
    centers = C[None, :] + z[:, None] * Z[None, :]
    out = []
    for e in np.eye(3):
        r_in = e - Z * float(Z @ e)
        n = float(np.linalg.norm(r_in))
        r_hat = r_in / n if n > 1e-12 else face.frame.x
        out.append(centers + rho[:, None] * r_hat[None, :])
        out.append(centers - rho[:, None] * r_hat[None, :])
    return np.concatenate(out)


def _torus_band_extremes(face: BFace, samples: int = 256) -> np.ndarray:
    """Axis-aligned extreme points of a full-revolution torus band: for a
    band v in [v0, v0+H] the surface is C + rho(v) e_r(u) + z(v) Z swept
    over all u, so the per-world-axis extent is max_v (rho(v) s_i +- z(v)
    Z_i) with s_i = |projection of world axis i onto the torus plane| —
    exact in u, sampled in v. Falls back to the full-torus bound when the
    band's v-interval cannot be classified."""
    f, R, r = face.frame, face.radius, face.radius2
    try:
        v0, H = _torus_vrange(face)
        v = v0 + np.linspace(0.0, H, samples)
    except UnsupportedStep:
        v = np.linspace(0.0, TWO_PI, samples)
    rho, z = R + r * np.cos(v), r * np.sin(v)
    zax = f.z
    s = np.sqrt(np.maximum(1.0 - zax * zax, 0.0))  # per-axis in-plane reach
    hi = (rho[:, None] * s[None, :] + z[:, None] * zax[None, :]).max(axis=0)
    lo = (-rho[:, None] * s[None, :] + z[:, None] * zax[None, :]).min(axis=0)
    return np.stack([f.origin + lo, f.origin + hi])


def _torus_vrange(face: BFace) -> Tuple[float, float]:
    """(v_start, H): the tube-angle interval of a torus band face, derived
    from its seam arc (the tube circle at u = 0 used twice in the wire)."""
    C, R, r = face.frame.origin, face.radius, face.radius2
    zax = face.frame.z
    counts: Dict[int, int] = {}
    edges: Dict[int, BEdge] = {}
    for loop in face.loops:
        for edge, _ in loop:
            counts[id(edge)] = counts.get(id(edge), 0) + 1
            edges[id(edge)] = edge
    for key, edge in edges.items():
        if counts[key] < 2 or edge.curve.kind != "circle":
            continue
        if abs(edge.curve.radius - r) > 1e-6:
            continue
        off = edge.curve.frame.origin - C
        if abs(float(off @ zax)) > 1e-6:
            continue
        if abs(float(np.linalg.norm(off - (off @ zax) * zax)) - R) > 1e-6:
            continue
        def v_of(p):
            q = p - C
            zc = float(q @ zax)
            rad = float(np.linalg.norm(q - zc * zax))
            return float(np.arctan2(zc / r, (rad - R) / r))
        va, vb = v_of(edge.v0.point), v_of(edge.v1.point)
        vm = v_of(midpoint_of(edge))
        H = (vb - va) % TWO_PI or TWO_PI
        if (vm - va) % TWO_PI <= H:
            return va, H
        return vb, (va - vb) % TWO_PI or TWO_PI
    raise UnsupportedStep("torus band without a classifiable tube seam")


def normalize_solid(solid: BSolid) -> float:
    """Center the solid and scale its bbox diagonal to 2, in place.
    Returns the scale applied."""
    lo, hi = solid_bbox(solid)
    center = (lo + hi) / 2
    scale = 2.0 / max(float(np.linalg.norm(hi - lo)), 1e-9)
    seen = set()

    def _move(point: np.ndarray) -> np.ndarray:
        return (point - center) * scale

    for face in solid.faces:
        if id(face.frame) not in seen:
            seen.add(id(face.frame))
            face.frame.origin = _move(face.frame.origin)
        face.radius *= scale
        face.radius2 *= scale
        if face.profile is not None and id(face.profile) not in seen:
            # similarity transforms act on B-splines through their control
            # points (affine invariance); the knot parametrization is kept
            seen.add(id(face.profile))
            face.profile.ctrl = _move(np.asarray(face.profile.ctrl, dtype=float))
        if face.extrude is not None:
            face.extrude = np.asarray(face.extrude, dtype=float) * scale
        if face.patch is not None and id(face.patch) not in seen:
            seen.add(id(face.patch))
            face.patch.grid = _move(np.asarray(face.patch.grid, dtype=float))
        for loop in face.loops:
            for edge, _ in loop:
                if id(edge) in seen:
                    continue
                seen.add(id(edge))
                edge.arc_span = None  # invalidate cached spans
                for v in (edge.v0, edge.v1):
                    if id(v) not in seen:
                        seen.add(id(v))
                        v.point = _move(v.point)
                c = edge.curve
                if id(c) not in seen:
                    seen.add(id(c))
                    if c.kind == "line":
                        c.point = _move(c.point)
                    elif c.kind == "poly":
                        c.points = _move(np.asarray(c.points, dtype=float))
                    elif c.kind == "bspline":
                        c.ctrl = _move(np.asarray(c.ctrl, dtype=float))
                    else:
                        c.radius *= scale
                        if id(c.frame) not in seen:
                            seen.add(id(c.frame))
                            c.frame.origin = _move(c.frame.origin)
    return scale


# ---------------------------------------------------------------------------
# camera (reference projection_utils.py / HLRAlgo_Projector semantics)
# ---------------------------------------------------------------------------


class NativeProjector:
    """View frame + projection matching occ_pipeline._projector's inputs.

    The view frame comes from either a pose matrix (columns right/up/N,
    translation = frame origin — occ_pipeline.py:150-152) or a
    location+direction pair (N = normalized direction; the X direction is
    then a deterministic perpendicular — OCC picks its own convention,
    which only rotates the 2D wireframe; documented deviation).
    Orthographic (focus == 0) drops the N component; perspective places
    the eye at ``origin + focus * N`` and divides: x' = x * f / (f - z)
    (OCC HLRAlgo_Projector focal semantics)."""

    def __init__(self, args: ProjectionArgs):
        if args.pose is not None:
            pose = np.asarray(args.pose, dtype=float)
            self.origin = pose[:3, -1].copy()
            self.n = _unit(pose[:3, 2])
            self.vx = _unit(pose[:3, 0])
        else:
            self.origin = np.asarray(args.location, dtype=float)
            self.n = _unit(np.asarray(args.direction, dtype=float))
            seed = np.array([0.0, 0.0, 1.0])
            if abs(float(seed @ self.n)) > 0.9:
                seed = np.array([1.0, 0.0, 0.0])
            self.vx = _unit(np.cross(seed, self.n))
        self.vy = np.cross(self.n, self.vx)
        self.focus = float(args.focus)

    @property
    def eye(self) -> Optional[np.ndarray]:
        if self.focus == 0.0:
            return None
        return self.origin + self.focus * self.n

    def project(self, pts) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(pts, dtype=float))
        q = pts - self.origin
        cam = np.stack([q @ self.vx, q @ self.vy, q @ self.n], axis=1)
        if self.focus == 0.0:
            return cam
        denom = np.maximum(self.focus - cam[:, 2], 1e-6)
        scale = self.focus / denom
        return np.stack([cam[:, 0] * scale, cam[:, 1] * scale, cam[:, 2]], axis=1)


def _unit(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    if n < 1e-12:
        raise UnsupportedStep("degenerate view direction")
    return np.asarray(v, dtype=float) / n


# ---------------------------------------------------------------------------
# analytic silhouettes (the HLR outline curves of cylinder/cone faces)
# ---------------------------------------------------------------------------


def _solve_silhouette(a: float, b: float, c: float) -> List[float]:
    """Angles theta with a*cos(theta) + b*sin(theta) = c."""
    amp = float(np.hypot(a, b))
    if amp < 1e-12 or amp < abs(c) - 1e-12:
        return []
    phi = float(np.arctan2(b, a))
    delta = float(np.arccos(np.clip(c / amp, -1.0, 1.0)))
    if delta < 1e-3 or abs(np.pi - delta) < 1e-3:
        return []  # grazing tangency: the silhouette has no area to split
    return [phi + delta, phi - delta]


def silhouette_angles(face: BFace, projector: NativeProjector) -> List[float]:
    """Face-frame angles of the silhouette rulings (the outline curves OCC's
    HLR finds on smooth surfaces, TopoMapper.py:38-43). Empty for planes."""
    if face.surface_kind == PLANE:
        return []
    f = face.frame
    if face.surface_kind == CYLINDER:
        if projector.eye is None:
            v = projector.n
            return _solve_silhouette(float(f.x @ v), float(f.y @ v), 0.0)
        q = f.origin - projector.eye
        return _solve_silhouette(float(f.x @ q), float(f.y @ q), -face.radius)
    # cone: normal(theta) ~ cos(a)(cos t x + sin t y) - sin(a) z
    alpha = face.semi_angle
    ca, sa = float(np.cos(alpha)), float(np.sin(alpha))
    if projector.eye is None:
        v = projector.n
        return _solve_silhouette(ca * float(f.x @ v), ca * float(f.y @ v),
                                 sa * float(f.z @ v))
    tan_a = np.tan(alpha)
    if abs(tan_a) < 1e-9:  # degenerate cone == cylinder
        q = f.origin - projector.eye
        return _solve_silhouette(float(f.x @ q), float(f.y @ q), -face.radius)
    apex = f.origin - (face.radius / tan_a) * f.z
    q = apex - projector.eye
    return _solve_silhouette(ca * float(f.x @ q), ca * float(f.y @ q),
                             sa * float(f.z @ q))


# ---------------------------------------------------------------------------
# face splitting along silhouette rulings
# ---------------------------------------------------------------------------


@dataclass
class _Piece:
    """One circular arc of a curved face, in face-frame angles:
    CCW span (s, e) with e > s; ``sense`` +1 when the edge's natural
    direction runs CCW in the face frame."""

    edge: BEdge
    s: float
    e: float
    sense: int
    station: int


def _wrap(theta: float, lo: float) -> float:
    """Map theta into [lo, lo + 2*pi)."""
    return lo + float((theta - lo) % TWO_PI)


class _FaceSplitter:
    """Split one cylindrical/conical face along silhouette rulings.

    Assumes the standard swept-face boundary: circular arcs at exactly two
    axial stations plus axial/slant line edges (seams and rulings). Curved
    faces outside that shape (trimmed by non-circular intersections) are
    not representable with LINE/CIRCLE edges in the first place, so the
    reader has already rejected them.
    """

    def __init__(self, face: BFace, projector: NativeProjector, tol: float,
                 registry: "_SplitRegistry"):
        self.face = face
        self.tol = tol
        self.reg = registry
        if len(face.loops) != 1:
            raise UnsupportedStep("multi-loop curved faces need the OCC backend")
        # expand through prior substitutions so an arc shared with an
        # already-split neighbor face splits its sub-pieces, not the parent
        self.loop = registry.expand(face.loops[0])
        self.f = face.frame
        self.cuts = silhouette_angles(face, projector)

    # -- face-frame helpers ------------------------------------------------

    def _theta(self, p: np.ndarray) -> float:
        q = p - self.f.origin
        return float(np.arctan2(q @ self.f.y, q @ self.f.x))

    def _z(self, p: np.ndarray) -> float:
        return float((p - self.f.origin) @ self.f.z)

    def _station_radius(self, z: float) -> float:
        if self.face.surface_kind == CYLINDER:
            return self.face.radius
        return self.face.radius + z * float(np.tan(self.face.semi_angle))

    def _point_at(self, theta: float, z: float) -> np.ndarray:
        r = self._station_radius(z)
        return (self.f.origin + z * self.f.z
                + r * (np.cos(theta) * self.f.x + np.sin(theta) * self.f.y))

    # -- classification ------------------------------------------------------

    def _classify(self):
        arcs: List[Tuple[BEdge, int]] = []  # (edge, times seen)
        lines: Dict[int, BEdge] = {}
        line_count: Dict[int, int] = {}
        seen = set()
        for edge, _ in self.loop:
            if edge.curve.kind == "circle":
                if id(edge) not in seen:
                    seen.add(id(edge))
                    arcs.append((edge, 1))
            else:
                line_count[id(edge)] = line_count.get(id(edge), 0) + 1
                lines[id(edge)] = edge
        # stations from arc centers along the face axis
        zs = []
        for edge, _ in arcs:
            center = edge.curve.frame.origin
            off = center - self.f.origin
            axial = float(off @ self.f.z)
            if float(np.linalg.norm(off - axial * self.f.z)) > 1e-6:
                raise UnsupportedStep("arc center off the face axis")
            zs.append(axial)
        stations = sorted(set(round(z, 7) for z in zs))
        if len(stations) == 1 and self.face.surface_kind == CONE:
            # apex cone: the second bound is the apex point, where the
            # station radius vanishes (station_radius(z) = r + z*tan(a))
            tan_a = float(np.tan(self.face.semi_angle))
            if abs(tan_a) < 1e-9:
                raise UnsupportedStep("single-station cylinder-like cone")
            z_apex = -self.face.radius / tan_a
            if abs(z_apex - stations[0]) < 1e-6:
                raise UnsupportedStep("degenerate apex cone face")
            stations = sorted([float(stations[0]), z_apex])
        elif len(stations) != 2:
            raise UnsupportedStep(
                f"curved face with {len(stations)} axial stations")
        self.z_bot, self.z_top = float(stations[0]), float(stations[1])

        self.pieces: List[_Piece] = []
        for edge, _ in arcs:
            axial = float((edge.curve.frame.origin - self.f.origin) @ self.f.z)
            station = 0 if abs(axial - self.z_bot) < 1e-6 else 1
            sense = 1 if float(edge.curve.frame.z @ self.f.z) > 0 else -1
            t0, t1 = self._theta(edge.v0.point), self._theta(edge.v1.point)
            full = float(np.linalg.norm(edge.v0.point - edge.v1.point)) < 1e-9
            if sense > 0:
                s = t0
                e = t0 + TWO_PI if full else t0 + ((t1 - t0) % TWO_PI or TWO_PI)
            else:
                s = t1
                e = t1 + TWO_PI if full else t1 + ((t0 - t1) % TWO_PI or TWO_PI)
            self.pieces.append(_Piece(edge, s, e, sense, station))

        self.seam: Optional[BEdge] = None
        self.boundary_lines: Dict[float, BEdge] = {}
        for key, edge in lines.items():
            theta = self._theta((edge.v0.point + edge.v1.point) / 2)
            if line_count[key] >= 2:
                self.seam = edge
                self.seam_theta = theta
            else:
                self.boundary_lines[theta] = edge

    def _domain(self) -> Tuple[float, float, bool]:
        """CCW angular interval covered by the face, from the top-station
        arcs (or the bottom's when the top bound is a cone apex):
        (lo, hi, is_full_circle)."""
        tops = sorted((p for p in self.pieces if p.station == 1),
                      key=lambda p: p.s)
        if not tops:
            tops = sorted((p for p in self.pieces if p.station == 0),
                          key=lambda p: p.s)
        total = sum(p.e - p.s for p in tops)
        if total > TWO_PI - 1e-6:
            return tops[0].s, tops[0].s + TWO_PI, True
        lo = tops[0].s
        hi = tops[0].e
        for p in tops[1:]:
            s = _wrap(p.s, lo)
            if abs(s - hi) > 1e-5:
                raise UnsupportedStep("non-contiguous curved face domain")
            hi = s + (p.e - p.s)
        return lo, hi, False

    # -- splitting ------------------------------------------------------------

    def split(self) -> Optional[List[BFace]]:
        """Returns replacement sub-faces, or None when no silhouette ruling
        crosses the face interior."""
        if not self.cuts:
            return None
        self._classify()
        lo, hi, full = self._domain()
        existing = [_wrap(p.s, 0.0) for p in self.pieces]
        existing += [_wrap(p.e, 0.0) for p in self.pieces]

        def near_existing(theta: float) -> bool:
            t = _wrap(theta, 0.0)
            return any(min(abs(t - e), TWO_PI - abs(t - e)) < 1e-4
                       for e in existing)

        cuts = []
        for c in self.cuts:
            cw = _wrap(c, lo)
            inside = True if full else (lo + 1e-4 < cw < hi - 1e-4)
            if inside and not near_existing(cw):
                cuts.append(cw)
        cuts = sorted(set(round(c, 9) for c in cuts))
        if not cuts:
            return None

        # split every arc piece at the interior cut angles
        pieces: List[_Piece] = []
        for p in self.pieces:
            inner = [c for base in cuts
                     for c in (_wrap(base, p.s),)
                     if p.s + 1e-6 < c < p.e - 1e-6]
            pieces.extend(self._split_piece(p, sorted(inner)))
        self.pieces = pieces

        # ruling edges at each cut (new) and at the domain boundary (existing)
        rulings: Dict[float, BEdge] = {}
        for c in cuts:
            p_bot, p_top = self._point_at(c, self.z_bot), self._point_at(c, self.z_top)
            edge = BEdge(BVertex(p_bot), BVertex(p_top),
                         BCurve("line", point=p_bot,
                                direction=_unit(p_top - p_bot)))
            # reuse the split-piece endpoint vertices so chains coincide
            edge.v0 = self.reg.vertex_at(self, c, self.z_bot)
            edge.v1 = self.reg.vertex_at(self, c, self.z_top)
            rulings[round(c, 9)] = edge
        for theta, edge in self.boundary_lines.items():
            rulings[round(_wrap(theta, lo), 9)] = edge

        # traversal sense of the top arcs in the original wire; when one
        # bound is a cone apex (no arcs on that station) the bottom arcs
        # orient the wire instead — a swept wall's two stations are always
        # traversed in opposite rotational senses
        top_sense = 0
        for station, flip in ((1, 1), (0, -1)):
            for edge, orient in self.loop:
                for p in self.pieces:
                    if p.edge is edge or self.reg.parent_of(p.edge) is edge:
                        if p.station == station:
                            top_sense = flip * p.sense * (1 if orient == 0 else -1)
                            break
                if top_sense:
                    break
            if top_sense:
                break
        if top_sense == 0:
            raise UnsupportedStep("could not orient the curved face wire")

        if full:  # intervals between consecutive cuts, wrapping around
            bounds = cuts + [cuts[0] + TWO_PI]
        else:
            bounds = [lo] + cuts + [hi]
        intervals = list(zip(bounds[:-1], bounds[1:]))

        out: List[BFace] = []
        for g0, g1 in intervals:
            out.append(self._sub_face(g0, g1, rulings, top_sense, lo))
        return out

    def _split_piece(self, p: _Piece, inner: List[float]) -> List[_Piece]:
        if not inner:
            return [p]
        bounds = [p.s] + inner + [p.e]
        z = self.z_bot if p.station == 0 else self.z_top
        # vertices at the boundary angles; ends reuse the parent's vertices
        verts = []
        for i, theta in enumerate(bounds):
            if i == 0:
                verts.append(p.edge.v0 if p.sense > 0 else p.edge.v1)
            elif i == len(bounds) - 1:
                verts.append(p.edge.v1 if p.sense > 0 else p.edge.v0)
            else:
                verts.append(self.reg.vertex_at(self, theta, z,
                                                make=self._point_at(theta, z)))
        subs_ccw: List[_Piece] = []
        for i in range(len(bounds) - 1):
            s, e = bounds[i], bounds[i + 1]
            v_s, v_e = verts[i], verts[i + 1]
            curve = BCurve(
                "circle",
                frame=Frame(self.f.origin + z * self.f.z,
                            self.f.z if p.sense > 0 else -self.f.z,
                            self.f.x),
                radius=self._station_radius(z))
            if p.sense > 0:
                edge = BEdge(v_s, v_e, curve, arc_span=(s, e))
            else:
                # natural direction CW in face frame; in the flipped curve
                # frame the angle of face-angle t is -t
                edge = BEdge(v_e, v_s, curve, arc_span=(-e, -s))
            subs_ccw.append(_Piece(edge, s, e, p.sense, p.station))
        natural = subs_ccw if p.sense > 0 else subs_ccw[::-1]
        self.reg.substitute(p.edge, [q.edge for q in natural])
        return subs_ccw

    def _sub_face(self, g0: float, g1: float, rulings: Dict[float, BEdge],
                  top_sense: int, lo: float) -> BFace:
        def pick(station: int) -> List[_Piece]:
            sel = []
            for p in self.pieces:
                if p.station != station:
                    continue
                mid = _wrap((p.s + p.e) / 2, g0)
                if g0 < mid < g1:
                    sel.append(p)
            return sorted(sel, key=lambda p: _wrap(p.s + 1e-9, g0))

        def ruling(theta: float):
            best, best_d = None, 1e-4
            for key, edge in rulings.items():
                d = abs(key - theta) % TWO_PI
                d = min(d, TWO_PI - d)
                if d < best_d:
                    best, best_d = edge, d
            if best is None:
                raise UnsupportedStep(
                    f"no boundary ruling near angle {theta:.6f}")
            return best

        def up(edge: BEdge) -> int:
            return 0 if self._z(edge.v1.point) > self._z(edge.v0.point) else 1

        def arc_orient(p: _Piece, ccw: bool) -> int:
            natural_ccw = p.sense > 0
            return 0 if natural_ccw == ccw else 1

        seam_here = (self.seam is not None
                     and g0 + 1e-6 < _wrap(self.seam_theta, g0) < g1 - 1e-6)
        seam_theta = _wrap(self.seam_theta, g0) if seam_here else None

        walk: List[Tuple[BEdge, int]] = []
        tops, bots = pick(1), pick(0)
        if top_sense > 0:  # up at g0, top CCW g0->g1, down at g1, bottom CW
            r0, r1 = ruling(g0), ruling(g1)
            walk.append((r0, up(r0)))
            walk.extend(self._arc_walk(tops, ccw=True, base=g0,
                                       seam_theta=seam_theta))
            walk.append((r1, 1 - up(r1)))
            walk.extend(self._arc_walk(bots, ccw=False, base=g0))
        else:  # up at g1, top CW g1->g0, down at g0, bottom CCW
            r0, r1 = ruling(g1), ruling(g0)
            walk.append((r0, up(r0)))
            walk.extend(self._arc_walk(tops, ccw=False, base=g0,
                                       seam_theta=seam_theta))
            walk.append((r1, 1 - up(r1)))
            walk.extend(self._arc_walk(bots, ccw=True, base=g0))
        return BFace(self.face.surface_kind, self.face.frame, self.face.radius,
                     self.face.semi_angle, self.face.same_sense, [walk],
                     fid=self.face.fid)

    def _arc_walk(self, pieces: List[_Piece], ccw: bool, base: float,
                  seam_theta: Optional[float] = None) -> List[Tuple[BEdge, int]]:
        ordered = pieces if ccw else pieces[::-1]
        out: List[Tuple[BEdge, int]] = []
        for p in ordered:
            if seam_theta is not None:
                # crossing the seam angle: descend and return (the seam
                # edge stays a doubly-used wire member of this sub-face,
                # exactly like the OCC wire — sewn removal then drops it)
                s = _wrap(p.s, base)
                boundary = s if ccw else _wrap(p.e, base)
                if abs(boundary - seam_theta) < 1e-5 and out:
                    out.append((self.seam, 1 - up_of(self.seam, self._z)))
                    out.append((self.seam, up_of(self.seam, self._z)))
                    seam_theta = None
            out.append((p.edge, arc_orient_of(p, ccw)))
        return out


def up_of(edge: BEdge, zfn) -> int:
    return 0 if zfn(edge.v1.point) > zfn(edge.v0.point) else 1


def arc_orient_of(p: _Piece, ccw: bool) -> int:
    return 0 if (p.sense > 0) == ccw else 1


# ---------------------------------------------------------------------------
# spherical faces: cap classification + silhouette-circle splitting
# ---------------------------------------------------------------------------


@dataclass
class _Cap:
    """A spherical cap: the face region {P : (P - C) @ w >= h} of a sphere
    (C, R), bounded by one circle of radius ``rho`` centered ``O_b``."""

    w: np.ndarray       # unit cap axis, pointing from the boundary plane
    h: float            # signed plane offset along w (negative: cap > half)
    O_b: np.ndarray     # boundary circle center
    rho: float          # boundary circle radius


def _sphere_cap(face: BFace, loop) -> _Cap:
    """Classify a sphere face's boundary as a single-circle cap.

    The cap side is derived from the boundary walk orientation: walking the
    oriented boundary with the outward surface normal up, the face lies to
    the left (STEP FACE_OUTER_BOUND convention — the same rule the writer's
    cap discs follow)."""
    C, R = face.frame.origin, face.radius
    edges: List[BEdge] = []
    seen = set()
    for edge, _ in loop:
        if edge.curve.kind != "circle":
            raise UnsupportedStep("sphere face bounded by a non-circle edge")
        if id(edge) in seen:
            raise UnsupportedStep("sphere face with a seam edge")
        seen.add(id(edge))
        edges.append(edge)
    centers = np.stack([e.curve.frame.origin for e in edges])
    radii = np.array([e.curve.radius for e in edges])
    if float(np.ptp(centers, axis=0).max()) > 1e-6 or float(np.ptp(radii)) > 1e-6:
        raise UnsupportedStep("sphere face boundary spans multiple circles")
    O_b, rho = centers[0], float(radii[0])
    off = O_b - C
    h_abs = float(np.linalg.norm(off))
    w = off / h_abs if h_abs > 1e-7 else np.array(edges[0].curve.frame.z, float)
    if abs(h_abs * h_abs + rho * rho - R * R) > 1e-4 * max(R * R, 1.0):
        raise UnsupportedStep("sphere boundary circle is not on the sphere")
    edge0, orient0 = loop[0]
    p0 = edge0.v0.point if orient0 == 0 else edge0.v1.point
    tangent = np.cross(edge0.curve.frame.z, p0 - edge0.curve.frame.origin)
    if orient0 == 1:
        tangent = -tangent
    n_out = (p0 - C) / R
    if float(np.cross(n_out, tangent) @ w) < 0:
        w = -w
    return _Cap(w, float(off @ w), O_b, rho)


def _sphere_silhouette(face: BFace,
                       projector: NativeProjector) -> Tuple[np.ndarray, float]:
    """Silhouette plane of a sphere under the camera: (u, g) with the
    silhouette circle = sphere ∩ {P : (P - C) @ u = g}; u points toward
    the viewer. Orthographic: the great circle normal to the view
    direction. Perspective from eye E at distance d: offset R^2/d."""
    C, R = face.frame.origin, face.radius
    if projector.eye is None:
        return projector.n, 0.0
    q = projector.eye - C
    d = float(np.linalg.norm(q))
    if d <= R * (1.0 + 1e-9):
        raise UnsupportedStep("camera eye inside a sphere")
    return q / d, R * R / d


class _SphereSplitter:
    """Split one spherical cap face along its silhouette circle.

    Three geometric regimes (margins treat tangency as grazing, like
    _solve_silhouette): the silhouette circle misses the cap (no split);
    it crosses the boundary circle at two points (split into a
    toward-camera and an away sub-face along the silhouette arc); or it
    lies entirely inside the cap (split into an inner sub-cap plus a band
    face with two loops). This is the sphere analogue of OCC's HLR outline
    splitting (reference TopoMapper.py:38-43, 58-83); sphere faces map to
    the reference's Other face type (Face.py:18-24, GeomAbs_Sphere = 3)."""

    _MARGIN = 1e-3

    def __init__(self, face: BFace, projector: NativeProjector, tol: float,
                 registry: "_SplitRegistry"):
        self.face = face
        self.tol = tol
        self.reg = registry
        if len(face.loops) != 1:
            raise UnsupportedStep("multi-loop sphere faces need the OCC backend")
        self.loop = registry.expand(face.loops[0])
        self.C, self.R = face.frame.origin, face.radius
        self.u, self.g = _sphere_silhouette(face, projector)
        self.cap = _sphere_cap(face, self.loop)
        w = self.cap.w
        seed = np.array([1.0, 0.0, 0.0])
        if abs(float(seed @ w)) > 0.9:
            seed = np.array([0.0, 1.0, 0.0])
        self.bx = _unit(seed - w * float(seed @ w))
        self.by = np.cross(w, self.bx)

    # -- boundary-frame helpers ---------------------------------------------

    def _theta(self, p: np.ndarray) -> float:
        q = p - self.cap.O_b
        return float(np.arctan2(q @ self.by, q @ self.bx))

    def _point_at(self, theta: float) -> np.ndarray:
        return (self.cap.O_b
                + self.cap.rho * (np.cos(theta) * self.bx
                                  + np.sin(theta) * self.by))

    def _classify_pieces(self) -> List[_Piece]:
        pieces = []
        for edge, _ in self.loop:
            sense = 1 if float(edge.curve.frame.z @ self.cap.w) > 0 else -1
            t0, t1 = self._theta(edge.v0.point), self._theta(edge.v1.point)
            full = float(np.linalg.norm(edge.v0.point - edge.v1.point)) < 1e-9
            if sense > 0:
                s = t0
                e = t0 + TWO_PI if full else t0 + ((t1 - t0) % TWO_PI or TWO_PI)
            else:
                s = t1
                e = t1 + TWO_PI if full else t1 + ((t0 - t1) % TWO_PI or TWO_PI)
            pieces.append(_Piece(edge, s, e, sense, 0))
        return pieces

    def _split_piece(self, p: _Piece, inner: List[float]) -> List[_Piece]:
        """Split one boundary arc at interior angles (the _FaceSplitter
        logic, on the cap boundary circle instead of an axial station)."""
        if not inner:
            return [p]
        bounds = [p.s] + inner + [p.e]
        verts = []
        for i, theta in enumerate(bounds):
            if i == 0:
                verts.append(p.edge.v0 if p.sense > 0 else p.edge.v1)
            elif i == len(bounds) - 1:
                verts.append(p.edge.v1 if p.sense > 0 else p.edge.v0)
            else:
                verts.append(self.reg.vertex_near(self._point_at(theta)))
        subs_ccw: List[_Piece] = []
        w = self.cap.w
        for i in range(len(bounds) - 1):
            s, e = bounds[i], bounds[i + 1]
            curve = BCurve(
                "circle",
                frame=Frame(self.cap.O_b.copy(), w if p.sense > 0 else -w,
                            self.bx),
                radius=self.cap.rho)
            if p.sense > 0:
                edge = BEdge(verts[i], verts[i + 1], curve, arc_span=(s, e))
            else:
                edge = BEdge(verts[i + 1], verts[i], curve, arc_span=(-e, -s))
            subs_ccw.append(_Piece(edge, s, e, p.sense, 0))
        natural = subs_ccw if p.sense > 0 else subs_ccw[::-1]
        self.reg.substitute(p.edge, [q.edge for q in natural])
        return subs_ccw

    # -- splitting -----------------------------------------------------------

    def split(self) -> Optional[List[BFace]]:
        clip = lambda x: float(np.clip(x, -1.0, 1.0))  # noqa: E731
        a_b = float(np.arccos(clip(self.cap.h / self.R)))
        a_s = float(np.arccos(clip(self.g / self.R)))
        beta = float(np.arccos(clip(self.cap.w @ self.u)))
        m = self._MARGIN
        if beta >= a_b + a_s - m:
            return None  # silhouette misses the cap (or external tangency)
        if beta + a_b <= a_s + m:
            return None  # whole cap on the near side of the silhouette
        if beta + a_s <= a_b - m:
            return self._band_split()
        if beta + a_s <= a_b + m:
            return None  # internal tangency: grazing
        return self._crossing_split()

    def _silhouette_frame(self) -> Tuple[np.ndarray, float]:
        O_s = self.C + self.g * self.u
        rho_s = float(np.sqrt(max(self.R ** 2 - self.g ** 2, 0.0)))
        return O_s, rho_s

    def _band_split(self) -> List[BFace]:
        """Silhouette circle interior to the cap: inner sub-cap + band."""
        O_s, rho_s = self._silhouette_frame()
        seed = np.array([1.0, 0.0, 0.0])
        if abs(float(seed @ self.u)) > 0.9:
            seed = np.array([0.0, 1.0, 0.0])
        sx = _unit(seed - self.u * float(seed @ self.u))
        start = O_s + rho_s * sx
        v = self.reg.vertex_near(start)
        silh = BEdge(v, v, BCurve("circle", frame=Frame(O_s, self.u, sx),
                                  radius=rho_s), arc_span=(0.0, TWO_PI))
        f = self.face
        inner = BFace(SPHERE, f.frame, f.radius, f.semi_angle, f.same_sense,
                      [[(silh, 0)]], fid=f.fid)
        band = BFace(SPHERE, f.frame, f.radius, f.semi_angle, f.same_sense,
                     [list(self.loop), [(silh, 1)]], fid=f.fid)
        return [inner, band]

    def _crossing_split(self) -> Optional[List[BFace]]:
        w, u, h, g = self.cap.w, self.u, self.cap.h, self.g
        cosb = float(w @ u)
        sin2 = max(1.0 - cosb * cosb, 1e-12)
        a = (h - g * cosb) / sin2
        b = (g - h * cosb) / sin2
        mid = a * w + b * u
        c2 = self.R ** 2 - float(mid @ mid)
        if c2 <= (10.0 * self.tol) ** 2:
            return None  # numerically tangent
        axis = _unit(np.cross(w, u))
        c = float(np.sqrt(c2))
        p_plus, p_minus = self.C + mid + c * axis, self.C + mid - c * axis

        pieces = self._classify_pieces()
        lo = pieces[0].s
        cut_angles = sorted({round(_wrap(self._theta(p), lo), 9)
                             for p in (p_plus, p_minus)})
        split_pieces: List[_Piece] = []
        for p in pieces:
            inner = [c_ for base in cut_angles
                     for c_ in (_wrap(base, p.s),)
                     if p.s + 1e-6 < c_ < p.e - 1e-6]
            split_pieces.extend(self._split_piece(p, sorted(inner)))

        # the re-expanded walk orders the final sub-arcs with their loop
        # orientations; the two silhouette crossings partition it into a
        # contiguous near-side (toward the camera) and far-side run
        walk = self.reg.expand(self.loop)

        def near(item) -> bool:
            edge = item[0]
            piece = next((q for q in split_pieces if q.edge is edge), None)
            if piece is not None:
                m = self._point_at((piece.s + piece.e) / 2.0)
            else:
                m = midpoint_of(edge)
            return float((m - self.C) @ u) > g

        flags = [near(it) for it in walk]
        if all(flags) or not any(flags):
            raise UnsupportedStep("silhouette crossing did not bisect the "
                                  "sphere boundary walk")
        start = next(i for i in range(len(walk))
                     if flags[i] and not flags[i - 1])
        walk = walk[start:] + walk[:start]
        flags = flags[start:] + flags[:start]
        n_near = flags.index(False)
        near_run, far_run = walk[:n_near], walk[n_near:]

        # silhouette arc inside the cap, between the crossing vertices
        O_s, _ = self._silhouette_frame()
        sx = _unit(p_plus - O_s)
        sy = np.cross(u, sx)
        rho_s = float(np.linalg.norm(p_plus - O_s))
        q = p_minus - O_s
        phi = float(np.arctan2(q @ sy, q @ sx)) % TWO_PI or TWO_PI
        v_plus = self.reg.vertex_near(p_plus)
        v_minus = self.reg.vertex_near(p_minus)
        curve = BCurve("circle", frame=Frame(O_s, u, sx), radius=rho_s)

        def arc_mid(t0: float, t1: float) -> np.ndarray:
            t = (t0 + t1) / 2.0
            return O_s + rho_s * (np.cos(t) * sx + np.sin(t) * sy)

        if float((arc_mid(0.0, phi) - self.C) @ w) > h:
            silh = BEdge(v_plus, v_minus, curve, arc_span=(0.0, phi))
        else:
            silh = BEdge(v_minus, v_plus, curve, arc_span=(phi, TWO_PI))

        f = self.face
        out = []
        for run in (near_run, far_run):
            last_edge, last_o = run[-1]
            end_v = last_edge.v1 if last_o == 0 else last_edge.v0
            orient = 0 if end_v is silh.v0 else 1
            out.append(BFace(SPHERE, f.frame, f.radius, f.semi_angle,
                             f.same_sense, [run + [(silh, orient)]],
                             fid=f.fid))
        return out


# ---------------------------------------------------------------------------
# toroidal faces: band classification + silhouette-curve splitting
# ---------------------------------------------------------------------------
#
# A torus point is P(u, v) = C + (R + r cos v) e_r(u) + r sin v Z with
# e_r(u) = cos u X + sin u Y; the outward normal is N = cos v e_r + sin v Z.
# The HLR silhouette condition N . (P - E) = 0 (perspective, eye E) or
# N . d = 0 (orthographic) reduces to
#
#     a(u) cos v + b sin v = c,   a(u) = alpha cos u + beta sin u + gamma
#
# (orthographic: alpha,beta = d.X, d.Y, gamma = 0, b = d.Z, c = 0;
# perspective with k = C - E: alpha,beta = k.X, k.Y, gamma = R, b = k.Z,
# c = -r). For fixed u this is the same one-harmonic equation the
# cylinder/cone/sphere silhouettes solve, so every derived event — where
# the silhouette meets a boundary circle (v = const) or the u-seam
# (u = const) — is analytic via _solve_silhouette. Between events the
# silhouette branches are graphs v(u), sampled into polyline edges (OCC's
# HLR also hands torus outlines over as discretized curves; reference
# TopoMapper.py:38-43). Faces are the regions of the band's (u, v)
# rectangle cut by those curves, recovered by half-edge tracing.


@dataclass
class _TracePiece:
    """One undirected subdivision edge in band coordinates: ``uw`` is the
    (u, w) polyline in the BEdge's natural direction with u unwrapped
    (consecutive deltas small), w = v - v_bot in [0, H]."""

    edge: BEdge
    uw: np.ndarray

    @property
    def du(self) -> float:
        return float(self.uw[-1, 0] - self.uw[0, 0])


class _BandTracer:
    """Face tracing over a subdivision of the (u, w) band annulus.

    Directed half-edges are (piece, dir); at each head vertex the next
    half-edge is the first outgoing direction reached rotating CLOCKWISE
    from the reversed arrival direction, which traverses every region
    boundary with the interior on the LEFT (counterclockwise cycles for
    disc regions; wrapping cycles carry their side in the sign of the
    total u advance)."""

    def __init__(self, pieces: List[_TracePiece]):
        self.pieces = pieces
        self.out: Dict[int, List[Tuple[_TracePiece, int]]] = {}
        for p in pieces:
            self.out.setdefault(id(p.edge.v0), []).append((p, +1))
            self.out.setdefault(id(p.edge.v1), []).append((p, -1))

    @staticmethod
    def _tail(half) -> int:
        p, d = half
        return id(p.edge.v0 if d > 0 else p.edge.v1)

    @staticmethod
    def _head(half) -> int:
        p, d = half
        return id(p.edge.v1 if d > 0 else p.edge.v0)

    @staticmethod
    def _angle_out(half) -> float:
        p, d = half
        step = (p.uw[1] - p.uw[0]) if d > 0 else (p.uw[-2] - p.uw[-1])
        return float(np.arctan2(step[1], step[0]))

    @staticmethod
    def _angle_in(half) -> float:
        p, d = half
        step = (p.uw[-1] - p.uw[-2]) if d > 0 else (p.uw[0] - p.uw[1])
        return float(np.arctan2(step[1], step[0]))

    def _next(self, half):
        rev = self._angle_in(half) + np.pi
        best, best_delta = None, None
        for cand in self.out[self._head(half)]:
            delta = float((rev - self._angle_out(cand)) % TWO_PI)
            if cand[0] is half[0] and cand[1] == -half[1]:
                # this piece's own reverse: last resort (spur bounce). A
                # closed silhouette wrap re-meets its start vertex where
                # the reverse differs from continuing by only the local
                # curve turning, whose sign must not decide the trace.
                delta = TWO_PI
            elif delta < 1e-12:
                delta = TWO_PI
            if best is None or delta < best_delta:
                best, best_delta = cand, delta
        if best is None:
            raise UnsupportedStep("dangling torus subdivision vertex")
        return best

    def cycles(self) -> List[List[Tuple[_TracePiece, int]]]:
        used = set()
        out: List[List[Tuple[_TracePiece, int]]] = []
        for p in self.pieces:
            for d in (+1, -1):
                if (id(p), d) in used:
                    continue
                cycle, half = [], (p, d)
                while (id(half[0]), half[1]) not in used:
                    used.add((id(half[0]), half[1]))
                    cycle.append(half)
                    half = self._next(half)
                if half != (p, d):
                    raise UnsupportedStep("torus face trace did not close")
                out.append(cycle)
        return out


def _cycle_du(cycle) -> float:
    return sum(d * p.du for p, d in cycle)


def _cycle_uw(cycle) -> np.ndarray:
    """Concatenated (u, w) polyline of a cycle, u unwrapped across pieces."""
    runs, base = [], None
    for p, d in cycle:
        uw = p.uw if d > 0 else p.uw[::-1]
        if base is None:
            base = 0.0
        else:
            base = runs[-1][-1, 0] - uw[0, 0]
        runs.append(uw + np.array([base, 0.0]))
    return np.concatenate(runs)


class _TorusSplitter:
    """Split one full-revolution toroidal band face along its silhouette.

    The supported boundary shape is the one a revolved tube actually has
    (and the writer's brep_torus / brep_round_top_cylinder emit): full
    ring circles at exactly two tube-angle stations plus one tube-arc seam
    at u = u_s used twice in the wire. Configurations the analytic sweep
    cannot certify (silhouette islands from a near camera, grazing
    tangencies, partial-revolution bands) raise UnsupportedStep, routing
    the shape to the OCC backend rather than emitting wrong topology."""

    _EPS = 1e-3

    def __init__(self, face: BFace, projector: NativeProjector, tol: float,
                 registry: "_SplitRegistry"):
        self.face, self.tol, self.reg = face, tol, registry
        if len(face.loops) != 1:
            raise UnsupportedStep("multi-loop torus faces need the OCC backend")
        self.loop = registry.expand(face.loops[0])
        f = face.frame
        self.C, self.R, self.r = f.origin, face.radius, face.radius2
        self.X, self.Y, self.Z = f.x, f.y, f.z
        if not 0.0 < self.r < self.R:
            raise UnsupportedStep("only ring tori are supported natively")
        if projector.eye is None:
            d = projector.n
            self.alpha, self.beta, self.gamma = float(d @ self.X), float(d @ self.Y), 0.0
            self.b, self.c = float(d @ self.Z), 0.0
        else:
            k = self.C - projector.eye
            self.alpha, self.beta = float(k @ self.X), float(k @ self.Y)
            self.gamma, self.b, self.c = self.R, float(k @ self.Z), -self.r

    # -- torus-frame helpers -------------------------------------------------

    def _point_at(self, u: float, v: float) -> np.ndarray:
        er = np.cos(u) * self.X + np.sin(u) * self.Y
        return (self.C + (self.R + self.r * np.cos(v)) * er
                + self.r * np.sin(v) * self.Z)

    def _theta(self, p: np.ndarray) -> float:
        q = p - self.C
        return float(np.arctan2(q @ self.Y, q @ self.X))

    def _v_of(self, p: np.ndarray) -> float:
        q = p - self.C
        zc = float(q @ self.Z)
        rad = float(np.linalg.norm(q - zc * self.Z))
        return float(np.arctan2(zc / self.r, (rad - self.R) / self.r))

    def _w_of(self, v: float) -> float:
        return float((v - self.v_bot) % TWO_PI)

    def _a(self, u: float) -> float:
        return self.alpha * np.cos(u) + self.beta * np.sin(u) + self.gamma

    def _F(self, u: float, v: float) -> float:
        return float(self._a(u) * np.cos(v) + self.b * np.sin(v) - self.c)

    def _v_solutions(self, u: float) -> List[float]:
        a = self._a(u)
        amp = float(np.hypot(a, self.b))
        if amp < 1e-12 or amp < abs(self.c):
            return []
        phi = float(np.arctan2(self.b, a))
        delta = float(np.arccos(np.clip(self.c / amp, -1.0, 1.0)))
        return [phi + delta, phi - delta]

    def _v_continue(self, u: float, v_prev: float) -> float:
        sols = self._v_solutions(u)
        if not sols:
            raise UnsupportedStep("torus silhouette branch vanished mid-trace")
        dist = [abs((s - v_prev + np.pi) % TWO_PI - np.pi) for s in sols]
        return sols[int(np.argmin(dist))]

    # -- boundary classification ----------------------------------------------

    def _classify(self):
        counts: Dict[int, int] = {}
        order: List[BEdge] = []
        for edge, _ in self.loop:
            counts[id(edge)] = counts.get(id(edge), 0) + 1
            if counts[id(edge)] == 1:
                order.append(edge)
        ring: List[Tuple[float, BEdge]] = []
        seam: Optional[BEdge] = None
        for edge in order:
            if edge.curve.kind != "circle":
                raise UnsupportedStep("torus band bounded by a non-circle edge")
            cf = edge.curve.frame
            off = cf.origin - self.C
            axial = float(off @ self.Z)
            radial = float(np.linalg.norm(off - axial * self.Z))
            if radial < 1e-6 and abs(abs(float(cf.z @ self.Z)) - 1.0) < 1e-6:
                sinv, cosv = axial / self.r, (edge.curve.radius - self.R) / self.r
                if abs(sinv * sinv + cosv * cosv - 1.0) > 1e-4:
                    raise UnsupportedStep("ring circle is not on the torus")
                if counts[id(edge)] != 1:
                    raise UnsupportedStep("doubly-used torus ring circle")
                ring.append((float(np.arctan2(sinv, cosv)), edge))
            elif (abs(axial) < 1e-6 and abs(radial - self.R) < 1e-6
                    and abs(edge.curve.radius - self.r) < 1e-6
                    and counts[id(edge)] == 2):
                if seam is not None:
                    raise UnsupportedStep("torus band with multiple seams")
                seam = edge
            else:
                raise UnsupportedStep("unrecognized torus boundary circle")
        if seam is None:
            raise UnsupportedStep("torus band without a tube seam")
        self.seam = seam
        self.u_s = self._theta(midpoint_of(seam))

        # band interval from the seam arc (it spans exactly the face's v's)
        va, vb = self._v_of(seam.v0.point), self._v_of(seam.v1.point)
        vm = self._v_of(midpoint_of(seam))
        H = (vb - va) % TWO_PI or TWO_PI
        if (vm - va) % TWO_PI <= H:
            self.v_bot, self.H = va, H
        else:
            self.v_bot, self.H = vb, (va - vb) % TWO_PI or TWO_PI
        self.v_top = self.v_bot + self.H
        if self.H >= TWO_PI - 1e-6:
            raise UnsupportedStep("degenerate full-tube torus band")

        # group ring pieces into the two stations
        self.station_pieces: Dict[int, List[BEdge]] = {0: [], 1: []}
        for v_st, edge in ring:
            w = self._w_of(v_st)
            if min(w, TWO_PI - w) < 1e-5:
                self.station_pieces[0].append(edge)
            elif abs(w - self.H) < 1e-5:
                self.station_pieces[1].append(edge)
            else:
                raise UnsupportedStep("torus ring circle off the band stations")
        for st in (0, 1):
            if not self.station_pieces[st]:
                raise UnsupportedStep("torus band is missing a station circle")
            total = 0.0
            for edge in self.station_pieces[st]:
                t0, t1 = ensure_arc_span(edge)
                total += t1 - t0
            if abs(total - TWO_PI) > 1e-5:
                raise UnsupportedStep("partial-revolution torus bands need "
                                      "the OCC backend")

        # the lower station must run CCW (+u) in the wire: the (u, v)
        # parametrization is right-handed w.r.t. the outward normal, so a
        # same-sense outer wire is CCW in (u, v) (STEP FACE_OUTER_BOUND)
        for edge, orient in self.loop:
            if edge in self.station_pieces[0]:
                sense = 1 if float(edge.curve.frame.z @ self.Z) > 0 else -1
                if sense * (1 if orient == 0 else -1) != 1:
                    raise UnsupportedStep("unexpected torus band orientation")
                break

    # -- events ---------------------------------------------------------------

    def _station_crossings(self, v_st: float) -> List[float]:
        cv, sv = float(np.cos(v_st)), float(np.sin(v_st))
        return [float(u % TWO_PI) for u in _solve_silhouette(
            cv * self.alpha, cv * self.beta,
            self.c - sv * self.b - cv * self.gamma)]

    def _guard_islands(self) -> bool:
        """True if silhouette branches exist for every u (no islands). When
        they do not, require the partial branches to stay out of the band
        (else raise); returns False meaning 'nothing to split'."""
        ra = float(np.hypot(self.alpha, self.beta))
        lo, hi = self.gamma - ra, self.gamma + ra
        min_abs_a = 0.0 if lo <= 0.0 <= hi else min(abs(lo), abs(hi))
        min_amp = float(np.hypot(min_abs_a, self.b))
        if min_amp > abs(self.c) + self._EPS:
            return True
        for u in np.linspace(0.0, TWO_PI, 512, endpoint=False):
            for v in self._v_solutions(float(u)):
                w = self._w_of(v)
                if self._EPS < w < self.H - self._EPS:
                    raise UnsupportedStep(
                        "torus silhouette islands (camera too close); "
                        "use the OCC backend")
        return False

    # -- silhouette tracing -----------------------------------------------------

    def _crossing_side(self, u_e: float, v_st: float) -> int:
        """+1 if the in-band silhouette leaves the crossing toward +u."""
        sides = []
        for sgn in (+1, -1):
            v = self._v_continue(u_e + sgn * self._EPS, v_st)
            w = self._w_of(v)
            if min(w, abs(w - TWO_PI)) > 1e-9 and w < self.H:
                sides.append(sgn)
        if len(sides) != 1:
            raise UnsupportedStep("tangential torus silhouette crossing")
        return sides[0]

    def _refine(self, pts: List[Tuple[float, float]], depth: int = 0):
        """Chordal-deflection refinement of a (u, v) sample pair list."""
        (u0, v0), (u1, v1) = pts
        if depth >= 7:
            return [pts[0]]
        um = (u0 + u1) / 2.0
        vm = self._v_continue(um, (v0 + v1) / 2.0)
        p0, p1, pm = (self._point_at(u0, v0), self._point_at(u1, v1),
                      self._point_at(um, vm))
        chord = p1 - p0
        t = float(np.clip((pm - p0) @ chord / max(chord @ chord, 1e-18), 0, 1))
        if float(np.linalg.norm(pm - (p0 + t * chord))) <= self.tol:
            return [pts[0]]
        return (self._refine([(u0, v0), (um, vm)], depth + 1)
                + self._refine([(um, vm), (u1, v1)], depth + 1))

    def _trace_piece(self, vertex_key: int, direction: int):
        """Follow the in-band silhouette from a vertex until the next
        vertex; returns (samples, end_vertex_key). Samples are (u, v) with
        u unwrapped (monotone in ``direction``)."""
        u0, v0 = self.v_coords[vertex_key]
        cuts = sorted(self.cut_us)
        samples = [(u0, v0)]
        u, v = u0, v0
        traveled = 0.0
        while traveled < TWO_PI + 1e-6:
            # next cut-u strictly ahead in ``direction``
            if direction > 0:
                ahead = [cu for cu in cuts if cu > (u % TWO_PI) + 1e-9]
                nxt = (ahead[0] if ahead else cuts[0] + TWO_PI)
                du_next = nxt - (u % TWO_PI)
            else:
                behind = [cu for cu in cuts if cu < (u % TWO_PI) - 1e-9]
                nxt = (behind[-1] if behind else cuts[-1] - TWO_PI)
                du_next = (u % TWO_PI) - nxt
            steps = max(1, int(np.ceil(du_next / (TWO_PI / 256))))
            for i in range(1, steps + 1):
                un = u + direction * du_next * i / steps
                v = self._v_continue(un, v)
                samples.append((un, v))
            u = u + direction * du_next
            traveled += du_next
            # does a subdivision vertex sit on this curve at this cut-u?
            for key, (uk, vk) in self.v_coords.items():
                if abs((uk - u + np.pi) % TWO_PI - np.pi) > 1e-7:
                    continue
                if abs((vk - v + np.pi) % TWO_PI - np.pi) < 1e-4:
                    samples[-1] = (u, vk + round((v - vk) / TWO_PI) * TWO_PI)
                    return samples, key
        raise UnsupportedStep("unterminated torus silhouette trace")

    # -- arc subdivision ---------------------------------------------------------

    def _subdivide_circle(self, edge: BEdge, cut_points: List[np.ndarray]
                          ) -> List[BEdge]:
        """Split a circle edge at interior 3D points (shared-curve sub-arcs
        with explicit spans), registering the substitution."""
        t0, t1 = ensure_arc_span(edge)
        fr = edge.curve.frame

        def t_of(p: np.ndarray) -> float:
            q = p - fr.origin
            t = float(np.arctan2(q @ fr.y, q @ fr.x))
            return t0 + float((t - t0) % TWO_PI)

        inner = sorted(t for t in (t_of(p) for p in cut_points)
                       if t0 + 1e-6 < t < t1 - 1e-6)
        if not inner:
            return [edge]
        bounds = [t0] + inner + [t1]
        verts = [edge.v0]
        for t in inner:
            p = (fr.origin + edge.curve.radius
                 * (np.cos(t) * fr.x + np.sin(t) * fr.y))
            verts.append(self.reg.vertex_near(p))
        verts.append(edge.v1)
        subs = [BEdge(verts[i], verts[i + 1], edge.curve,
                      arc_span=(bounds[i], bounds[i + 1]))
                for i in range(len(bounds) - 1)]
        self.reg.substitute(edge, subs)
        return subs

    def _subdivide_seam(self, seam_vs: List[float]) -> List[BEdge]:
        return self._subdivide_circle(
            self.seam, [self._point_at(self.u_s, v) for v in seam_vs])

    def _station_trace_piece(self, edge: BEdge, w: float) -> _TracePiece:
        sense = 1 if float(edge.curve.frame.z @ self.Z) > 0 else -1
        u0 = self._theta(edge.v0.point)
        t0, t1 = ensure_arc_span(edge)
        du = sense * (t1 - t0)
        return _TracePiece(edge, np.array([[u0, w], [u0 + du, w]]))

    # -- the split --------------------------------------------------------------

    def split(self) -> Optional[List[BFace]]:
        self._classify()
        total_branches = self._guard_islands()
        xb = self._station_crossings(self.v_bot)
        xt = self._station_crossings(self.v_top)
        if not total_branches:
            if xb or xt:
                raise UnsupportedStep("inconsistent torus silhouette events")
            return None

        # silhouette values at the seam (interior of the band only)
        seam_vs = []
        for v in self._v_solutions(self.u_s):
            w = self._w_of(v)
            if self._EPS < w < self.H - self._EPS:
                seam_vs.append(self.v_bot + w)
        if not (xb or xt or seam_vs):
            return None  # silhouette never enters the band

        # ---- subdivision vertices: key -> BVertex, with (u, v) coords
        self.v_coords: Dict[int, Tuple[float, float]] = {}
        vertices: Dict[int, BVertex] = {}
        ends: List[Tuple[int, int]] = []  # (vertex key, trace direction)

        def add_vertex(u: float, v: float) -> int:
            vert = self.reg.vertex_near(self._point_at(u, v))
            if id(vert) not in self.v_coords:
                self.v_coords[id(vert)] = (u % TWO_PI, v)
                vertices[id(vert)] = vert
            return id(vert)

        crossings = ([(u, self.v_bot) for u in xb]
                     + [(u, self.v_top) for u in xt])
        for (u1, _), (u2, _) in zip(crossings, crossings[1:]):
            if abs((u1 - u2 + np.pi) % TWO_PI - np.pi) < self._EPS:
                raise UnsupportedStep("torus silhouette sliver; use OCC")
        for u_e, v_st in crossings:
            key = add_vertex(u_e, v_st)
            ends.append((key, self._crossing_side(u_e, v_st)))
        for v in seam_vs:
            key = add_vertex(self.u_s, v)
            ends.append((key, +1))
            ends.append((key, -1))
        self.cut_us = sorted({(u % TWO_PI) for u, _ in crossings}
                             | {self.u_s % TWO_PI})

        # ---- trace silhouette pieces between vertices
        silhouette_pieces: List[_TracePiece] = []
        open_ends = set(ends)
        if len(open_ends) != len(ends):
            raise UnsupportedStep("coincident torus silhouette events")
        while open_ends:
            # the first open end in event order, not the set's (address-
            # dependent) order: a trace run from its other end samples
            # other points, so the set's order made the output vary
            key, direction = next(e for e in ends if e in open_ends)
            open_ends.discard((key, direction))
            samples, end_key = self._trace_piece(key, direction)
            arrival = (end_key, -direction)
            if arrival not in open_ends:
                raise UnsupportedStep("torus silhouette trace mismatch")
            open_ends.discard(arrival)
            # refine to chordal tol and build the polyline edge
            refined: List[Tuple[float, float]] = []
            for pair in zip(samples, samples[1:]):
                refined.extend(self._refine(list(pair)))
            refined.append(samples[-1])
            pts = np.stack([self._point_at(u, v) for u, v in refined])
            v0, v1 = vertices[key], vertices[end_key]
            if direction < 0:  # store polylines in +u natural direction
                refined, pts = refined[::-1], pts[::-1]
                v0, v1 = v1, v0
            pts[0], pts[-1] = v0.point, v1.point
            bedge = BEdge(v0, v1, BCurve("poly", points=pts))
            uw = np.array([[u, self._w_of(v) if i not in (0, len(refined) - 1)
                            else float(np.clip(self._w_of(v), 0.0, self.H))]
                           for i, (u, v) in enumerate(refined)])
            # unwrap w against jitter at the band edges, clamp into [0, H]
            uw[:, 1] = np.clip(np.where(uw[:, 1] > self.H + np.pi,
                                        uw[:, 1] - TWO_PI, uw[:, 1]),
                               0.0, self.H)
            silhouette_pieces.append(_TracePiece(bedge, uw))

        # ---- subdivide the station circles at the crossing u's
        trace_pieces: List[_TracePiece] = list(silhouette_pieces)
        for st, xs, v_st, w in ((0, xb, self.v_bot, 0.0),
                                (1, xt, self.v_top, self.H)):
            cut_pts = [self._point_at(u, v_st) for u in xs]
            for edge in self.station_pieces[st]:
                existing = [self._theta(edge.v0.point),
                            self._theta(edge.v1.point)]
                pts = [p for u, p in zip(xs, cut_pts)
                       if all(abs((u - e + np.pi) % TWO_PI - np.pi) > 1e-4
                              for e in existing)]
                for sub in self._subdivide_circle(edge, pts):
                    trace_pieces.append(self._station_trace_piece(sub, w))

        # ---- subdivide the seam at its silhouette crossings
        seam_subs = self._subdivide_seam(seam_vs)

        # ---- trace regions
        cycles = _BandTracer(trace_pieces).cycles()
        return self._assemble(cycles, seam_subs)

    # -- region assembly ----------------------------------------------------------

    def _region_sign(self, cycle) -> float:
        """Sign of F on the region's interior (sampled just left of a
        boundary piece midpoint)."""
        for p, d in cycle:
            uw = p.uw if d > 0 else p.uw[::-1]
            i = len(uw) // 2 if len(uw) > 2 else 0
            seg = uw[i + 1] - uw[i]
            n = float(np.hypot(seg[0], seg[1]))
            if n < 1e-12:
                continue
            left = np.array([-seg[1], seg[0]]) / n
            mid = (uw[i] + uw[i + 1]) / 2.0 + self._EPS * 0.3 * left
            sign = self._F(float(mid[0]), self.v_bot + float(mid[1]))
            if abs(sign) > 1e-9:
                return float(np.sign(sign))
        raise UnsupportedStep("could not sign a torus region")

    def _emit(self, walk: List[Tuple[BEdge, int]]) -> BFace:
        f = self.face
        return BFace(TORUS, f.frame, f.radius, f.semi_angle, f.same_sense,
                     [walk], fid=f.fid, radius2=f.radius2)

    @staticmethod
    def _cycle_walk(cycle) -> List[Tuple[BEdge, int]]:
        return [(p.edge, 0 if d > 0 else 1) for p, d in cycle]

    @staticmethod
    def _rotate_to(cycle, vertex_key: int):
        for i, half in enumerate(cycle):
            if _BandTracer._tail(half) == vertex_key:
                return cycle[i:] + cycle[:i]
        return None

    def _assemble(self, cycles, seam_subs) -> List[BFace]:
        wrapping, discs = [], []
        for cycle in cycles:
            du = _cycle_du(cycle)
            if abs(du) < np.pi:
                uw = _cycle_uw(cycle)
                area = float((uw[:-1, 0] * uw[1:, 1]
                              - uw[:-1, 1] * uw[1:, 0]).sum()) / 2.0
                if area <= 0:
                    raise UnsupportedStep(
                        "clockwise contractible torus cycle (island?)")
                discs.append(cycle)
            elif abs(abs(du) - TWO_PI) < 1e-3:
                wrapping.append(cycle)
            else:
                raise UnsupportedStep("torus cycle wraps more than once")

        # wrapping cycles sort by mean w; the lowest (the outside of the
        # bottom station) and highest are dropped, interior ones pair into
        # annular regions (lower boundary +u, upper boundary -u)
        def mean_w(cycle) -> float:
            uw = _cycle_uw(cycle)
            seg = np.abs(np.diff(uw[:, 0]))
            mids = (uw[:-1, 1] + uw[1:, 1]) / 2.0
            tot = float(seg.sum())
            return float((seg * mids).sum() / tot) if tot > 1e-9 else float(
                uw[:, 1].mean())

        # quantize the w key: a cycle and its reverse differ in float
        # summation order only, and the du tiebreak must decide between them
        wrapping.sort(key=lambda c: (round(mean_w(c), 6), _cycle_du(c)))
        if len(wrapping) % 2 or len(wrapping) < 2:
            raise UnsupportedStep("unpaired wrapping torus cycles")
        for i, cycle in enumerate(wrapping):
            if (_cycle_du(cycle) > 0) != (i % 2 == 1):
                raise UnsupportedStep("torus wrapping cycles out of order")
        annuli = [(wrapping[i], wrapping[i + 1])
                  for i in range(1, len(wrapping) - 1, 2)]

        # seam sub-arcs attach to the region whose boundary holds both of
        # their endpoints (annuli: one per region; discs: doubly-used spur)
        faces: List[BFace] = []
        seam_used = [False] * len(seam_subs)

        def seam_for(vertex_keys, sign=None):
            for i, sub in enumerate(seam_subs):
                if seam_used[i]:
                    continue
                if (id(sub.v0) in vertex_keys and id(sub.v1) in vertex_keys
                        and (sign is None
                             or self._F(self.u_s,
                                        self._v_of(midpoint_of(sub))) * sign
                             > 0)):
                    seam_used[i] = True
                    return sub
            return None

        for lower, upper in annuli:
            keys_lo = {self._tailkey(h) for h in lower}
            keys_up = {self._tailkey(h) for h in upper}
            sub = None
            for i, cand in enumerate(seam_subs):
                if seam_used[i]:
                    continue
                if ((id(cand.v0) in keys_lo and id(cand.v1) in keys_up)
                        or (id(cand.v1) in keys_lo and id(cand.v0) in keys_up)):
                    seam_used[i] = True
                    sub = cand
                    break
            if sub is None:
                raise UnsupportedStep("torus annulus region without a seam")
            lo_key = id(sub.v0) if id(sub.v0) in keys_lo else id(sub.v1)
            up_key = id(sub.v1) if lo_key == id(sub.v0) else id(sub.v0)
            lo_cycle = self._rotate_to(lower, lo_key)
            up_cycle = self._rotate_to(upper, up_key)
            if lo_cycle is None or up_cycle is None:
                raise UnsupportedStep("torus seam endpoints off their cycles")
            walk = (self._cycle_walk(lo_cycle)
                    + [(sub, 0 if id(sub.v0) == lo_key else 1)]
                    + self._cycle_walk(up_cycle)
                    + [(sub, 1 if id(sub.v0) == lo_key else 0)])
            faces.append(self._emit(walk))

        for cycle in discs:
            keys = {self._tailkey(h) for h in cycle}
            # a winding silhouette can cross the seam meridian several
            # times, leaving a region's seam intersection DISCONNECTED —
            # claim every sign-matching spur, each inserted as a doubly-
            # used wire excursion at its own boundary vertex
            sign = self._region_sign(cycle)
            spurs: List[BEdge] = []
            while True:
                sub = seam_for(keys, sign=sign)
                if sub is None:
                    break
                spurs.append(sub)
            if spurs:
                by_v0: Dict[int, List[BEdge]] = {}
                for sub in spurs:
                    by_v0.setdefault(id(sub.v0), []).append(sub)
                walk = []
                for half in cycle:
                    for sub in by_v0.pop(self._tailkey(half), []):
                        walk.extend([(sub, 0), (sub, 1)])
                    walk.extend(self._cycle_walk([half]))
                if by_v0:
                    raise UnsupportedStep("unattachable seam spur")
            else:
                walk = self._cycle_walk(cycle)
            faces.append(self._emit(walk))

        if not all(seam_used):
            raise UnsupportedStep("unassigned torus seam piece")
        return faces

    @staticmethod
    def _tailkey(half) -> int:
        return _BandTracer._tail(half)


class _RevolutionSplitter(_TorusSplitter):
    """Split one full-revolution freeform band (SURFACE_OF_REVOLUTION over
    a B-spline meridian profile) along its silhouette.

    P(u, s) = C + rho(s) e_r(u) + z(s) Zax, with (rho, z) the profile's
    meridian coordinates. The unnormalized normal is
    N = z'(s) e_r(u) - rho'(s) Zax, so the HLR outline condition
    N . (P - E) = 0 is ONE-HARMONIC in the revolution angle per station:

        g(u, s) = A(s) cos u + B(s) sin u + D(s)
        A = z' k_x,   B = z' k_y,
        D = z' rho - rho' (k_z + z)     (perspective, k = C - E)
        D = -rho' k_z                   (orthographic, k = view direction)

    Silhouette branches are the analytic graphs u(s) = phi(s) +- delta(s)
    over the feasible intervals amp(s) >= |D(s)| — they never wrap in u
    (phi is constant up to pi flips inside infeasible gaps), so the tracer
    sweeps s between event vertices on the stations and the seam, flipping
    sweep direction and branch sign at tangencies (amp = |D|). Region
    assembly (half-edge cycle tracing, annulus pairing, seam attachment)
    is inherited from the torus band machinery — the (u, w) band topology
    is identical. Islands (feasible intervals whose loops touch neither a
    station nor the seam), grazing tangencies, and partial-revolution
    bands raise UnsupportedStep toward the OCC backend.

    Reference: OCC HLR outlines on GeomAbs_SurfaceOfRevolution faces,
    TopoMapper.py:38-83; face type 7 clamps to the Other label
    (Face.py:18-24, data_para.py:76-80)."""

    def __init__(self, face: BFace, projector: NativeProjector, tol: float,
                 registry: "_SplitRegistry"):
        self.face, self.tol, self.reg = face, tol, registry
        if len(face.loops) != 1:
            raise UnsupportedStep(
                "multi-loop revolution faces need the OCC backend")
        self.loop = registry.expand(face.loops[0])
        f = face.frame
        self.C, self.X, self.Y, self.Z = f.origin, f.x, f.y, f.z
        self.prof = face.profile
        self.phodo = bspline_hodograph(self.prof)
        self.s_lo, self.s_hi = bspline_domain(self.prof)
        if projector.eye is None:
            k = projector.n
            self.persp = False
        else:
            k = self.C - projector.eye
            self.persp = True
        self.kx = float(k @ self.X)
        self.ky = float(k @ self.Y)
        self.kz = float(k @ self.Z)
        # dense station grid: knot lines + 64 samples per span
        spans = sorted({float(t) for t in self.prof.knots
                        if self.s_lo <= t <= self.s_hi})
        self._sgrid = np.unique(np.concatenate(
            [np.linspace(a, b, 65) for a, b in zip(spans, spans[1:])]))
        self._eps_s = 1e-6 * (self.s_hi - self.s_lo)

    # -- profile geometry ------------------------------------------------------

    def _rz(self, ss) -> Tuple[np.ndarray, np.ndarray]:
        p = bspline_eval(self.prof, ss) - self.C
        return p @ self.X, p @ self.Z

    def _ABD(self, ss) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ss = np.atleast_1d(np.asarray(ss, dtype=float))
        rho, z = self._rz(ss)
        d = bspline_eval(self.phodo, ss)
        pr, pz = d @ self.X, d @ self.Z
        A, B = pz * self.kx, pz * self.ky
        if self.persp:
            D = pz * rho - pr * (self.kz + z)
        else:
            D = -pr * self.kz
        return A, B, D

    def _point_at(self, u: float, s: float) -> np.ndarray:
        rho, z = self._rz(np.array([float(s)]))
        er = np.cos(u) * self.X + np.sin(u) * self.Y
        return self.C + float(rho[0]) * er + float(z[0]) * self.Z

    def _F(self, u: float, s: float) -> float:
        A, B, D = self._ABD(s)
        return float(A[0] * np.cos(u) + B[0] * np.sin(u) + D[0])

    def _w_of(self, s: float) -> float:
        return float(s - self.v_bot)

    def _v_of(self, p: np.ndarray) -> float:
        """Profile parameter of a 3D point on the surface (by meridian
        (rho, z) nearest-sampling; used only to sign seam sub-arcs)."""
        q = p - self.C
        zc = float(q @ self.Z)
        rad = float(np.linalg.norm(q - zc * self.Z))
        rho, z = self._rz(self._sgrid)
        i = int(np.argmin((rho - rad) ** 2 + (z - zc) ** 2))
        return float(self._sgrid[i])

    # -- analytic branches -------------------------------------------------------

    def _branch_u(self, s: float, sign: int,
                  u_ref: float) -> Optional[float]:
        """u on the phi + sign*delta branch at s, unwrapped near u_ref;
        None when s is infeasible (amp < |D|)."""
        A, B, D = self._ABD(s)
        a, b, dd = float(A[0]), float(B[0]), float(D[0])
        amp = float(np.hypot(a, b))
        if amp < 1e-15 or amp < abs(dd):
            return None
        phi = float(np.arctan2(b, a))
        delta = float(np.arccos(np.clip(-dd / amp, -1.0, 1.0)))
        u = phi + sign * delta
        return u_ref + float((u - u_ref + np.pi) % TWO_PI - np.pi)

    def _station_crossings(self, s_st: float) -> List[float]:
        A, B, D = self._ABD(s_st)
        return [float(u % TWO_PI) for u in _solve_silhouette(
            float(A[0]), float(B[0]), -float(D[0]))]

    def _seam_crossings(self) -> List[float]:
        """Interior profile parameters where the silhouette crosses the
        seam meridian: in-domain sign-change roots of g(u_s, s)."""
        A, B, D = self._ABD(self._sgrid)
        h = A * np.cos(self.u_s) + B * np.sin(self.u_s) + D
        roots: List[float] = []
        for a, b, ha, hb in zip(self._sgrid[:-1], self._sgrid[1:],
                                h[:-1], h[1:]):
            if ha == 0.0 or ha * hb >= 0.0:
                continue
            x, y, fa = float(a), float(b), float(ha)
            for _ in range(60):
                m = (x + y) / 2
                fm = self._F(self.u_s, m)
                if fa * fm <= 0.0:
                    y = m
                else:
                    x, fa = m, fm
            roots.append((x + y) / 2)
        return [r for r in roots
                if self.v_bot + 10 * self._eps_s < r
                < self.v_top - 10 * self._eps_s]

    # -- boundary classification ---------------------------------------------

    def _classify(self):
        counts: Dict[int, int] = {}
        order: List[BEdge] = []
        for edge, _ in self.loop:
            counts[id(edge)] = counts.get(id(edge), 0) + 1
            if counts[id(edge)] == 1:
                order.append(edge)
        rho_ends, z_ends = self._rz(np.array([self.s_lo, self.s_hi]))
        ring: List[Tuple[int, BEdge]] = []
        seam: Optional[BEdge] = None
        for edge in order:
            if edge.curve.kind == "circle" and counts[id(edge)] == 1:
                cf = edge.curve.frame
                off = cf.origin - self.C
                axial = float(off @ self.Z)
                if (float(np.linalg.norm(off - axial * self.Z)) > 1e-6
                        or abs(abs(float(cf.z @ self.Z)) - 1.0) > 1e-6):
                    raise UnsupportedStep("revolution ring circle off-axis")
                st = None
                for i in range(2):
                    if (abs(axial - float(z_ends[i])) < 1e-6
                            and abs(edge.curve.radius
                                    - float(rho_ends[i])) < 1e-6):
                        st = i
                if st is None:
                    raise UnsupportedStep(
                        "revolution ring circle off the profile ends")
                ring.append((st, edge))
            elif edge.curve.kind == "bspline" and counts[id(edge)] == 2:
                if seam is not None:
                    raise UnsupportedStep(
                        "revolution band with multiple seams")
                seam = edge
            else:
                raise UnsupportedStep(
                    "unrecognized revolution boundary edge")
        if seam is None:
            raise UnsupportedStep("revolution band without a profile seam")
        self.seam = seam
        self.u_s = self._theta(midpoint_of(seam))
        self.v_bot, self.v_top = self.s_lo, self.s_hi
        self.H = self.v_top - self.v_bot

        # the seam must BE the profile at a single meridian, traversed
        # same-way or reversed (affine parameter map)
        t_lo, t_hi = (seam.arc_span if seam.arc_span is not None
                      else bspline_domain(seam.curve))
        ss = np.linspace(self.s_lo, self.s_hi, 9)
        want = np.stack([self._point_at(self.u_s, float(s)) for s in ss])
        tt = t_lo + (ss - self.s_lo) * (t_hi - t_lo) / self.H
        fwd = float(np.max(np.abs(bspline_eval(seam.curve, tt) - want)))
        rev = float(np.max(np.abs(
            bspline_eval(seam.curve, (t_lo + t_hi) - tt) - want)))
        if min(fwd, rev) > 1e-6:
            raise UnsupportedStep(
                "revolution seam is not the profile meridian")
        self._seam_fwd = fwd <= rev
        self._t_lo, self._t_hi = t_lo, t_hi

        self.station_pieces: Dict[int, List[BEdge]] = {0: [], 1: []}
        for st, edge in ring:
            self.station_pieces[st].append(edge)
        for st in (0, 1):
            if not self.station_pieces[st]:
                raise UnsupportedStep(
                    "revolution band is missing a station circle")
            total = 0.0
            for edge in self.station_pieces[st]:
                t0, t1 = ensure_arc_span(edge)
                total += t1 - t0
            if abs(total - TWO_PI) > 1e-5:
                raise UnsupportedStep("partial-revolution bands need "
                                      "the OCC backend")
        for edge, orient in self.loop:
            if edge in self.station_pieces[0]:
                sense = 1 if float(edge.curve.frame.z @ self.Z) > 0 else -1
                if sense * (1 if orient == 0 else -1) != 1:
                    raise UnsupportedStep(
                        "unexpected revolution band orientation")
                break

    def _t_of(self, s: float) -> float:
        t = self._t_lo + (s - self.s_lo) * (self._t_hi - self._t_lo) / self.H
        return t if self._seam_fwd else (self._t_lo + self._t_hi) - t

    def _subdivide_seam(self, seam_ss: List[float]) -> List[BEdge]:
        """Split the B-spline seam edge at interior profile parameters
        (shared-curve sub-spans, like _ExtrusionSplitter's subdivision)."""
        if not seam_ss:
            return [self.seam]
        ts = sorted(self._t_of(s) for s in seam_ss)
        t0, t1 = self._t_lo, self._t_hi
        inner = [t for t in ts if t0 + 1e-9 < t < t1 - 1e-9]
        if not inner:
            return [self.seam]
        bounds = [t0] + inner + [t1]
        verts = [self.seam.v0]
        for t in inner:
            p = bspline_eval(self.seam.curve, t)[0]
            verts.append(self.reg.vertex_near(p))
        verts.append(self.seam.v1)
        subs = [BEdge(verts[i], verts[i + 1], self.seam.curve,
                      arc_span=(bounds[i], bounds[i + 1]))
                for i in range(len(bounds) - 1)]
        self.reg.substitute(self.seam, subs)
        return subs

    # -- the s-sweep trace -----------------------------------------------------

    def _walk(self, key: int, s_dir: int):
        """Follow the silhouette from an event vertex, sweeping the profile
        parameter and flipping at tangencies, until the next event vertex.
        Returns (samples [(u, s)], end_key, arrival s_dir)."""
        u0, s0 = self.v_coords[key]
        probe = s0 + s_dir * 2 * self._eps_s
        sign = None
        best = None
        for cand in (+1, -1):
            u = self._branch_u(probe, cand, u0)
            if u is not None and (best is None or abs(u - u0) < best):
                best, sign = abs(u - u0), cand
        if sign is None:
            raise UnsupportedStep("revolution silhouette start infeasible")
        u, s = u0, s0
        samples = [(u, s)]
        ds = self.H / 256.0
        u_seam = None  # unwrapped seam meridian near the walk
        budget = 64 * 256  # total sub-steps
        moved = False
        for _ in range(budget):
            step = s_dir * ds
            s_next = float(np.clip(s + step, self.v_bot, self.v_top))
            # s is strictly interior here, so touching a bound IS arrival
            # (exact-equality landings must not slip through and duplicate)
            hit_station = s_next <= self.v_bot or s_next >= self.v_top
            u_next = self._branch_u(s_next, sign, u)
            if u_next is None:
                # tangency between s and s_next: bisect the feasibility edge
                x, y = s, s_next
                for _ in range(60):
                    m = (x + y) / 2
                    if self._branch_u(m, sign, u) is None:
                        y = m
                    else:
                        x = m
                u_t = self._branch_u(x, sign, u)
                samples.append((u_t, x))
                sign, s_dir = -sign, -s_dir
                u, s = u_t, x
                moved = True
                continue
            if abs(u_next - u) > TWO_PI / 128 and ds > self.H / 16384:
                ds /= 2
                continue
            # seam crossing between u and u_next?
            u_seam = u + float((self.u_s - u + np.pi) % TWO_PI - np.pi)
            if (moved or abs(u - u_seam) > 1e-9) and \
                    (u - u_seam) * (u_next - u_seam) <= 0 and \
                    abs(u - u_seam) < np.pi / 2:
                # land exactly on the seam: bisect s on this branch
                x, y = s, s_next
                fx = u - u_seam
                for _ in range(60):
                    m = (x + y) / 2
                    um = self._branch_u(m, sign, u)
                    if um is None or fx * (um - u_seam) <= 0:
                        y = m
                    else:
                        x = m
                s_x = (x + y) / 2
                end = self._match_vertex(self.u_s, s_x)
                if end is None:
                    raise UnsupportedStep(
                        "unregistered revolution seam crossing")
                samples.append((u_seam, self.v_coords[end][1]))
                return self._dedupe(samples), end, s_dir
            samples.append((u_next, s_next))
            u, s = u_next, s_next
            moved = True
            if hit_station:
                end = self._match_vertex(u, s)
                if end is None:
                    raise UnsupportedStep(
                        "revolution silhouette misses its station crossing")
                return self._dedupe(samples), end, s_dir
        raise UnsupportedStep("unterminated revolution silhouette trace")

    @staticmethod
    def _dedupe(samples):
        """Drop coincident consecutive samples (degenerate steps would give
        the half-edge tracer zero-length tangents and wrong angles)."""
        out = [samples[0]]
        for u, s in samples[1:]:
            if abs(u - out[-1][0]) > 1e-12 or abs(s - out[-1][1]) > 1e-12:
                out.append((u, s))
        if len(out) < 2:
            raise UnsupportedStep("degenerate revolution silhouette piece")
        return out

    def _match_vertex(self, u: float, s: float) -> Optional[int]:
        for key, (uk, sk) in self.v_coords.items():
            if (abs(float((uk - u + np.pi) % TWO_PI - np.pi)) < 1e-4
                    and abs(sk - s) < max(1e-4 * self.H, 100 * self._eps_s)):
                return key
        return None

    # -- the split --------------------------------------------------------------

    def split(self) -> Optional[List[BFace]]:
        self._classify()
        xb = self._station_crossings(self.v_bot)
        xt = self._station_crossings(self.v_top)
        seam_ss = self._seam_crossings()

        # island guard: every feasible interval must carry an event
        A, B, D = self._ABD(self._sgrid)
        feas = np.hypot(A, B) - np.abs(D) > 0
        if not feas.any():
            if xb or xt or seam_ss:
                raise UnsupportedStep(
                    "inconsistent revolution silhouette events")
            return None
        if not (xb or xt or seam_ss):
            raise UnsupportedStep(
                "revolution silhouette island (camera too close); "
                "use the OCC backend")
        runs: List[Tuple[float, float]] = []
        start = None
        for i, f in enumerate(feas):
            if f and start is None:
                start = self._sgrid[i]
            if not f and start is not None:
                runs.append((start, self._sgrid[i]))
                start = None
        if start is not None:
            runs.append((start, self._sgrid[-1]))
        for a, b in runs:
            has_event = ((a <= self.v_bot + 2 * self._eps_s and xb)
                         or (b >= self.v_top - 2 * self._eps_s and xt)
                         or any(a - 1e-9 <= s <= b + 1e-9 for s in seam_ss))
            if not has_event:
                raise UnsupportedStep(
                    "revolution silhouette island; use the OCC backend")

        # ---- event vertices
        self.v_coords: Dict[int, Tuple[float, float]] = {}
        vertices: Dict[int, BVertex] = {}
        starts: List[Tuple[int, int]] = []

        def add_vertex(u: float, s: float) -> int:
            vert = self.reg.vertex_near(self._point_at(u, s))
            if id(vert) not in self.v_coords:
                self.v_coords[id(vert)] = (u % TWO_PI, s)
                vertices[id(vert)] = vert
            return id(vert)

        crossings = ([(u, self.v_bot) for u in xb]
                     + [(u, self.v_top) for u in xt])
        for (u1, s1), (u2, s2) in zip(crossings, crossings[1:]):
            if (abs(s1 - s2) < 1e-9
                    and abs((u1 - u2 + np.pi) % TWO_PI - np.pi) < 1e-3):
                raise UnsupportedStep("revolution silhouette sliver")
        for u_e, s_st in crossings:
            if abs((u_e - self.u_s + np.pi) % TWO_PI - np.pi) < 1e-3:
                raise UnsupportedStep(
                    "revolution station crossing on the seam meridian")
            key = add_vertex(u_e, s_st)
            starts.append((key, +1 if s_st == self.v_bot else -1))
        for s in seam_ss:
            key = add_vertex(self.u_s, s)
            starts.append((key, +1))
            starts.append((key, -1))

        # ---- trace the silhouette arcs
        open_starts = set(starts)
        if len(open_starts) != len(starts):
            raise UnsupportedStep("coincident revolution silhouette events")
        silhouette_pieces: List[_TracePiece] = []
        while open_starts:
            key, s_dir = next(s for s in starts if s in open_starts)
            open_starts.discard((key, s_dir))
            samples, end_key, d_f = self._walk(key, s_dir)
            arrival = (end_key, -d_f)
            if arrival not in open_starts:
                raise UnsupportedStep("revolution silhouette trace mismatch")
            open_starts.discard(arrival)
            pts = np.stack([self._point_at(u, s) for u, s in samples])
            v0, v1 = vertices[key], vertices[end_key]
            pts[0], pts[-1] = v0.point, v1.point
            bedge = BEdge(v0, v1, BCurve("poly", points=pts))
            uw = np.array([[u, float(np.clip(self._w_of(s), 0.0, self.H))]
                           for u, s in samples])
            silhouette_pieces.append(_TracePiece(bedge, uw))

        # ---- subdivide station circles and the seam; assemble regions
        trace_pieces: List[_TracePiece] = list(silhouette_pieces)
        for st, xs, s_st, w in ((0, xb, self.v_bot, 0.0),
                                (1, xt, self.v_top, self.H)):
            cut_pts = [self._point_at(u, s_st) for u in xs]
            for edge in self.station_pieces[st]:
                existing = [self._theta(edge.v0.point),
                            self._theta(edge.v1.point)]
                pts = [p for u, p in zip(xs, cut_pts)
                       if all(abs((u - e + np.pi) % TWO_PI - np.pi) > 1e-4
                              for e in existing)]
                for sub in self._subdivide_circle(edge, pts):
                    trace_pieces.append(self._station_trace_piece(sub, w))
        seam_subs = self._subdivide_seam(seam_ss)
        cycles = _BandTracer(trace_pieces).cycles()
        return self._assemble(cycles, seam_subs)

    def _emit(self, walk: List[Tuple[BEdge, int]]) -> BFace:
        f = self.face
        return BFace(f.surface_kind, f.frame, 0.0, 0.0, f.same_sense,
                     [walk], fid=f.fid, profile=f.profile)


class _PatchSplitter:
    """Split one general (doubly-curved) B-spline patch face along its
    silhouette.

    The supported face is a FULL quad patch: single loop of four B-spline
    edges that ARE the patch's boundary iso-curves (trimmed patches raise
    toward the OCC backend). The silhouette g(u, v) = N(u, v).(S - E) = 0
    has no analytic structure, so it is traced numerically: boundary
    events come from sign-change bisection of g along the four sides,
    arcs march between events with a predictor (perpendicular to the
    finite-difference gradient) and a Newton corrector, and a flood fill
    of g's sign over a sample grid rejects interior silhouette islands.
    Region assembly reuses the half-edge cycle tracer on the (u, v)
    rectangle: every region is a disc (positive shoelace area); the one
    negative cycle is the domain exterior and is dropped. This is the
    surface class the reference only reaches through OCC HLR
    (GeomAbs_BSplineSurface faces, TopoMapper.py:38-83)."""

    _GRID = 65  # island-detection sample grid per axis

    def __init__(self, face: BFace, projector: NativeProjector, tol: float,
                 registry: "_SplitRegistry"):
        self.face, self.tol, self.reg = face, tol, registry
        if len(face.loops) != 1:
            raise UnsupportedStep(
                "multi-loop patch faces need the OCC backend")
        self.loop = registry.expand(face.loops[0])
        self.patch = face.patch
        self.su, self.sv = patch_partials(self.patch)
        (self.ul, self.uh), (self.vl, self.vh) = self.patch.domain()
        self.du_dom = self.uh - self.ul
        self.dv_dom = self.vh - self.vl
        if projector.eye is None:
            self.view, self.persp = projector.n, False
        else:
            self.view, self.persp = projector.eye, True

    # -- the silhouette functional -------------------------------------------

    def _g(self, uvs) -> np.ndarray:
        uvs = np.atleast_2d(np.asarray(uvs, dtype=float))
        n = np.cross(patch_eval(self.su, uvs), patch_eval(self.sv, uvs))
        if not self.persp:
            return n @ self.view
        return np.einsum("ij,ij->i",
                         n, patch_eval(self.patch, uvs) - self.view[None, :])

    def _grad(self, uv) -> np.ndarray:
        eu = 1e-6 * self.du_dom
        ev = 1e-6 * self.dv_dom
        u, v = float(uv[0]), float(uv[1])
        g = self._g([(u + eu, v), (u - eu, v), (u, v + ev), (u, v - ev)])
        return np.array([(g[0] - g[1]) / (2 * eu), (g[2] - g[3]) / (2 * ev)])

    # -- boundary classification ----------------------------------------------

    _SIDES = ("v0", "u1", "v1", "u0")

    def _side_uv(self, side: str, t: float) -> Tuple[float, float]:
        """Domain coords of boundary parameter t (the iso-curve's own
        parameter: u for v0/v1 sides, v for u0/u1)."""
        if side == "v0":
            return t, self.vl
        if side == "v1":
            return t, self.vh
        if side == "u0":
            return self.ul, t
        return self.uh, t

    def _side_dom(self, side: str) -> Tuple[float, float]:
        return (self.ul, self.uh) if side in ("v0", "v1") else (self.vl, self.vh)

    def _classify(self):
        edges = []
        for edge, orient in self.loop:
            if edge.curve.kind != "bspline":
                raise UnsupportedStep("patch face with a non-spline edge")
            edges.append(edge)
        if len(edges) != 4 or len({id(e) for e in edges}) != 4:
            raise UnsupportedStep(
                "patch face is not a full four-sided quad; use the OCC "
                "backend (trimmed patches)")
        self.sides: Dict[str, Tuple[BEdge, bool]] = {}
        for side in self._SIDES:
            iso = patch_boundary_curve(self.patch, side)
            lo, hi = bspline_domain(iso)
            ts = np.linspace(lo, hi, 9)
            want = bspline_eval(iso, ts)
            hit = None
            for e in edges:
                elo, ehi = (e.arc_span if e.arc_span is not None
                            else bspline_domain(e.curve))
                m = elo + (ts - lo) * (ehi - elo) / (hi - lo)
                if float(np.max(np.abs(
                        bspline_eval(e.curve, m) - want))) < 1e-6:
                    hit = (e, True)
                    break
                if float(np.max(np.abs(
                        bspline_eval(e.curve, (elo + ehi) - m)
                        - want))) < 1e-6:
                    hit = (e, False)
                    break
            if hit is None:
                raise UnsupportedStep(
                    f"patch boundary edge for side {side} not found "
                    "(trimmed patch?); use the OCC backend")
            edges.remove(hit[0])
            self.sides[side] = hit

    def _edge_t(self, side: str, t_dom: float) -> float:
        """Boundary edge curve parameter of domain boundary parameter."""
        edge, fwd = self.sides[side]
        elo, ehi = (edge.arc_span if edge.arc_span is not None
                    else bspline_domain(edge.curve))
        lo, hi = self._side_dom(side)
        t = elo + (t_dom - lo) * (ehi - elo) / (hi - lo)
        return t if fwd else (elo + ehi) - t

    # -- events ---------------------------------------------------------------

    def _side_events(self, side: str) -> List[float]:
        lo, hi = self._side_dom(side)
        ts = np.linspace(lo, hi, 257)
        g = self._g([self._side_uv(side, float(t)) for t in ts])
        out: List[float] = []
        for a, b, ga, gb in zip(ts[:-1], ts[1:], g[:-1], g[1:]):
            if ga == 0.0 or ga * gb >= 0.0:
                continue
            x, y, fa = float(a), float(b), float(ga)
            for _ in range(60):
                m = (x + y) / 2
                fm = float(self._g([self._side_uv(side, m)])[0])
                if fa * fm <= 0.0:
                    y = m
                else:
                    x, fa = m, fm
            out.append((x + y) / 2)
        eps = 1e-3 * (hi - lo)
        if any(t < lo + eps or t > hi - eps for t in out):
            raise UnsupportedStep("patch silhouette through a domain corner")
        for a, b in zip(out, out[1:]):
            if b - a < 2 * eps:
                raise UnsupportedStep("patch silhouette sliver")
        return out

    def _guard_islands(self, has_events: bool):
        """Flood-fill g's sign components on a sample grid from the
        boundary; an interior component that never touches the boundary is
        a silhouette island the quad assembly cannot represent."""
        m = self._GRID
        us = np.linspace(self.ul, self.uh, m)
        vs = np.linspace(self.vl, self.vh, m)
        uv = np.stack(np.meshgrid(us, vs, indexing="ij"), axis=-1)
        sign = self._g(uv.reshape(-1, 2)).reshape(m, m) > 0
        reach = np.zeros((m, m), dtype=bool)
        reach[0, :] = reach[-1, :] = reach[:, 0] = reach[:, -1] = True
        for _ in range(2 * m):
            grow = reach.copy()
            grow[1:, :] |= reach[:-1, :] & (sign[1:, :] == sign[:-1, :])
            grow[:-1, :] |= reach[1:, :] & (sign[:-1, :] == sign[1:, :])
            grow[:, 1:] |= reach[:, :-1] & (sign[:, 1:] == sign[:, :-1])
            grow[:, :-1] |= reach[:, 1:] & (sign[:, :-1] == sign[:, 1:])
            if bool((grow == reach).all()):
                break
            reach = grow
        if not bool(reach.all()):
            raise UnsupportedStep(
                "patch silhouette island (camera too close); use the "
                "OCC backend")
        if not has_events and bool(sign.all() != sign.any()):
            # mixed signs with no boundary events cannot happen without an
            # island; reaching here means the grid missed it
            raise UnsupportedStep("inconsistent patch silhouette events")

    # -- marching ---------------------------------------------------------------

    def _march(self, key: int):
        """Trace the silhouette from a boundary event vertex into the
        domain until it exits at another event; returns (samples, end)."""
        u, v = self.v_coords[key]
        h = 1.0 / 512.0 * float(np.hypot(self.du_dom, self.dv_dom))
        # inward unit normal at the start
        inward = np.array([
            (1.0 if abs(u - self.ul) < abs(u - self.uh) else -1.0)
            if min(abs(u - self.ul), abs(u - self.uh))
            < min(abs(v - self.vl), abs(v - self.vh)) else 0.0, 0.0])
        if inward[0] == 0.0:
            inward = np.array([
                0.0, 1.0 if abs(v - self.vl) < abs(v - self.vh) else -1.0])
        p = np.array([u, v])
        samples = [(float(p[0]), float(p[1]))]
        prev_t = None
        for _ in range(16384):
            grad = self._grad(p)
            gn = float(np.linalg.norm(grad))
            if gn < 1e-12:
                raise UnsupportedStep("tangential patch silhouette")
            t = np.array([-grad[1], grad[0]]) / gn
            if prev_t is None:
                if float(t @ inward) < 0:
                    t = -t
                if abs(float(t @ inward)) < 1e-3:
                    raise UnsupportedStep("patch silhouette grazes the "
                                          "boundary")
            elif float(t @ prev_t) < 0:
                t = -t
            q = p + h * t
            for _ in range(3):  # Newton corrector
                gq = float(self._g([q])[0])
                gr = self._grad(q)
                q = q - gq * gr / max(float(gr @ gr), 1e-18)
            inside = (self.ul <= q[0] <= self.uh
                      and self.vl <= q[1] <= self.vh)
            if not inside:
                # bisect the exit along the curve parameterized by step
                # fraction, then land on the matching boundary event
                x, y = 0.0, 1.0
                for _ in range(40):
                    mfrac = (x + y) / 2
                    qm = p + mfrac * (q - p)
                    if (self.ul <= qm[0] <= self.uh
                            and self.vl <= qm[1] <= self.vh):
                        x = mfrac
                    else:
                        y = mfrac
                qx = p + x * (q - p)
                end = None
                for k2, (uk, vk) in self.v_coords.items():
                    if (k2 != key or len(samples) > 4) and \
                            np.hypot(uk - qx[0], vk - qx[1]) < 4 * h:
                        end = k2
                        break
                if end is None:
                    raise UnsupportedStep(
                        "patch silhouette exit misses its boundary event")
                samples.append(self.v_coords[end])
                return samples, end
            prev_t = t
            p = q
            samples.append((float(p[0]), float(p[1])))
        raise UnsupportedStep("unterminated patch silhouette trace")

    # -- the split --------------------------------------------------------------

    def split(self) -> Optional[List[BFace]]:
        self._classify()
        events = {side: self._side_events(side) for side in self._SIDES}
        n_events = sum(len(v) for v in events.values())
        if n_events % 2:
            raise UnsupportedStep("odd patch silhouette event count")
        self._guard_islands(n_events > 0)
        if n_events == 0:
            return None

        self.v_coords: Dict[int, Tuple[float, float]] = {}
        vertices: Dict[int, BVertex] = {}
        for side, ts in events.items():
            for t in ts:
                uv = self._side_uv(side, t)
                vert = self.reg.vertex_near(patch_eval(self.patch, [uv])[0])
                self.v_coords[id(vert)] = uv
                vertices[id(vert)] = vert

        # trace the arcs (each consumes its two endpoint events)
        open_keys = set(self.v_coords)
        pieces: List[_TracePiece] = []
        while open_keys:
            key = next(k for k in self.v_coords if k in open_keys)
            open_keys.discard(key)
            samples, end = self._march(key)
            if end not in open_keys:
                raise UnsupportedStep("patch silhouette trace mismatch")
            open_keys.discard(end)
            pts = patch_eval(self.patch, np.asarray(samples))
            pts[0] = vertices[key].point
            pts[-1] = vertices[end].point
            bedge = BEdge(vertices[key], vertices[end],
                          BCurve("poly", points=pts))
            pieces.append(_TracePiece(bedge, np.asarray(samples)))

        # subdivide the boundary edges at their events
        for side in self._SIDES:
            edge, fwd = self.sides[side]
            ts_dom = events[side]
            lo, hi = self._side_dom(side)
            bounds_dom = [lo] + sorted(ts_dom) + [hi]
            if not ts_dom:
                subs = [edge]
            else:
                # ascending edge-parameter order regardless of the side's
                # domain direction (sub-edges are built natural-first)
                inner = sorted(self._edge_t(side, t) for t in ts_dom)
                elo, ehi = (edge.arc_span if edge.arc_span is not None
                            else bspline_domain(edge.curve))
                ebounds = [elo] + inner + [ehi]
                everts = [edge.v0]
                for te in inner:
                    p = bspline_eval(edge.curve, te)[0]
                    everts.append(self.reg.vertex_near(p))
                everts.append(edge.v1)
                subs = [BEdge(everts[i], everts[i + 1], edge.curve,
                              arc_span=(ebounds[i], ebounds[i + 1]))
                        for i in range(len(ebounds) - 1)]
                self.reg.substitute(edge, subs)
            # trace pieces for the sub-edges, in domain coords
            doms = bounds_dom if fwd else bounds_dom[::-1]
            for i, sub in enumerate(subs):
                a = self._side_uv(side, doms[i])
                b = self._side_uv(side, doms[i + 1])
                pieces.append(_TracePiece(sub, np.array([a, b])))

        cycles = _BandTracer(pieces).cycles()
        area_dom = self.du_dom * self.dv_dom
        out: List[BFace] = []
        neg = 0
        covered = 0.0
        for cycle in cycles:
            uw = _cycle_uw(cycle)
            area = float((uw[:-1, 0] * uw[1:, 1]
                          - uw[:-1, 1] * uw[1:, 0]).sum()) / 2.0
            if area < 0:
                neg += 1
                continue
            covered += area
            walk = [(p.edge, 0 if d > 0 else 1) for p, d in cycle]
            f = self.face
            out.append(BFace(f.surface_kind, f.frame, 0.0, 0.0,
                             f.same_sense, [walk], fid=f.fid,
                             patch=f.patch))
        if neg != 1 or abs(covered - area_dom) > 1e-3 * area_dom:
            raise UnsupportedStep("patch region assembly did not tile the "
                                  "domain; use the OCC backend")
        return out


def midpoint_of(edge: BEdge) -> np.ndarray:
    """3D midpoint of an edge along its curve (arc-aware)."""
    if edge.curve.kind == "line":
        return (edge.v0.point + edge.v1.point) / 2.0
    if edge.curve.kind == "poly":
        pts = np.asarray(edge.curve.points, dtype=float)
        return pts[len(pts) // 2]
    if edge.curve.kind == "bspline":
        lo, hi = (edge.arc_span if edge.arc_span is not None
                  else bspline_domain(edge.curve))
        return bspline_eval(edge.curve, (lo + hi) / 2)[0]
    t0, t1 = ensure_arc_span(edge)
    t = (t0 + t1) / 2.0
    fr = edge.curve.frame
    return (fr.origin + edge.curve.radius
            * (np.cos(t) * fr.x + np.sin(t) * fr.y))


class _ExtrusionSplitter:
    """Split one linear-extrusion freeform wall along silhouette rulings.

    The supported wall is a quad patch: ONE B-spline profile edge at each
    end of the extrusion and two straight boundary rulings (the shape
    extruded-profile B-Reps produce; anything else raises toward the OCC
    backend). For the surface P(u, t) = C(u) + t*d the normal
    N(u) = C'(u) x d is independent of t, and the view ray to P differs
    from C(u) - E by a multiple of d, so the silhouette condition
    N . (P - E) = 0 reduces to the t-free scalar

        g(u) = (C'(u) x d) . (C(u) - E)     (perspective, eye E)
        g(u) = (C'(u) x d) . w              (orthographic, view dir w)

    — silhouettes are whole rulings at the sign-change roots of g,
    exactly the outline edges OCC's HLR finds on ruled surfaces and feeds
    to BRepFeat_SplitShape (reference TopoMapper.py:38-83). Tangential
    touches (g grazing zero without crossing) split no area and are
    skipped, matching _solve_silhouette's grazing rule."""

    def __init__(self, face: BFace, projector: NativeProjector, tol: float,
                 registry: "_SplitRegistry"):
        self.face = face
        self.tol = tol
        self.reg = registry
        if len(face.loops) != 1:
            raise UnsupportedStep(
                "multi-loop freeform faces need the OCC backend")
        self.loop = registry.expand(face.loops[0])
        self.d = np.asarray(face.extrude, dtype=float)
        self.dz = _unit(self.d)
        self.projector = projector

    # -- classification ------------------------------------------------------

    def _classify(self):
        splines: List[Tuple[BEdge, int]] = []
        lines: List[BEdge] = []
        for edge, orient in self.loop:
            if edge.curve.kind == "bspline":
                splines.append((edge, orient))
            elif edge.curve.kind == "line":
                lines.append(edge)
            else:
                raise UnsupportedStep(
                    "freeform wall with a non-line/spline boundary edge")
        if len(splines) != 2 or len(lines) != 2:
            raise UnsupportedStep(
                f"freeform wall with {len(splines)} profile edges and "
                f"{len(lines)} rulings is outside the native subset")
        dn = float(np.linalg.norm(self.d))
        for e in lines:
            t = e.v1.point - e.v0.point
            if (float(np.linalg.norm(np.cross(t, self.d)))
                    > 1e-6 * dn * float(np.linalg.norm(t))):
                raise UnsupportedStep(
                    "freeform wall boundary line not along the extrusion")
        heights = [float(midpoint_of(e) @ self.dz) for e, _ in splines]
        (bot, bot_o), (top, _) = (splines if heights[0] < heights[1]
                                  else splines[::-1])
        self.bot, self.bot_o, self.top = bot, bot_o, top
        self.lines = lines
        self.lo, self.hi = bspline_domain(bot.curve)
        self.tlo, self.thi = bspline_domain(top.curve)
        # the top edge must be the bottom translated by d, traversed the
        # same way (u -> u) or opposite (u -> tlo + thi - u)
        ts = np.linspace(self.lo, self.hi, 9)
        pb = bspline_eval(bot.curve, ts) + self.d[None, :]
        m = self._map_same(ts)
        same = float(np.max(np.abs(bspline_eval(top.curve, m) - pb))) < 1e-6
        rev = float(np.max(np.abs(
            bspline_eval(top.curve, (self.tlo + self.thi) - m) - pb))) < 1e-6
        if not (same or rev):
            raise UnsupportedStep(
                "freeform wall ends are not extrusion translates")
        self.top_same = same

    def _map_same(self, u):
        return self.tlo + (np.asarray(u, dtype=float) - self.lo) \
            * (self.thi - self.tlo) / (self.hi - self.lo)

    # -- silhouette ----------------------------------------------------------

    def _g(self, us: np.ndarray) -> np.ndarray:
        nrm = np.cross(bspline_eval(self._hodo, us), self.d[None, :])
        if self.projector.eye is None:
            return nrm @ self.projector.n
        pts = bspline_eval(self.bot.curve, us)
        return np.einsum("ij,ij->i",
                         nrm, pts - self.projector.eye[None, :])

    def _roots(self) -> List[float]:
        lo, hi = self.lo, self.hi
        spans = sorted({float(k) for k in self.bot.curve.knots
                        if lo <= k <= hi} | {lo, hi})
        us = np.unique(np.concatenate(
            [np.linspace(a, b, 33) for a, b in zip(spans, spans[1:])]))
        g = self._g(us)
        roots: List[float] = []
        for a, b, ga, gb in zip(us[:-1], us[1:], g[:-1], g[1:]):
            if ga == 0.0 or ga * gb >= 0.0:
                continue  # tangential grazing or no crossing
            x, y, fa = float(a), float(b), float(ga)
            for _ in range(60):
                mid = (x + y) / 2
                fm = float(self._g(np.array([mid]))[0])
                if fa * fm <= 0.0:
                    y = mid
                else:
                    x, fa = mid, fm
            roots.append((x + y) / 2)
        eps = 1e-3 * (hi - lo)
        return [r for r in roots if lo + eps < r < hi - eps]

    # -- splitting -----------------------------------------------------------

    def _line_at(self, v: BVertex) -> BEdge:
        for e in self.lines:
            if e.v0 is v or e.v1 is v:
                return e
        for e in self.lines:
            if min(float(np.linalg.norm(e.v0.point - v.point)),
                   float(np.linalg.norm(e.v1.point - v.point))) < 1e-6:
                return e
        raise UnsupportedStep("freeform wall boundary ruling not found")

    def split(self) -> Optional[List[BFace]]:
        self._classify()
        self._hodo = bspline_hodograph(self.bot.curve)
        cuts = self._roots()
        if not cuts:
            return None
        bounds = [self.lo] + cuts + [self.hi]
        cut_pts = bspline_eval(self.bot.curve, np.asarray(cuts))
        bot_vs = [self.reg.vertex_near(p) for p in cut_pts]
        top_vs = [self.reg.vertex_near(p + self.d) for p in cut_pts]

        bverts = [self.bot.v0] + bot_vs + [self.bot.v1]
        bot_subs = [BEdge(bverts[i], bverts[i + 1], self.bot.curve,
                          arc_span=(bounds[i], bounds[i + 1]))
                    for i in range(len(bounds) - 1)]
        self.reg.substitute(self.bot, bot_subs)

        if self.top_same:
            tb = [float(self._map_same(u)) for u in bounds]
            tverts = [self.top.v0] + top_vs + [self.top.v1]
        else:
            # top natural direction runs opposite the bottom's: its
            # sub-edges ascend the TOP domain, i.e. descend in bottom u
            tb = [float((self.tlo + self.thi) - self._map_same(u))
                  for u in bounds[::-1]]
            tverts = [self.top.v0] + top_vs[::-1] + [self.top.v1]
        top_subs = [BEdge(tverts[i], tverts[i + 1], self.top.curve,
                          arc_span=(tb[i], tb[i + 1]))
                    for i in range(len(tb) - 1)]
        self.reg.substitute(self.top, top_subs)

        rulings = [BEdge(bv, tv, BCurve("line", point=bv.point,
                                        direction=self.dz))
                   for bv, tv in zip(bot_vs, top_vs)]
        allr = ([self._line_at(self.bot.v0)] + rulings
                + [self._line_at(self.bot.v1)])

        def up(e: BEdge) -> int:
            return 0 if float((e.v1.point - e.v0.point) @ self.dz) > 0 else 1

        out: List[BFace] = []
        n = len(bot_subs)
        for i in range(n):
            r0, r1 = allr[i], allr[i + 1]
            tsub = top_subs[i] if self.top_same else top_subs[n - 1 - i]
            walk = [(bot_subs[i], 0), (r1, up(r1)),
                    (tsub, 1 if self.top_same else 0), (r0, 1 - up(r0))]
            if self.bot_o == 1:  # parent wire runs the other way around
                walk = [(e, 1 - o) for e, o in walk[::-1]]
            out.append(BFace(self.face.surface_kind, self.face.frame, 0.0,
                             0.0, self.face.same_sense, [walk],
                             fid=self.face.fid, profile=self.face.profile,
                             extrude=self.face.extrude))
        return out


class _SplitRegistry:
    """Global edge substitutions + shared cut vertices across faces."""

    def __init__(self):
        self.subs: Dict[int, List[BEdge]] = {}
        self._parents: Dict[int, BEdge] = {}
        self._verts: Dict[tuple, BVertex] = {}

    def substitute(self, parent: BEdge, subs_natural: List[BEdge]):
        self.subs[id(parent)] = subs_natural
        for s in subs_natural:
            self._parents[id(s)] = parent

    def parent_of(self, edge: BEdge) -> Optional[BEdge]:
        return self._parents.get(id(edge))

    def vertex_at(self, splitter: "_FaceSplitter", theta: float, z: float,
                  make: Optional[np.ndarray] = None) -> BVertex:
        point = make if make is not None else splitter._point_at(theta, z)
        key = tuple(round(float(c), 7) for c in point)
        if key not in self._verts:
            self._verts[key] = BVertex(np.asarray(point, dtype=float))
        return self._verts[key]

    def vertex_near(self, point: np.ndarray, tol: float = 1e-5) -> BVertex:
        """Shared cut vertex by proximity: cut points computed by two
        different splitters (a cylinder's ruling endpoint and the sphere
        silhouette crossing of the shared boundary circle) agree only to
        floating-point, so exact-key dedup would fracture the chain."""
        point = np.asarray(point, dtype=float)
        key = tuple(round(float(c), 7) for c in point)
        if key in self._verts:
            return self._verts[key]
        for v in self._verts.values():
            if float(np.max(np.abs(v.point - point))) < tol:
                return v
        self._verts[key] = BVertex(point)
        return self._verts[key]

    def expand(self, loop: List[Tuple[BEdge, int]]) -> List[Tuple[BEdge, int]]:
        out: List[Tuple[BEdge, int]] = []
        for edge, orient in loop:
            subs = self.subs.get(id(edge))
            if subs is None:
                out.append((edge, orient))
            elif orient == 0:
                out.extend(self.expand([(s, 0) for s in subs]))
            else:
                out.extend(self.expand([(s, 1) for s in subs[::-1]]))
        return out


def split_solid(solid: BSolid, projector: NativeProjector,
                tol: float) -> BSolid:
    """Split every curved face along its silhouette curves; substitute the
    split arcs into every loop that references them (BRepFeat_SplitShape
    semantics: the split modifies the whole shape, TopoMapper.py:58-83).

    Swept faces (cylinder/cone) split first, spheres/tori after: a
    hemisphere on a cylinder shares the equator circle, and the wall's
    ruling endpoints land exactly on the sphere's silhouette crossings —
    processing the doubly-curved faces last lets them reuse those cut
    vertices. A final re-expansion pass updates every emitted walk through
    the full substitution map, so a face split early still sees arcs
    subdivided by a later neighbor."""
    registry = _SplitRegistry()
    replaced: Dict[int, List[BFace]] = {}
    curved = [f for f in solid.faces if f.surface_kind != PLANE]
    for face in sorted(curved, key=lambda f: f.surface_kind
                       in (SPHERE, TORUS, REVOLUTION)
                       or f.patch is not None):
        if face.surface_kind == SPHERE:
            subs = _SphereSplitter(face, projector, tol, registry).split()
        elif face.surface_kind == TORUS:
            subs = _TorusSplitter(face, projector, tol, registry).split()
        elif face.surface_kind == REVOLUTION:
            subs = _RevolutionSplitter(face, projector, tol, registry).split()
        elif face.surface_kind == BSPLINE and face.patch is not None:
            subs = _PatchSplitter(face, projector, tol, registry).split()
        elif face.surface_kind in (BSPLINE, EXTRUSION):
            subs = _ExtrusionSplitter(face, projector, tol, registry).split()
        else:
            subs = _FaceSplitter(face, projector, tol, registry).split()
        if subs is not None:
            replaced[id(face)] = subs
    out: List[BFace] = []
    for face in solid.faces:
        out.extend(replaced.get(id(face), [face]))
    for face in out:
        face.loops = [registry.expand(loop) for loop in face.loops]
    return BSolid(out)


# ---------------------------------------------------------------------------
# the native TopoMapper
# ---------------------------------------------------------------------------


class NativeTopoMapper(TopoMapper):
    """TopoMapper over a parsed STEP B-Rep instead of an OCC shape.

    Inherits the sewn-edge removal / face-merge / edge-merge machinery —
    it is pure record arithmetic (occ_pipeline.py:400-475, itself the
    contract of reference TopoMapper.py:118-185) — and replaces the OCC
    entry points (HLR outline, BRepFeat split, wire exploration,
    discretize_edge, HLRAlgo projection) with the analytic equivalents in
    this module."""

    def __init__(self, solid: BSolid, args: ProjectionArgs):
        self.args = args
        self.tol = args.tol
        self.projector = NativeProjector(args)
        # sewn edges are detected on the ORIGINAL shape (reference
        # TopoMapper.py:118-143): an edge used twice within one face wire
        def find_sewn(shape: BSolid) -> List[int]:
            out: List[int] = []
            for face in shape.faces:
                seen: List[int] = []
                for loop in face.loops:
                    for edge, _ in loop:
                        key = hash(edge)
                        if key in seen:
                            out.append(key)
                        else:
                            seen.append(key)
            return out

        sewn = find_sewn(solid)
        split = split_solid(solid, self.projector, args.tol)
        # when the split SUBDIVIDES a sewn seam (torus/revolution seams
        # crossed by the silhouette), the seam's interior segments come
        # back as sub-edges used twice within ONE sub-face wire (spurs);
        # re-detect on the split shape so those are removed too, while
        # seam segments that became REAL boundaries between two sub-faces
        # (used once in each) are correctly kept
        sewn += [k for k in find_sewn(split) if k not in sewn]
        self._construct_native_mapping(split)
        self._project_native(args.discretize_last)
        self._remove_sewn_edges(sewn)

    def _construct_native_mapping(self, solid: BSolid):
        self.all_edges: Dict[int, EdgeRecord] = {}
        self.all_faces: Dict[int, FaceRecord] = {}
        for face in solid.faces:
            params = ({"radius": face.radius}
                      if face.surface_kind not in (PLANE, BSPLINE, EXTRUSION)
                      else None)
            record = FaceRecord(face, face.surface_kind, params)
            self.all_faces[hash(face)] = record
            for loop in face.loops:
                for edge, orient in loop:
                    key = hash(edge)
                    erec = self.all_edges.get(key)
                    if erec is None:
                        erec = EdgeRecord(edge)
                        self.all_edges[key] = erec
                    erec.faces.append(record)
                    erec.orientations.append(orient)
                    record.add(erec, orient)

    def _project_native(self, discretize_last: bool = False):
        # discretize_last changes WHERE discretization happens in the
        # reference (project the curve then discretize vs discretize then
        # project, occ_pipeline.py:355-379); for line/circle edges under a
        # projective camera both orders sample the same curve, so the
        # native backend always discretizes first.
        del discretize_last
        for erec in self.all_edges.values():
            pts3d = discretize_bedge(erec.edge, self.tol)
            cam = self.projector.project(pts3d)
            erec.dedge3d = [tuple(float(c) for c in p) for p in cam]
            erec.dedge = [(p[0], p[1]) for p in erec.dedge3d]

    def dominant_directions(self):
        pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
        cam = self.projector.project(pts)
        origin, x, y, z = cam
        return [(x - origin).tolist(), (y - origin).tolist(), (z - origin).tolist()]


def load_solid(path: str, filter_num_shapes: int = 1):
    """Read a STEP file -> (solid, num_solids); mirrors read_step_file's
    contract (occ_pipeline.py:56-91): None when over the shape cap."""
    solids = step21.read_brep(path)
    if not solids:
        raise AssertionError("no shape to transfer")
    if len(solids) > filter_num_shapes:
        return None, len(solids)
    return solids[0], len(solids)
