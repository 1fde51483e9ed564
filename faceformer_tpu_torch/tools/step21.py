"""Native STEP (ISO-10303-21) reader/writer for plane/cylinder/cone B-Reps.

A copy of faceformer_tpu/tools/step21.py with its imports renamed to
the port's modules: the same inputs write the same files.

The reference reads ABC STEP files through OpenCascade
(dataset/utils/read_step_file.py:9-55) — a dependency this environment
cannot provide. This module implements the subset of AP203/AP214 geometry
the FaceFormer data pipeline actually consumes, entirely in Python/numpy:

  - a full Part 21 tokenizer/parser (entity instances, nested aggregates,
    typed sub-instances, complex/multi-supertype instances, string escapes);
  - resolution of MANIFOLD_SOLID_BREP topology into plain record objects:
    faces (PLANE / CYLINDRICAL_SURFACE / CONICAL_SURFACE) bounded by
    ordered oriented edge loops over LINE / CIRCLE edge curves;
  - a writer emitting the same dialect, used by the synthetic STEP corpus
    generator so the whole STEP -> JSON pipeline is exercisable end-to-end
    without OCC (tools/prepare_data.py --backend native).

Surfaces/curves outside this subset (B-splines, spheres, tori) raise
UnsupportedStep with a pointer at the optional OCC backend — the same
division the reference draws between "solids the paper's data covers" and
everything else (its length filter caps edges at 64 and its own HLR only
ever needs plane/cylinder/cone silhouettes on the filtered corpus).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class UnsupportedStep(Exception):
    """Geometry outside the native subset (use the OCC backend)."""


class StepSyntaxError(Exception):
    pass


# ---------------------------------------------------------------------------
# Part 21 parsing
# ---------------------------------------------------------------------------

STAR = object()  # the '*' placeholder token


class Ref(int):
    """An entity reference (#n)."""

    def __repr__(self):  # pragma: no cover - debug aid
        return f"#{int(self)}"


@dataclass
class Typed:
    """A typed instance: NAME(args). Complex instances use name '&'
    with a list of Typed parts as args."""

    name: str
    args: list


_TOKEN = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>/\*.*?\*/)
  | (?P<ref>\#\d+)
  | (?P<num>[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<enum>\.[A-Za-z0-9_]+\.)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[()=,;$*])
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str):
    pos, n = 0, len(text)
    while pos < n:
        m = _TOKEN.match(text, pos)
        if m is None:
            raise StepSyntaxError(f"bad token at byte {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()


#: aggregate-nesting cap: real Part 21 exports nest a handful of levels;
#: untrusted files can nest arbitrarily and would otherwise convert a
#: hostile byte stream into an uncatchable RecursionError inside value()
_MAX_DEPTH = 64

#: per-aggregate element cap: the largest legitimate aggregates this
#: subset reads are B-spline control rows / knot lists (hundreds); a
#: flat list with 10^5+ elements is a resource-exhaustion payload, and
#: bounding it here (on a LAZY token stream — tokens are produced on
#: demand, so the reject lands before the tail is even lexed) keeps
#: hostile multi-megabyte entities from burning seconds pre-rejection
_MAX_AGG_ITEMS = 65536


class _Parser:
    def __init__(self, tokens):
        self._toks = iter(tokens)
        self._pushback = []
        self.depth = 0

    def peek(self):
        if not self._pushback:
            self._pushback.append(next(self._toks, (None, None)))
        return self._pushback[-1]

    def next(self):
        if self._pushback:
            return self._pushback.pop()
        return next(self._toks, (None, None))

    def push(self, tok):
        self._pushback.append(tok)

    def expect(self, value):
        kind, val = self.next()
        if val != value:
            raise StepSyntaxError(f"expected {value!r}, got {val!r}")

    def value(self):
        kind, val = self.next()
        if kind == "ref":
            return Ref(int(val[1:]))
        if kind == "num":
            f = float(val)
            return int(f) if re.fullmatch(r"[+-]?\d+", val) else f
        if kind == "str":
            return val[1:-1].replace("''", "'")
        if kind == "enum":
            return val  # '.T.' / '.F.' / '.UNSPECIFIED.' etc.
        if kind == "punct" and val == "$":
            return None
        if kind == "punct" and val == "*":
            return STAR
        if kind == "punct" and val == "(":
            self.depth += 1
            if self.depth > _MAX_DEPTH:
                raise StepSyntaxError(
                    f"aggregate nesting exceeds {_MAX_DEPTH} levels")
            try:
                items = []
                if self.peek()[1] == ")":
                    self.next()
                    return items
                while True:
                    items.append(self.value())
                    if len(items) > _MAX_AGG_ITEMS:
                        raise StepSyntaxError(
                            f"aggregate exceeds {_MAX_AGG_ITEMS} elements")
                    kind, val = self.next()
                    if val == ")":
                        return items
                    if val != ",":
                        raise StepSyntaxError(
                            f"expected , or ) got {val!r}")
            finally:
                self.depth -= 1
        if kind == "ident":
            # typed sub-instance NAME(args)
            name = val.upper()
            self.expect("(")
            self.push(("punct", "("))  # re-read the '(' as an aggregate
            args = self.value()
            return Typed(name, args)
        raise StepSyntaxError(f"unexpected token {val!r}")

    def instance_body(self):
        """After '#n =': either TYPE(...) or a complex '( T1() T2() ... )'."""
        kind, val = self.peek()
        if kind == "punct" and val == "(":
            self.next()
            parts = []
            while self.peek()[1] != ")":
                part = self.value()
                if not isinstance(part, Typed):
                    raise StepSyntaxError("complex instance part is not typed")
                parts.append(part)
            self.next()  # ')'
            return Typed("&", parts)
        body = self.value()
        if not isinstance(body, Typed):
            raise StepSyntaxError("instance body is not typed")
        return body


def parse_step_text(text: str) -> Dict[int, Typed]:
    """Parse the DATA section into {id: Typed}. Header is skipped."""
    start = text.find("DATA;")
    if start < 0:
        raise StepSyntaxError("no DATA section")
    end = text.find("ENDSEC;", start)
    if end < 0:
        raise StepSyntaxError("DATA section not closed")
    parser = _Parser(_tokenize(text[start + 5:end]))
    entities: Dict[int, Typed] = {}
    while parser.peek()[0] is not None:
        kind, val = parser.next()
        if kind != "ref":
            raise StepSyntaxError(f"expected #id, got {val!r}")
        ident = int(val[1:])
        parser.expect("=")
        entities[ident] = parser.instance_body()
        parser.expect(";")
    return entities


def parse_step_file(path: str, max_bytes: int = 64 * 1024 * 1024) -> Dict[int, Typed]:
    size = os.path.getsize(path)
    if size > max_bytes:
        raise UnsupportedStep(f"{path}: {size} bytes exceeds the {max_bytes} cap")
    with open(path, "r", errors="replace") as f:
        return parse_step_text(f.read())


# ---------------------------------------------------------------------------
# B-Rep resolution
# ---------------------------------------------------------------------------

# face_type ints follow OCC's GeomAbs enum, which the reference stores
# verbatim (Face.py:18-24): Plane=0, Cylinder=1, Cone=2, Sphere=3, Torus=4,
# BSplineSurface=6, SurfaceOfRevolution=7, SurfaceOfExtrusion=8 (labels
# clamp every type >= 2 to "Other", data_para.py:76-80)
PLANE, CYLINDER, CONE, SPHERE, TORUS = 0, 1, 2, 3, 4
BSPLINE, REVOLUTION, EXTRUSION = 6, 7, 8


@dataclass
class Frame:
    """An AXIS2_PLACEMENT_3D: origin + orthonormal (x, y, z) axes."""

    origin: np.ndarray
    z: np.ndarray
    x: np.ndarray

    @property
    def y(self) -> np.ndarray:
        return np.cross(self.z, self.x)


@dataclass(eq=False)
class BVertex:
    point: np.ndarray


@dataclass(eq=False)
class BCurve:
    kind: str  # 'line' | 'circle' | 'poly' | 'bspline' | 'rational_deriv'
    # line: point + unit direction; circle: frame + radius;
    # poly: sampled 3D polyline ``points`` (N,3) — the representation of
    # non-circular silhouette curves (a torus outline is a quartic; OCC's
    # HLR hands these over as discretized outline edges too);
    # bspline: B-spline ``ctrl`` (N,3) control points with the FULL
    # (multiplicity-expanded) ``knots`` vector and ``degree``; rational
    # (NURBS) curves additionally carry per-control-point ``weights`` (N,)
    # and evaluate through homogeneous de Boor;
    # rational_deriv: the derivative of a rational curve (not itself a
    # B-spline) — ``ctrl`` holds the BASE curve's homogeneous (N,4)
    # control net and evaluation applies the quotient rule
    point: Optional[np.ndarray] = None
    direction: Optional[np.ndarray] = None
    frame: Optional[Frame] = None
    radius: float = 0.0
    points: Optional[np.ndarray] = None
    ctrl: Optional[np.ndarray] = None
    knots: Optional[np.ndarray] = None
    degree: int = 0
    weights: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# non-rational B-spline evaluation (the curve/surface geometry OCC's
# Geom_BSplineCurve/Surface provide to the reference pipeline)
# ---------------------------------------------------------------------------


def expand_knots(knots, mults) -> np.ndarray:
    """Full (repeated) knot vector from STEP's (knots, multiplicities)."""
    return np.repeat(np.asarray(knots, dtype=float),
                     np.asarray(mults, dtype=int))


def bspline_domain(curve: "BCurve") -> Tuple[float, float]:
    """The parameter interval on which the spline is defined."""
    k, p = curve.knots, curve.degree
    return float(k[p]), float(k[len(k) - p - 1])


def bspline_eval_raw(ctrl, knots, p: int, ts) -> np.ndarray:
    """De Boor on a raw (N, dim) control net, vectorized over ``ts``;
    parameters clamp to the knot domain."""
    ctrl = np.asarray(ctrl, dtype=float)
    knots = np.asarray(knots, dtype=float)
    ts = np.atleast_1d(np.asarray(ts, dtype=float))
    ts = np.clip(ts, knots[p], knots[len(knots) - p - 1])
    n = len(ctrl)
    k = np.searchsorted(knots, ts, side="right") - 1
    k = np.clip(k, p, n - 1)
    idx = k[:, None] - p + np.arange(p + 1)[None, :]            # (T, p+1)
    d = ctrl[idx]                                               # (T, p+1, dim)
    for r in range(1, p + 1):
        for j in range(p, r - 1, -1):                           # descending:
            i = k - p + j                                       # d[j-1] is last round's
            den = knots[i + p - r + 1] - knots[i]
            safe = np.where(np.abs(den) > 1e-12, den, 1.0)
            alpha = np.where(np.abs(den) > 1e-12, (ts - knots[i]) / safe, 0.0)
            d[:, j] = ((1.0 - alpha)[:, None] * d[:, j - 1]
                       + alpha[:, None] * d[:, j])
    return d[:, p]


def _homogeneous_ctrl(ctrl, weights) -> np.ndarray:
    """(N, dim) control points + (N,) weights -> (N, dim+1) (wP, w)."""
    w = np.asarray(weights, dtype=float)[:, None]
    return np.concatenate([np.asarray(ctrl, dtype=float) * w, w], axis=1)


def bspline_eval(curve: "BCurve", ts) -> np.ndarray:
    """Points of a B-spline at parameters ``ts`` -> (T, dim) by de Boor's
    algorithm vectorized over the parameter batch. Rational (NURBS) curves
    evaluate in homogeneous coordinates and divide by the weight channel
    (OCC Geom_BSplineCurve semantics); ``rational_deriv`` curves apply the
    quotient rule C' = (A' - C w') / w to the base homogeneous net."""
    if curve.kind == "rational_deriv":
        hom = curve.ctrl  # (N, dim+1) homogeneous net of the BASE curve
        a = bspline_eval_raw(hom, curve.knots, curve.degree, ts)
        qh, kh, ph = _hodograph_raw(hom, curve.knots, curve.degree)
        ad = bspline_eval_raw(qh, kh, ph, ts)
        w, wd = a[:, -1:], ad[:, -1:]
        return (ad[:, :-1] - (a[:, :-1] / w) * wd) / w
    if curve.weights is not None:
        hom = bspline_eval_raw(_homogeneous_ctrl(curve.ctrl, curve.weights),
                               curve.knots, curve.degree, ts)
        return hom[:, :-1] / hom[:, -1:]
    return bspline_eval_raw(curve.ctrl, curve.knots, curve.degree, ts)


def _hodograph_raw(ctrl, knots, p: int):
    """Derivative control net: (ctrl', knots', p-1)."""
    ctrl = np.asarray(ctrl, dtype=float)
    knots = np.asarray(knots, dtype=float)
    den = knots[p + 1:p + len(ctrl)] - knots[1:len(ctrl)]
    safe = np.where(np.abs(den) > 1e-12, den, 1.0)
    shape = (len(den),) + (1,) * (ctrl.ndim - 1)
    q = np.where(np.abs(den).reshape(shape) > 1e-12,
                 p * (ctrl[1:] - ctrl[:-1]) / safe.reshape(shape), 0.0)
    return q, knots[1:-1], p - 1


def bspline_hodograph(curve: "BCurve") -> "BCurve":
    """The derivative curve: degree p-1 over the interior knots for the
    polynomial case; for rational curves, a ``rational_deriv`` curve that
    bspline_eval resolves with the quotient rule (the derivative of a
    NURBS is not itself a B-spline)."""
    if curve.degree < 1:
        raise UnsupportedStep("degree-0 B-spline edge")
    if curve.weights is not None:
        return BCurve("rational_deriv",
                      ctrl=_homogeneous_ctrl(curve.ctrl, curve.weights),
                      knots=np.asarray(curve.knots, dtype=float).copy(),
                      degree=curve.degree)
    q, knots, p = _hodograph_raw(curve.ctrl, curve.knots, curve.degree)
    return BCurve("bspline", ctrl=q, knots=knots, degree=p)


@dataclass(eq=False)
class BPatch:
    """A general (doubly-curved) tensor-product B-spline surface patch:
    grid (nu, nv, 3) with full knot vectors; rational (NURBS) patches
    additionally carry a (nu, nv) ``weights`` grid and evaluate through
    homogeneous de Boor."""

    grid: np.ndarray
    udeg: int
    vdeg: int
    uknots: np.ndarray
    vknots: np.ndarray
    weights: Optional[np.ndarray] = None

    def domain(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        return ((float(self.uknots[self.udeg]),
                 float(self.uknots[len(self.uknots) - self.udeg - 1])),
                (float(self.vknots[self.vdeg]),
                 float(self.vknots[len(self.vknots) - self.vdeg - 1])))

    def hom_grid(self) -> np.ndarray:
        """(nu, nv, 4) homogeneous control grid (wP, w)."""
        w = self.weights[..., None]
        return np.concatenate([self.grid * w, w], axis=2)


@dataclass(eq=False)
class _RationalPartial:
    """dS/du or dS/dv of a rational patch (not itself a B-spline patch);
    patch_eval resolves it with the quotient rule against the base."""

    base: BPatch
    axis: str  # 'u' | 'v'


def _patch_eval_raw(grid, udeg, vdeg, uknots, vknots, uvs) -> np.ndarray:
    """Tensor-product de Boor on a raw (nu, nv, dim) grid: collapse v by
    treating the grid as one v-curve in R^(nu*dim), then de Boor each row
    in u."""
    uvs = np.atleast_2d(np.asarray(uvs, dtype=float))
    nu, nv, dim = grid.shape
    cv = grid.transpose(1, 0, 2).reshape(nv, nu * dim)
    rows = bspline_eval_raw(cv, vknots, vdeg, uvs[:, 1])
    out = np.empty((len(uvs), dim))
    for t in range(len(uvs)):
        out[t] = bspline_eval_raw(rows[t].reshape(nu, dim),
                                  uknots, udeg, [uvs[t, 0]])[0]
    return out


def _patch_hom_partial(patch: BPatch, axis: str, uvs) -> np.ndarray:
    """d/du or d/dv of the HOMOGENEOUS patch at uvs -> (T, 4)."""
    hom = patch.hom_grid()
    if axis == "u":
        gu, uk, up = _hodograph_raw(hom, patch.uknots, patch.udeg)
        return _patch_eval_raw(gu, up, patch.vdeg, uk, patch.vknots, uvs)
    gv, vk, vp = _hodograph_raw(hom.transpose(1, 0, 2),
                                patch.vknots, patch.vdeg)
    return _patch_eval_raw(gv.transpose(1, 0, 2), patch.udeg, vp,
                           patch.uknots, vk, uvs)


def patch_eval(patch, uvs) -> np.ndarray:
    """S(u, v) at (T, 2) parameter pairs -> (T, 3). Accepts a BPatch
    (polynomial or rational) or a _RationalPartial returned by
    patch_partials for a rational patch."""
    if isinstance(patch, _RationalPartial):
        base = patch.base
        a = _patch_eval_raw(base.hom_grid(), base.udeg, base.vdeg,
                            base.uknots, base.vknots, uvs)
        ad = _patch_hom_partial(base, patch.axis, uvs)
        w, wd = a[:, -1:], ad[:, -1:]
        return (ad[:, :-1] - (a[:, :-1] / w) * wd) / w
    if patch.weights is not None:
        hom = _patch_eval_raw(patch.hom_grid(), patch.udeg, patch.vdeg,
                              patch.uknots, patch.vknots, uvs)
        return hom[:, :-1] / hom[:, -1:]
    return _patch_eval_raw(patch.grid, patch.udeg, patch.vdeg,
                           patch.uknots, patch.vknots, uvs)


def patch_partials(patch: BPatch):
    """(dS/du, dS/dv): derivative BPatches for the polynomial case, or
    quotient-rule _RationalPartial handles for rational patches — either
    way, objects patch_eval evaluates."""
    if patch.weights is not None:
        return _RationalPartial(patch, "u"), _RationalPartial(patch, "v")
    gu, uk, up = _hodograph_raw(patch.grid, patch.uknots, patch.udeg)
    su = BPatch(gu, up, patch.vdeg, uk, patch.vknots)
    gv, vk, vp = _hodograph_raw(patch.grid.transpose(1, 0, 2),
                                patch.vknots, patch.vdeg)
    sv = BPatch(gv.transpose(1, 0, 2), patch.udeg, vp, patch.uknots, vk)
    return su, sv


def patch_boundary_curve(patch: BPatch, side: str) -> "BCurve":
    """The iso-parameter boundary curve: side in u0/u1 (v-curves at the u
    ends) or v0/v1 (u-curves at the v ends). Rational patches hand their
    boundary weights to the curve."""
    if side in ("u0", "u1"):
        i = 0 if side == "u0" else -1
        w = None if patch.weights is None else patch.weights[i].copy()
        return BCurve("bspline", ctrl=patch.grid[i].copy(),
                      knots=patch.vknots.copy(), degree=patch.vdeg,
                      weights=w)
    i = 0 if side == "v0" else -1
    w = None if patch.weights is None else patch.weights[:, i].copy()
    return BCurve("bspline", ctrl=patch.grid[:, i].copy(),
                  knots=patch.uknots.copy(), degree=patch.udeg, weights=w)


def bspline_reversed(curve: "BCurve") -> "BCurve":
    """The same point set traversed in the opposite direction; the knot
    vector mirrors over its own span so the domain is preserved."""
    knots = np.asarray(curve.knots, dtype=float)
    lo, hi = float(knots[0]), float(knots[-1])
    w = None if curve.weights is None else np.asarray(curve.weights)[::-1].copy()
    return BCurve("bspline", ctrl=np.asarray(curve.ctrl)[::-1].copy(),
                  knots=(lo + hi) - knots[::-1], degree=curve.degree,
                  weights=w)


def _recognize_circle(curve: "BCurve", tol: float = 1e-7) -> Optional["BCurve"]:
    """Exact-circle recognition for rational B-spline curves. Real CAD
    exporters encode circles and fillet arcs as rational quadratic NURBS
    (the representation the reference receives back as Geom_Circle through
    OCC's shape analysis); detecting them geometrically and returning the
    analytic circle routes the edge through the SAME downstream silhouette
    and discretization machinery as native CIRCLE entities. Returns None
    when the sampled curve is not circular to within ``tol`` relative
    error (rational circles are exact, so the fit residual is pure
    floating-point noise; no polynomial B-spline is ever exactly
    circular, which keeps recognition conservative)."""
    lo, hi = bspline_domain(curve)
    ts = np.linspace(lo, hi, 65)
    pts = bspline_eval(curve, ts)
    centroid = pts.mean(axis=0)
    q = pts - centroid
    scale = max(float(np.max(np.abs(q))), 1e-12)
    # plane through the samples (total least squares)
    _, sv, vt = np.linalg.svd(q, full_matrices=False)
    if float(sv[2]) > tol * scale * len(pts) ** 0.5:
        return None
    xh, yh = vt[0], vt[1]
    normal = np.cross(xh, yh)  # right-handed with the in-plane basis
    u, v = q @ xh, q @ yh
    # |p - c|^2 = r^2  ->  2*u*cx + 2*v*cy + k = u^2 + v^2 (linear lsq)
    a = np.stack([2 * u, 2 * v, np.ones_like(u)], axis=1)
    rhs = u * u + v * v
    (cx, cy, k), *_ = np.linalg.lstsq(a, rhs, rcond=None)
    r2 = k + cx * cx + cy * cy
    if r2 <= (tol * scale) ** 2:
        return None
    r = float(np.sqrt(r2))
    dist = np.sqrt((u - cx) ** 2 + (v - cy) ** 2)
    if float(np.max(np.abs(dist - r))) > tol * r:
        return None
    center = centroid + cx * xh + cy * yh
    # traversal orientation: angles must progress monotonically CCW
    # around the returned frame's z (flip the normal when the samples
    # run clockwise)
    ang = np.unwrap(np.arctan2(v - cy, u - cx))
    d_ang = np.diff(ang)
    if np.all(d_ang > 0):
        z = normal
    elif np.all(d_ang < 0):
        z = -normal
    else:
        return None
    start = pts[0] - center
    nrm = float(np.linalg.norm(start))
    if nrm < tol * r:
        return None
    return BCurve("circle", frame=Frame(center, z, start / nrm), radius=r)


@dataclass(eq=False)
class BEdge:
    """An EDGE_CURVE. Natural direction is v0 -> v1 (same_sense already
    folded into the stored curve parametrization at resolution time).
    ``arc_span`` is the circle parameter interval (t0, t1), t1 > t0,
    traversed t0 -> t1 in the natural direction; None until computed
    (parsed edges) or set explicitly (sub-arcs created by splitting).
    For bspline curves the same field restricts the evaluated parameter
    span (None = the curve's full domain)."""

    v0: BVertex
    v1: BVertex
    curve: BCurve
    eid: int = 0
    arc_span: Optional[Tuple[float, float]] = None


@dataclass(eq=False)
class BFace:
    """An ADVANCED_FACE: surface + loops of (edge, reversed?) pairs.
    Bound orientation and ORIENTED_EDGE orientation are folded in, so a
    loop is the face's actual ordered boundary walk."""

    surface_kind: int  # PLANE/CYLINDER/CONE/SPHERE/TORUS/BSPLINE/EXTRUSION
    frame: Frame
    radius: float  # cylinder/cone station radius; sphere/torus major radius
    semi_angle: float  # cone only
    same_sense: bool
    loops: List[List[Tuple[BEdge, int]]]
    fid: int = 0
    radius2: float = 0.0  # torus only: minor (tube) radius
    # BSPLINE/EXTRUSION only: the face is profile(u) + t * extrude — a
    # B_SPLINE_SURFACE_WITH_KNOTS that is linear in v, or a
    # SURFACE_OF_LINEAR_EXTRUSION over a B-spline profile;
    # REVOLUTION: profile is the meridian curve (extrude None);
    # general (doubly-curved) BSPLINE faces carry ``patch`` instead
    profile: Optional[BCurve] = None
    extrude: Optional[np.ndarray] = None
    patch: Optional[BPatch] = None


@dataclass(eq=False)
class BSolid:
    faces: List[BFace]

    def edges(self) -> List[BEdge]:
        seen, out = set(), []
        for face in self.faces:
            for loop in face.loops:
                for edge, _ in loop:
                    if id(edge) not in seen:
                        seen.add(id(edge))
                        out.append(edge)
        return out


def _unit(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    if n < 1e-12:
        raise UnsupportedStep("degenerate direction")
    return v / n


def _extrusion_frame(origin, delta) -> Frame:
    """Synthesized face frame for a linear-extrusion surface: z along the
    extrusion direction (only profile/extrude carry real geometry)."""
    z = _unit(np.asarray(delta, dtype=float))
    seed = np.array([1.0, 0.0, 0.0])
    if abs(float(seed @ z)) > 0.9:
        seed = np.array([0.0, 1.0, 0.0])
    return Frame(np.asarray(origin, dtype=float).copy(), z,
                 _unit(seed - z * float(seed @ z)))


class _Resolver:
    def __init__(self, entities: Dict[int, Typed]):
        self.ents = entities
        self.cache: Dict[int, object] = {}

    def get(self, ref) -> Typed:
        ent = self.ents.get(int(ref))
        if ent is None:
            raise StepSyntaxError(f"dangling reference #{int(ref)}")
        return ent

    # -- geometry -------------------------------------------------------

    def point(self, ref) -> np.ndarray:
        ent = self.get(ref)
        if ent.name != "CARTESIAN_POINT":
            raise UnsupportedStep(f"expected CARTESIAN_POINT, got {ent.name}")
        return np.asarray(ent.args[1], dtype=float)

    def direction(self, ref) -> np.ndarray:
        ent = self.get(ref)
        if ent.name != "DIRECTION":
            raise UnsupportedStep(f"expected DIRECTION, got {ent.name}")
        return _unit(np.asarray(ent.args[1], dtype=float))

    def frame(self, ref) -> Frame:
        if int(ref) in self.cache:
            return self.cache[int(ref)]
        ent = self.get(ref)
        if ent.name != "AXIS2_PLACEMENT_3D":
            raise UnsupportedStep(f"expected AXIS2_PLACEMENT_3D, got {ent.name}")
        _, loc, axis, refdir = ent.args
        origin = self.point(loc)
        z = self.direction(axis) if axis is not None else np.array([0.0, 0.0, 1.0])
        if refdir is not None:
            x = self.direction(refdir)
            x = _unit(x - z * float(x @ z))  # Gram-Schmidt (STEP requires non-parallel)
        else:  # STEP default: any direction not parallel to z
            seed = np.array([1.0, 0.0, 0.0])
            if abs(float(seed @ z)) > 0.9:
                seed = np.array([0.0, 1.0, 0.0])
            x = _unit(seed - z * float(seed @ z))
        out = Frame(origin, z, x)
        self.cache[int(ref)] = out
        return out

    def curve(self, ref) -> BCurve:
        if int(ref) in self.cache:
            return self.cache[int(ref)]
        ent = self.get(ref)
        if ent.name == "LINE":
            _, pnt, vec = ent.args
            v = self.get(vec)
            if v.name != "VECTOR":
                raise UnsupportedStep(f"LINE direction is {v.name}")
            out = BCurve("line", point=self.point(pnt),
                         direction=self.direction(v.args[1]))
        elif ent.name == "CIRCLE":
            _, placement, radius = ent.args
            out = BCurve("circle", frame=self.frame(placement),
                         radius=float(radius))
        elif ent.name == "B_SPLINE_CURVE_WITH_KNOTS":
            _, degree, ctrl_refs, _form, _closed, _selfint, mults, knots, _spec = ent.args
            ctrl = np.stack([self.point(r) for r in ctrl_refs])
            full = expand_knots(knots, mults)
            if len(full) != len(ctrl) + int(degree) + 1:
                raise UnsupportedStep("inconsistent B-spline knot vector")
            out = BCurve("bspline", ctrl=ctrl, knots=full, degree=int(degree))
        elif ent.name == "&":
            # complex instance: the Part 21 encoding of rational (NURBS)
            # curves — B_SPLINE_CURVE carries degree+control points,
            # B_SPLINE_CURVE_WITH_KNOTS the knots, RATIONAL_B_SPLINE_CURVE
            # the weights. Real ABC exports encode circles/fillets this
            # way (reference reads them via OCC, read_step_file.py:9).
            parts = {p.name: p for p in ent.args}
            names = [p.name for p in ent.args]
            if not {"B_SPLINE_CURVE", "B_SPLINE_CURVE_WITH_KNOTS",
                    "RATIONAL_B_SPLINE_CURVE"} <= set(parts):
                raise UnsupportedStep(
                    f"complex edge curve ({'+'.join(names)}) is outside "
                    "the native subset; use the OCC backend")
            degree = int(parts["B_SPLINE_CURVE"].args[0])
            ctrl = np.stack([self.point(r)
                             for r in parts["B_SPLINE_CURVE"].args[1]])
            mults, knots = parts["B_SPLINE_CURVE_WITH_KNOTS"].args[:2]
            full = expand_knots(knots, mults)
            if len(full) != len(ctrl) + degree + 1:
                raise UnsupportedStep("inconsistent B-spline knot vector")
            wts = np.asarray(parts["RATIONAL_B_SPLINE_CURVE"].args[0],
                             dtype=float)
            if len(wts) != len(ctrl) or np.any(wts <= 0):
                raise UnsupportedStep("malformed rational B-spline weights")
            if float(np.max(wts) - np.min(wts)) < 1e-12:
                # uniform weights divide out: plain polynomial B-spline
                out = BCurve("bspline", ctrl=ctrl, knots=full, degree=degree)
            else:
                out = BCurve("bspline", ctrl=ctrl, knots=full,
                             degree=degree, weights=wts)
                circ = _recognize_circle(out)
                if circ is not None:
                    out = circ
        else:
            raise UnsupportedStep(
                f"edge curve {ent.name} is outside the native subset "
                "(LINE/CIRCLE/B_SPLINE_CURVE_WITH_KNOTS); use the OCC backend")
        self.cache[int(ref)] = out
        return out

    # -- topology -------------------------------------------------------

    def vertex(self, ref) -> BVertex:
        if int(ref) in self.cache:
            return self.cache[int(ref)]
        ent = self.get(ref)
        if ent.name != "VERTEX_POINT":
            raise UnsupportedStep(f"expected VERTEX_POINT, got {ent.name}")
        out = BVertex(self.point(ent.args[1]))
        self.cache[int(ref)] = out
        return out

    def edge(self, ref) -> BEdge:
        if int(ref) in self.cache:
            return self.cache[int(ref)]
        ent = self.get(ref)
        if ent.name != "EDGE_CURVE":
            raise UnsupportedStep(f"expected EDGE_CURVE, got {ent.name}")
        _, v0, v1, curve, same_sense = ent.args
        out = BEdge(self.vertex(v0), self.vertex(v1), self.curve(curve),
                    eid=int(ref))
        if same_sense in (".F.", False):
            # fold the sense flip into the stored curve so natural direction
            # is always v0 -> v1
            c = out.curve
            if c.kind == "line":
                out.curve = BCurve("line", point=c.point, direction=-c.direction)
            elif c.kind == "bspline":
                out.curve = bspline_reversed(c)
            else:
                flipped = Frame(c.frame.origin, -c.frame.z, c.frame.x)
                out.curve = BCurve("circle", frame=flipped, radius=c.radius)
        if out.curve.kind == "bspline":
            # the native subset keeps edges spanning the whole (clamped)
            # curve; vertices off the curve ends would need trim-parameter
            # recovery (OCC BRep_Tool::Range territory)
            ends = bspline_eval(out.curve, list(bspline_domain(out.curve)))
            if (float(np.max(np.abs(ends[0] - out.v0.point))) > 1e-6
                    or float(np.max(np.abs(ends[1] - out.v1.point))) > 1e-6):
                raise UnsupportedStep(
                    "trimmed B-spline edge (vertices off the curve ends) is "
                    "outside the native subset; use the OCC backend")
        self.cache[int(ref)] = out
        return out

    def loop(self, bound_ref) -> List[Tuple[BEdge, int]]:
        bound = self.get(bound_ref)
        if bound.name not in ("FACE_OUTER_BOUND", "FACE_BOUND"):
            raise UnsupportedStep(f"expected FACE_BOUND, got {bound.name}")
        _, loop_ref, orientation = bound.args
        loop_ent = self.get(loop_ref)
        if loop_ent.name != "EDGE_LOOP":
            raise UnsupportedStep(f"expected EDGE_LOOP, got {loop_ent.name}")
        pairs: List[Tuple[BEdge, int]] = []
        for oe_ref in loop_ent.args[1]:
            oe = self.get(oe_ref)
            if oe.name != "ORIENTED_EDGE":
                raise UnsupportedStep(f"expected ORIENTED_EDGE, got {oe.name}")
            _, _, _, edge_ref, flag = oe.args
            pairs.append((self.edge(edge_ref), 0 if flag in (".T.", True) else 1))
        if orientation in (".F.", False):
            pairs = [(e, 1 - o) for e, o in pairs[::-1]]
        return pairs

    def _bspline_grid_face(self, u_deg: int, v_deg: int, grid: np.ndarray,
                           u_knots, u_mults, v_knots, v_mults,
                           weights: Optional[np.ndarray]):
        """Shared resolution of a (possibly rational) B-spline surface
        control grid -> (kind, frame, profile_or_patch, extrude, radius).
        An extrusion grid (one direction linear with a constant delta and
        constant weights along it) resolves to its swept profile; a
        rational profile that recognizes as a circle swept along its own
        axis resolves all the way to an analytic CYLINDER (the encoding
        real exporters emit for cylindrical blends); anything else is a
        general patch for the numeric silhouette splitter."""
        u_deg, v_deg = int(u_deg), int(v_deg)
        full_u = expand_knots(u_knots, u_mults)
        full_v = expand_knots(v_knots, v_mults)
        if (len(full_u) != grid.shape[0] + u_deg + 1
                or len(full_v) != grid.shape[1] + v_deg + 1):
            raise UnsupportedStep("inconsistent B-spline surface knots")
        for axis in (1, 0):  # profile along u (v linear), then flipped
            g = grid if axis == 1 else np.swapaxes(grid, 0, 1)
            wg = None if weights is None else \
                (weights if axis == 1 else weights.T)
            deg = u_deg if axis == 1 else v_deg
            lin_deg = v_deg if axis == 1 else u_deg
            if lin_deg != 1 or g.shape[1] != 2:
                continue
            deltas = g[:, 1] - g[:, 0]
            if float(np.max(np.abs(deltas - deltas[0]))) > 1e-7:
                continue
            if wg is not None and float(np.max(np.abs(wg[:, 1] - wg[:, 0]))) > 1e-12:
                continue
            full = full_u if axis == 1 else full_v
            profile = BCurve("bspline", ctrl=g[:, 0].copy(), knots=full,
                             degree=deg,
                             weights=None if wg is None else wg[:, 0].copy())
            delta = deltas[0].copy()
            if profile.weights is not None:
                circ = _recognize_circle(profile)
                if circ is not None:
                    if float(np.linalg.norm(np.cross(
                            _unit(delta), circ.frame.z))) > 1e-7:
                        raise UnsupportedStep(
                            "oblique sweep of a rational circle (an "
                            "elliptic cylinder) is outside the native "
                            "subset; use the OCC backend")
                    return CYLINDER, circ.frame, None, None, circ.radius
            return BSPLINE, _extrusion_frame(g[0, 0], delta), \
                profile, delta, 0.0
        # general doubly-curved patch: resolved with the full grid
        patch = BPatch(grid, u_deg, v_deg, full_u, full_v, weights=weights)
        n = np.cross(grid[-1, 0] - grid[0, 0], grid[0, -1] - grid[0, 0])
        if float(np.linalg.norm(n)) < 1e-9:  # frame is decorative
            n = np.array([0.0, 0.0, 1.0])
        return BSPLINE, _extrusion_frame(grid[0, 0], n), patch, None, 0.0

    def _extrusion_face(self, surf):
        """Resolve a linear-extrusion freeform surface: (kind, frame,
        profile_or_patch, extrude, radius). The frame is synthesized
        (origin = first control point, z = extrusion direction) —
        downstream only profile/extrude carry geometry; the reference
        reads these surfaces through OCC adaptors (TopoMapper.py:38-43
        outlines on any surface type)."""
        if surf.name == "B_SPLINE_SURFACE_WITH_KNOTS":
            (_, u_deg, v_deg, grid_refs, _form, _ucl, _vcl, _selfint,
             u_mults, v_mults, u_knots, v_knots, _spec) = surf.args
            grid = np.stack([np.stack([self.point(r) for r in row])
                             for row in grid_refs])  # (nu, nv, 3)
            return self._bspline_grid_face(u_deg, v_deg, grid, u_knots,
                                           u_mults, v_knots, v_mults, None)
        # SURFACE_OF_LINEAR_EXTRUSION('', swept_curve, extrusion VECTOR)
        _, curve_ref, vec_ref = surf.args
        profile = self.curve(curve_ref)
        v = self.get(vec_ref)
        if v.name != "VECTOR":
            raise UnsupportedStep(f"extrusion axis is {v.name}")
        delta = self.direction(v.args[1]) * float(v.args[2])
        if profile.kind == "circle":
            # a rational-NURBS circle profile recognized upstream: the
            # sweep is an analytic cylinder when the axis matches
            if float(np.linalg.norm(np.cross(
                    _unit(delta), profile.frame.z))) > 1e-7:
                raise UnsupportedStep(
                    "oblique sweep of a circle profile (an elliptic "
                    "cylinder) is outside the native subset; use the "
                    "OCC backend")
            return CYLINDER, profile.frame, None, None, profile.radius
        if profile.kind != "bspline":
            raise UnsupportedStep(
                f"SURFACE_OF_LINEAR_EXTRUSION over a {profile.kind} profile "
                "is outside the native subset (line sweeps arrive as "
                "PLANE); use the OCC backend")
        return EXTRUSION, _extrusion_frame(profile.ctrl[0], delta), \
            profile, delta, 0.0

    def _rational_surface_face(self, surf):
        """Resolve a complex-instance rational B-spline surface
        (B_SPLINE_SURFACE + B_SPLINE_SURFACE_WITH_KNOTS +
        RATIONAL_B_SPLINE_SURFACE parts) -> the same 5-tuple as
        _bspline_grid_face. Uniform weights divide out to the polynomial
        path; cylinders are recognized; general rational patches march
        through the numeric silhouette splitter unchanged (patch_eval and
        patch_partials are weight-aware)."""
        parts = {p.name: p for p in surf.args}
        bs = parts["B_SPLINE_SURFACE"].args
        u_deg, v_deg, grid_refs = int(bs[0]), int(bs[1]), bs[2]
        u_mults, v_mults, u_knots, v_knots = \
            parts["B_SPLINE_SURFACE_WITH_KNOTS"].args[:4]
        grid = np.stack([np.stack([self.point(r) for r in row])
                         for row in grid_refs])  # (nu, nv, 3)
        wts = np.asarray(parts["RATIONAL_B_SPLINE_SURFACE"].args[0],
                         dtype=float)
        if wts.shape != grid.shape[:2] or np.any(wts <= 0):
            raise UnsupportedStep("malformed rational B-spline surface "
                                  "weights")
        if float(np.max(wts) - np.min(wts)) < 1e-12:
            wts = None  # uniform weights divide out
        return self._bspline_grid_face(u_deg, v_deg, grid, u_knots,
                                       u_mults, v_knots, v_mults, wts)

    def _revolution_face(self, surf) -> Tuple[int, Frame, BCurve]:
        """Resolve a SURFACE_OF_REVOLUTION over a B-spline meridian profile:
        (kind, frame, profile). The frame's z is the revolution axis and x
        points through the profile's meridian half-plane, so the profile's
        (radius, height) coordinates are its (x, z) projections. Line/circle
        sweeps arrive as the quadric surface entities instead; profiles off
        a single meridian plane, touching the axis, or rational raise
        toward the OCC backend (reference reads any revolution through the
        OCC adaptor, TopoMapper.py:38-43)."""
        _, curve_ref, axis_ref = surf.args
        profile = self.curve(curve_ref)
        if profile.kind != "bspline":
            raise UnsupportedStep(
                f"SURFACE_OF_REVOLUTION over a {profile.kind} profile is "
                "outside the native subset; use the OCC backend")
        ax = self.get(axis_ref)
        if ax.name != "AXIS1_PLACEMENT":
            raise UnsupportedStep(f"revolution axis is {ax.name}")
        origin = self.point(ax.args[1])
        zdir = (self.direction(ax.args[2]) if ax.args[2] is not None
                else np.array([0.0, 0.0, 1.0]))
        q = profile.ctrl[0] - origin
        q = q - zdir * float(q @ zdir)
        frame = Frame(origin.copy(), zdir, _unit(q))
        y = frame.y
        for p in profile.ctrl:
            d = p - origin
            if abs(float(d @ y)) > 1e-7:
                raise UnsupportedStep(
                    "revolution profile off its meridian plane; use the "
                    "OCC backend")
            if float(d @ frame.x) < 1e-6:
                raise UnsupportedStep(
                    "revolution profile touches the axis (control point "
                    "radius <= 0); use the OCC backend")
        return REVOLUTION, frame, profile

    def face(self, ref) -> BFace:
        ent = self.get(ref)
        if ent.name not in ("ADVANCED_FACE", "FACE_SURFACE"):
            raise UnsupportedStep(f"expected ADVANCED_FACE, got {ent.name}")
        _, bounds, surf_ref, same_sense = ent.args
        surf = self.get(surf_ref)
        semi_angle = 0.0
        profile, extrude, patch = None, None, None
        if surf.name == "PLANE":
            kind, frame, radius = PLANE, self.frame(surf.args[1]), 0.0
        elif surf.name == "CYLINDRICAL_SURFACE":
            kind, frame, radius = CYLINDER, self.frame(surf.args[1]), float(surf.args[2])
        elif surf.name == "CONICAL_SURFACE":
            kind, frame, radius = CONE, self.frame(surf.args[1]), float(surf.args[2])
            semi_angle = float(surf.args[3])
        elif surf.name == "SPHERICAL_SURFACE":
            kind, frame, radius = SPHERE, self.frame(surf.args[1]), float(surf.args[2])
        elif surf.name == "TOROIDAL_SURFACE":
            if len(surf.args) < 4:
                raise UnsupportedStep("malformed TOROIDAL_SURFACE entity")
            kind, frame, radius = TORUS, self.frame(surf.args[1]), float(surf.args[2])
            radius2 = float(surf.args[3])
            if not 0.0 < radius2 < radius:
                raise UnsupportedStep(
                    "only ring tori (0 < minor < major) are in the native "
                    "subset; use the OCC backend")
        elif surf.name in ("B_SPLINE_SURFACE_WITH_KNOTS",
                           "SURFACE_OF_LINEAR_EXTRUSION"):
            kind, frame, prof_or_patch, extrude, radius = \
                self._extrusion_face(surf)
            if isinstance(prof_or_patch, BPatch):
                patch = prof_or_patch
            else:
                profile = prof_or_patch
        elif surf.name == "SURFACE_OF_REVOLUTION":
            kind, frame, profile = self._revolution_face(surf)
            radius = 0.0
        elif surf.name == "&":
            names = [p.name for p in surf.args]
            if {"B_SPLINE_SURFACE", "B_SPLINE_SURFACE_WITH_KNOTS",
                    "RATIONAL_B_SPLINE_SURFACE"} <= set(names):
                kind, frame, prof_or_patch, extrude, radius = \
                    self._rational_surface_face(surf)
                if isinstance(prof_or_patch, BPatch):
                    patch = prof_or_patch
                else:
                    profile = prof_or_patch
            else:
                raise UnsupportedStep(
                    f"complex surface instance ({'+'.join(names)}) is "
                    "outside the native subset; use the OCC backend")
        else:
            raise UnsupportedStep(
                f"surface {surf.name} is outside the native subset "
                "(PLANE/CYLINDRICAL_SURFACE/CONICAL_SURFACE/SPHERICAL_SURFACE/"
                "TOROIDAL_SURFACE/B_SPLINE_SURFACE_WITH_KNOTS/"
                "SURFACE_OF_LINEAR_EXTRUSION); use the OCC backend")
        loops = [self.loop(b) for b in bounds]
        return BFace(kind, frame, radius, semi_angle,
                     same_sense in (".T.", True), loops, fid=int(ref),
                     radius2=radius2 if surf.name == "TOROIDAL_SURFACE" else 0.0,
                     profile=profile, extrude=extrude, patch=patch)

    def solids(self) -> List[BSolid]:
        out = []
        for ident, ent in sorted(self.ents.items()):
            if ent.name in ("MANIFOLD_SOLID_BREP", "BREP_WITH_VOIDS"):
                shells = [ent.args[1]] + (list(ent.args[2]) if ent.name == "BREP_WITH_VOIDS" else [])
                faces: List[BFace] = []
                for shell_ref in shells:
                    shell = self.get(shell_ref)
                    if shell.name not in ("CLOSED_SHELL", "OPEN_SHELL",
                                          "ORIENTED_CLOSED_SHELL"):
                        raise UnsupportedStep(f"unexpected shell {shell.name}")
                    if shell.name == "ORIENTED_CLOSED_SHELL":
                        shell = self.get(shell.args[2])
                    faces.extend(self.face(f) for f in shell.args[1])
                out.append(BSolid(faces))
        return out


def read_brep(path: str) -> List[BSolid]:
    """Parse a STEP file and resolve every MANIFOLD_SOLID_BREP.

    This is the untrusted-input boundary (reference posture: the 5 s
    watchdog around OCC's reader, read_step_file.py:9): a malformed
    entity graph — dangling/retyped refs, wrong arities, degenerate
    numbers — must surface as a typed parse error, never as a raw
    KeyError/IndexError/etc. from resolver internals. The original
    exception stays chained for debugging."""
    entities = parse_step_file(path)
    try:
        return _Resolver(entities).solids()
    except (UnsupportedStep, StepSyntaxError):
        raise
    except RecursionError as exc:
        raise StepSyntaxError("entity graph recurses beyond the "
                              "resolver's depth budget") from exc
    except (KeyError, IndexError, TypeError, AttributeError, ValueError,
            ZeroDivisionError, FloatingPointError, OverflowError,
            np.linalg.LinAlgError) as exc:
        raise StepSyntaxError(
            f"malformed entity graph ({type(exc).__name__}: "
            f"{str(exc)[:120]})") from exc


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class StepBuilder:
    """Emit a minimal AP203 Part 21 file from geometry callbacks.

    Deduplicates vertices/points by rounded coordinates so shared topology
    (a cap circle and the cylinder wall referencing the SAME edge) round-
    trips as true shared B-Rep entities — which is what makes the parsed
    solid exercise the pipeline's sewn-edge/pairing machinery for real.
    """

    def __init__(self):
        self.rows: List[str] = []
        self._points: Dict[tuple, str] = {}
        self._dirs: Dict[tuple, str] = {}
        self._verts: Dict[tuple, str] = {}
        self._edges: Dict[tuple, str] = {}

    def emit(self, body: str) -> str:
        self.rows.append(body)
        return f"#{len(self.rows)}"

    @staticmethod
    def _fmt(x: float) -> str:
        return f"{float(x):.12g}"

    def point(self, p) -> str:
        key = tuple(round(float(c), 9) for c in p)
        if key not in self._points:
            coords = ",".join(self._fmt(c) for c in p)
            self._points[key] = self.emit(f"CARTESIAN_POINT('',({coords}))")
        return self._points[key]

    def direction(self, d) -> str:
        d = _unit(np.asarray(d, dtype=float))
        key = tuple(round(float(c), 9) for c in d)
        if key not in self._dirs:
            coords = ",".join(self._fmt(c) for c in d)
            self._dirs[key] = self.emit(f"DIRECTION('',({coords}))")
        return self._dirs[key]

    def axis2(self, origin, z, x) -> str:
        return self.emit(
            f"AXIS2_PLACEMENT_3D('',{self.point(origin)},"
            f"{self.direction(z)},{self.direction(x)})")

    def vertex(self, p) -> str:
        key = tuple(round(float(c), 9) for c in p)
        if key not in self._verts:
            self._verts[key] = self.emit(f"VERTEX_POINT('',{self.point(p)})")
        return self._verts[key]

    def line_edge(self, p0, p1) -> str:
        """Shared undirected line edge p0 -> p1 (callers pass a canonical
        direction; traversal direction is set per ORIENTED_EDGE)."""
        key = ("L",) + tuple(round(float(c), 9) for c in np.concatenate([p0, p1]))
        rkey = ("L",) + tuple(round(float(c), 9) for c in np.concatenate([p1, p0]))
        if rkey in self._edges:
            raise ValueError("line edge requested in both directions; "
                             "canonicalize callers")
        if key not in self._edges:
            d = np.asarray(p1, dtype=float) - np.asarray(p0, dtype=float)
            vec = self.emit(f"VECTOR('',{self.direction(d)},{self._fmt(np.linalg.norm(d))})")
            line = self.emit(f"LINE('',{self.point(p0)},{vec})")
            self._edges[key] = self.emit(
                f"EDGE_CURVE('',{self.vertex(p0)},{self.vertex(p1)},{line},.T.)")
        return self._edges[key]

    def circle_edge(self, center, axis, x, radius, p0, p1, tag="") -> str:
        """Arc from p0 to p1 CCW around ``axis``; p0 == p1 = full circle.
        ``tag`` disambiguates equal-endpoint arcs (two halves of one circle)."""
        key = ("C", tag) + tuple(round(float(c), 9)
                                 for c in np.concatenate([center, axis, p0, p1]))
        if key not in self._edges:
            circ = self.emit(
                f"CIRCLE('',{self.axis2(center, axis, x)},{self._fmt(radius)})")
            self._edges[key] = self.emit(
                f"EDGE_CURVE('',{self.vertex(p0)},{self.vertex(p1)},{circ},.T.)")
        return self._edges[key]

    def bspline_curve(self, ctrl, degree: int, knots, mults) -> str:
        """Shared B_SPLINE_CURVE_WITH_KNOTS entity (dedup by control net,
        so a seam edge and the SURFACE_OF_REVOLUTION it bounds reference
        the same curve, as CAD writers do)."""
        ctrl = np.asarray(ctrl, dtype=float)
        key = ("BC",) + tuple(round(float(c), 9) for c in ctrl.ravel())
        if key not in self._edges:
            pts = ",".join(self.point(p) for p in ctrl)
            kstr = ",".join(self._fmt(k) for k in knots)
            mstr = ",".join(str(int(m)) for m in mults)
            self._edges[key] = self.emit(
                f"B_SPLINE_CURVE_WITH_KNOTS('',{int(degree)},({pts}),"
                f".UNSPECIFIED.,.F.,.F.,({mstr}),({kstr}),.UNSPECIFIED.)")
        return self._edges[key]

    def bspline_edge(self, ctrl, degree: int, knots, mults) -> str:
        """Shared edge over a clamped non-rational B-spline (the curve's
        first/last control points are its vertices)."""
        ctrl = np.asarray(ctrl, dtype=float)
        key = ("B",) + tuple(round(float(c), 9) for c in ctrl.ravel())
        if key not in self._edges:
            curve = self.bspline_curve(ctrl, degree, knots, mults)
            self._edges[key] = self.emit(
                f"EDGE_CURVE('',{self.vertex(ctrl[0])},"
                f"{self.vertex(ctrl[-1])},{curve},.T.)")
        return self._edges[key]

    def rational_curve(self, ctrl, weights, degree: int, knots, mults) -> str:
        """Shared rational (NURBS) curve as the Part 21 complex instance
        real CAD exporters emit for circles and fillet arcs:
        B_SPLINE_CURVE + B_SPLINE_CURVE_WITH_KNOTS +
        RATIONAL_B_SPLINE_CURVE parts."""
        ctrl = np.asarray(ctrl, dtype=float)
        weights = np.asarray(weights, dtype=float)
        key = ("RC",) + tuple(round(float(c), 9) for c in ctrl.ravel()) \
            + tuple(round(float(w), 9) for w in weights)
        if key not in self._edges:
            pts = ",".join(self.point(p) for p in ctrl)
            kstr = ",".join(self._fmt(k) for k in knots)
            mstr = ",".join(str(int(m)) for m in mults)
            wstr = ",".join(self._fmt(w) for w in weights)
            self._edges[key] = self.emit(
                "( BOUNDED_CURVE() "
                f"B_SPLINE_CURVE({int(degree)},({pts}),.UNSPECIFIED.,"
                ".F.,.F.) "
                f"B_SPLINE_CURVE_WITH_KNOTS(({mstr}),({kstr}),"
                ".UNSPECIFIED.) CURVE() GEOMETRIC_REPRESENTATION_ITEM() "
                f"RATIONAL_B_SPLINE_CURVE(({wstr})) "
                "REPRESENTATION_ITEM('') )")
        return self._edges[key]

    def rational_edge(self, ctrl, weights, degree: int, knots, mults,
                      tag: str = "") -> str:
        """Shared edge over a clamped rational curve (vertices at the end
        control points; ``tag`` disambiguates equal-endpoint curves such
        as a full NURBS circle at two heights)."""
        ctrl = np.asarray(ctrl, dtype=float)
        key = ("RE", tag) + tuple(round(float(c), 9) for c in ctrl.ravel())
        if key not in self._edges:
            curve = self.rational_curve(ctrl, weights, degree, knots, mults)
            self._edges[key] = self.emit(
                f"EDGE_CURVE('',{self.vertex(ctrl[0])},"
                f"{self.vertex(ctrl[-1])},{curve},.T.)")
        return self._edges[key]

    def rational_surface(self, grid, weights, udeg: int, vdeg: int,
                         uknots, umults, vknots, vmults) -> str:
        """Rational B-spline surface as the complex instance
        (B_SPLINE_SURFACE + B_SPLINE_SURFACE_WITH_KNOTS +
        RATIONAL_B_SPLINE_SURFACE) from a (nu, nv, 3) grid and a (nu, nv)
        weight grid."""
        grid = np.asarray(grid, dtype=float)
        weights = np.asarray(weights, dtype=float)
        rows = ",".join(
            "(" + ",".join(self.point(p) for p in row) + ")" for row in grid)
        wrows = ",".join(
            "(" + ",".join(self._fmt(w) for w in row) + ")"
            for row in weights)
        uk = ",".join(self._fmt(k) for k in uknots)
        vk = ",".join(self._fmt(k) for k in vknots)
        um = ",".join(str(int(m)) for m in umults)
        vm = ",".join(str(int(m)) for m in vmults)
        return self.emit(
            "( BOUNDED_SURFACE() "
            f"B_SPLINE_SURFACE({int(udeg)},{int(vdeg)},({rows}),"
            ".UNSPECIFIED.,.F.,.F.,.F.) "
            f"B_SPLINE_SURFACE_WITH_KNOTS(({um}),({vm}),({uk}),({vk}),"
            ".UNSPECIFIED.) GEOMETRIC_REPRESENTATION_ITEM() "
            f"RATIONAL_B_SPLINE_SURFACE(({wrows})) "
            "REPRESENTATION_ITEM('') SURFACE() )")

    def bspline_patch(self, grid, udeg: int, vdeg: int,
                      uknots, umults, vknots, vmults) -> str:
        """General B_SPLINE_SURFACE_WITH_KNOTS from a (nu, nv, 3) grid."""
        grid = np.asarray(grid, dtype=float)
        rows = ",".join(
            "(" + ",".join(self.point(p) for p in row) + ")" for row in grid)
        uk = ",".join(self._fmt(k) for k in uknots)
        vk = ",".join(self._fmt(k) for k in vknots)
        um = ",".join(str(int(m)) for m in umults)
        vm = ",".join(str(int(m)) for m in vmults)
        return self.emit(
            f"B_SPLINE_SURFACE_WITH_KNOTS('',{int(udeg)},{int(vdeg)},"
            f"({rows}),.UNSPECIFIED.,.F.,.F.,.F.,({um}),({vm}),({uk}),"
            f"({vk}),.UNSPECIFIED.)")

    def revolution(self, ctrl, degree: int, knots, mults,
                   axis_origin, axis_dir) -> str:
        """SURFACE_OF_REVOLUTION of a (clamped) B-spline meridian profile
        around AXIS1_PLACEMENT(origin, dir)."""
        curve = self.bspline_curve(ctrl, degree, knots, mults)
        ax = self.emit(f"AXIS1_PLACEMENT('',{self.point(axis_origin)},"
                       f"{self.direction(axis_dir)})")
        return self.emit(f"SURFACE_OF_REVOLUTION('',{curve},{ax})")

    def bspline_extrusion(self, ctrl, degree: int, knots, mults, delta) -> str:
        """B_SPLINE_SURFACE_WITH_KNOTS that is a linear extrusion of a
        clamped profile: control grid rows (P_i, P_i + delta), degree 1 and
        a single Bezier span in v — the entity CAD writers emit for
        extruded freeform walls."""
        delta = np.asarray(delta, dtype=float)
        rows = ",".join(
            f"({self.point(p)},{self.point(np.asarray(p, dtype=float) + delta)})"
            for p in np.asarray(ctrl, dtype=float))
        kstr = ",".join(self._fmt(k) for k in knots)
        mstr = ",".join(str(int(m)) for m in mults)
        return self.emit(
            f"B_SPLINE_SURFACE_WITH_KNOTS('',{int(degree)},1,({rows}),"
            f".UNSPECIFIED.,.F.,.F.,.F.,({mstr}),(2,2),({kstr}),(0.,1.),"
            ".UNSPECIFIED.)")

    def oriented(self, edge: str, forward: bool) -> str:
        return self.emit(
            f"ORIENTED_EDGE('',*,*,{edge},{'.T.' if forward else '.F.'})")

    def face(self, loops: Sequence[Sequence[Tuple[str, bool]]], surface: str) -> str:
        bound_refs = []
        for i, loop in enumerate(loops):
            oes = ",".join(self.oriented(e, fwd) for e, fwd in loop)
            el = self.emit(f"EDGE_LOOP('',({oes}))")
            kind = "FACE_OUTER_BOUND" if i == 0 else "FACE_BOUND"
            bound_refs.append(self.emit(f"{kind}('',{el},.T.)"))
        return self.emit(
            f"ADVANCED_FACE('',({','.join(bound_refs)}),{surface},.T.)")

    def plane(self, origin, normal) -> str:
        n = _unit(np.asarray(normal, dtype=float))
        seed = np.array([1.0, 0.0, 0.0])
        if abs(float(seed @ n)) > 0.9:
            seed = np.array([0.0, 1.0, 0.0])
        x = _unit(seed - n * float(seed @ n))
        return self.emit(f"PLANE('',{self.axis2(origin, n, x)})")

    def cylinder(self, origin, axis, x, radius) -> str:
        return self.emit(
            f"CYLINDRICAL_SURFACE('',{self.axis2(origin, axis, x)},{self._fmt(radius)})")

    def cone(self, origin, axis, x, radius, semi_angle) -> str:
        return self.emit(
            f"CONICAL_SURFACE('',{self.axis2(origin, axis, x)},"
            f"{self._fmt(radius)},{self._fmt(semi_angle)})")

    def sphere(self, center, axis, x, radius) -> str:
        return self.emit(
            f"SPHERICAL_SURFACE('',{self.axis2(center, axis, x)},{self._fmt(radius)})")

    def torus(self, center, axis, x, major, minor) -> str:
        return self.emit(
            f"TOROIDAL_SURFACE('',{self.axis2(center, axis, x)},"
            f"{self._fmt(major)},{self._fmt(minor)})")

    def solid(self, face_refs: Sequence[str], name="solid") -> str:
        shell = self.emit(f"CLOSED_SHELL('',({','.join(face_refs)}))")
        return self.emit(f"MANIFOLD_SOLID_BREP('{name}',{shell})")

    def text(self, filename="synthetic.step") -> str:
        data = "\n".join(f"#{i + 1} = {row} ;" for i, row in enumerate(self.rows))
        return (
            "ISO-10303-21;\nHEADER;\n"
            "FILE_DESCRIPTION(('faceformer_tpu synthetic solid'),'2;1');\n"
            f"FILE_NAME('{filename}','',(''),(''),'faceformer_tpu','','');\n"
            "FILE_SCHEMA(('AUTOMOTIVE_DESIGN { 1 0 10303 214 1 1 1 1 }'));\n"
            "ENDSEC;\nDATA;\n" + data + "\nENDSEC;\nEND-ISO-10303-21;\n")


# ---------------------------------------------------------------------------
# synthetic solid -> STEP builders
# ---------------------------------------------------------------------------

_Z = np.array([0.0, 0.0, 1.0])


def _ring(poly2d: np.ndarray, z: float) -> np.ndarray:
    return np.concatenate([poly2d, np.full((len(poly2d), 1), z)], axis=1)


def brep_extrusion(poly2d: np.ndarray, z0: float, z1: float,
                   holes: Sequence[Tuple[float, float, float]] = (),
                   name: str = "extrusion") -> str:
    """STEP text for a prism over a CCW simple polygon with optional
    circular through-holes (each hole wall is ONE cylindrical face with a
    seam edge — the CAD topology whose HLR splitting and sewn-edge removal
    the native pipeline must reproduce; reference TopoMapper.py:58-83,
    118-185)."""
    b = StepBuilder()
    poly2d = np.asarray(poly2d, dtype=float)
    n = len(poly2d)
    bot, top = _ring(poly2d, z0), _ring(poly2d, z1)
    faces: List[str] = []

    # walls traverse the bottom ring forward (CCW seen from +z)
    bot_edges = [b.line_edge(bot[i], bot[(i + 1) % n]) for i in range(n)]
    top_edges = [b.line_edge(top[i], top[(i + 1) % n]) for i in range(n)]
    up_edges = [b.line_edge(bot[i], top[i]) for i in range(n)]
    for i in range(n):
        j = (i + 1) % n
        centroid = (bot[i] + bot[j] + top[j] + top[i]) / 4
        edge_dir = _unit(bot[j] - bot[i])
        normal = np.cross(edge_dir, _Z)
        loop = [(bot_edges[i], True), (up_edges[j], True),
                (top_edges[i], False), (up_edges[i], False)]
        faces.append(b.face([loop], b.plane(centroid, normal)))

    # caps: bottom traverses the ring reversed, top forward
    bot_loops = [[(bot_edges[i], False) for i in range(n - 1, -1, -1)]]
    top_loops = [[(top_edges[i], True) for i in range(n)]]

    for cx, cy, r in holes:
        c0, c1 = np.array([cx, cy, z0]), np.array([cx, cy, z1])
        seam0, seam1 = c0 + np.array([r, 0, 0]), c1 + np.array([r, 0, 0])
        x_axis = np.array([1.0, 0.0, 0.0])
        circ0 = b.circle_edge(c0, _Z, x_axis, r, seam0, seam0)
        circ1 = b.circle_edge(c1, _Z, x_axis, r, seam1, seam1)
        seam = b.line_edge(seam0, seam1)
        # hole wall: seam up, top circle reversed, seam down, bottom forward
        wall = [(seam, True), (circ1, False), (seam, False), (circ0, True)]
        faces.append(b.face([wall], b.cylinder(c0, _Z, x_axis, r)))
        bot_loops.append([(circ0, False)])
        top_loops.append([(circ1, True)])

    faces.append(b.face(bot_loops, b.plane(np.array([0, 0, z0]), -_Z)))
    faces.append(b.face(top_loops, b.plane(np.array([0, 0, z1]), _Z)))
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_plate_features(poly2d: np.ndarray, z0: float, z1: float,
                        features: Sequence[Tuple[str, float, float, float,
                                                 float]],
                        name: str = "plate") -> str:
    """A COMPOSITE solid: a prism over a CCW simple polygon carrying a mix
    of machining features on one body — ("hole", cx, cy, r, _) circular
    through-holes, ("boss", cx, cy, r, h) raised cylindrical bosses with
    flat caps, ("dome_boss", cx, cy, r, h) bosses capped by spherical
    domes, and ("pocket", cx, cy, r, d) blind circular pockets. Every
    curved wall is ONE cylindrical face with a seam edge, bosses/pockets
    put extra bounds on the shared top face, and dome caps share the boss
    rim circle — the multi-feature topology of real ABC parts (the
    reference's corpus is dominated by such composites; every
    single-feature family here is a degenerate case of this one).
    Reference path: dataset/prepare_data.py:268-327 over arbitrary ABC
    B-Reps via OCC."""
    b = StepBuilder()
    poly2d = np.asarray(poly2d, dtype=float)
    n = len(poly2d)
    bot, top = _ring(poly2d, z0), _ring(poly2d, z1)
    faces: List[str] = []

    bot_edges = [b.line_edge(bot[i], bot[(i + 1) % n]) for i in range(n)]
    top_edges = [b.line_edge(top[i], top[(i + 1) % n]) for i in range(n)]
    up_edges = [b.line_edge(bot[i], top[i]) for i in range(n)]
    for i in range(n):
        j = (i + 1) % n
        centroid = (bot[i] + bot[j] + top[j] + top[i]) / 4
        normal = np.cross(_unit(bot[j] - bot[i]), _Z)
        loop = [(bot_edges[i], True), (up_edges[j], True),
                (top_edges[i], False), (up_edges[i], False)]
        faces.append(b.face([loop], b.plane(centroid, normal)))

    bot_loops = [[(bot_edges[i], False) for i in range(n - 1, -1, -1)]]
    top_loops = [[(top_edges[i], True) for i in range(n)]]
    x_axis = np.array([1.0, 0.0, 0.0])

    def circ(cx, cy, z, r):
        c = np.array([cx, cy, z])
        return b.circle_edge(c, _Z, x_axis, r, c + np.array([r, 0, 0]),
                             c + np.array([r, 0, 0]))

    def wall(cx, cy, za, zb, r):
        """One cylindrical face from za to zb with a seam; returns
        (face, circle@za, circle@zb)."""
        ca, cb = circ(cx, cy, za, r), circ(cx, cy, zb, r)
        seam = b.line_edge(np.array([cx + r, cy, za]),
                           np.array([cx + r, cy, zb]))
        loop = [(seam, True), (cb, False), (seam, False), (ca, True)]
        face = b.face([loop], b.cylinder(np.array([cx, cy, za]), _Z,
                                         x_axis, r))
        return face, ca, cb

    for kind, cx, cy, r, param in features:
        if kind == "hole":
            face, c_bot, c_top = wall(cx, cy, z0, z1, r)
            faces.append(face)
            bot_loops.append([(c_bot, False)])
            top_loops.append([(c_top, True)])
        elif kind in ("boss", "dome_boss"):
            if kind == "dome_boss" and param <= 1e-9:
                # hemisphere sitting directly on the plate top
                c_rim = circ(cx, cy, z1, r)
                top_loops.append([(c_rim, False)])
                faces.append(b.face([[(c_rim, True)]],
                                    b.sphere(np.array([cx, cy, z1]), _Z,
                                             x_axis, r)))
                continue
            z2 = z1 + param
            face, c_base, c_rim = wall(cx, cy, z1, z2, r)
            faces.append(face)
            top_loops.append([(c_base, False)])
            if kind == "boss":
                faces.append(b.face([[(c_rim, True)]],
                                    b.plane(np.array([cx, cy, z2]), _Z)))
            else:
                # hemisphere over the rim, like brep_dome_block's cap
                faces.append(b.face([[(c_rim, True)]],
                                    b.sphere(np.array([cx, cy, z2]), _Z,
                                             x_axis, r)))
        elif kind == "pocket":
            zp = z1 - param
            if not z0 + 1e-9 < zp < z1 - 1e-9:
                raise ValueError("pocket depth must stay inside the plate")
            face, c_floor, c_mouth = wall(cx, cy, zp, z1, r)
            faces.append(face)
            top_loops.append([(c_mouth, True)])
            faces.append(b.face([[(c_floor, False)]],
                                b.plane(np.array([cx, cy, zp]), _Z)))
        else:
            raise ValueError(f"unknown plate feature {kind!r}")

    faces.append(b.face(bot_loops, b.plane(np.array([0, 0, z0]), -_Z)))
    faces.append(b.face(top_loops, b.plane(np.array([0, 0, z1]), _Z)))
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_cylinder(radius: float, height: float, name: str = "cylinder") -> str:
    """A full cylinder: one cylindrical wall with a seam, two disc caps."""
    b = StepBuilder()
    z0, z1 = -height / 2, height / 2
    c0, c1 = np.array([0, 0, z0]), np.array([0, 0, z1])
    x_axis = np.array([1.0, 0.0, 0.0])
    seam0, seam1 = c0 + np.array([radius, 0, 0]), c1 + np.array([radius, 0, 0])
    circ0 = b.circle_edge(c0, _Z, x_axis, radius, seam0, seam0)
    circ1 = b.circle_edge(c1, _Z, x_axis, radius, seam1, seam1)
    seam = b.line_edge(seam0, seam1)
    wall = [(seam, True), (circ1, False), (seam, False), (circ0, True)]
    faces = [
        b.face([wall], b.cylinder(c0, _Z, x_axis, radius)),
        b.face([[(circ0, False)]], b.plane(c0, -_Z)),
        b.face([[(circ1, True)]], b.plane(c1, _Z)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def nurbs_circle_net(center, radius: float,
                     x=np.array([1.0, 0.0, 0.0]),
                     y=np.array([0.0, 1.0, 0.0])):
    """The standard full-circle rational quadratic NURBS: 9 control
    points over 4 quarter-arc Bezier spans (weights 1, sqrt(2)/2
    alternating) — the exact net CAD exporters write for circles.
    Returns (ctrl (9,3), weights (9,), knots, mults); traversal is CCW
    around x cross y starting at center + radius*x."""
    c = np.asarray(center, dtype=float)
    x = np.asarray(x, dtype=float) * radius
    y = np.asarray(y, dtype=float) * radius
    ctrl = np.stack([c + x, c + x + y, c + y, c - x + y, c - x,
                     c - x - y, c - y, c + x - y, c + x])
    w = np.sqrt(2.0) / 2.0
    weights = np.array([1.0, w, 1.0, w, 1.0, w, 1.0, w, 1.0])
    knots = (0.0, 0.25, 0.5, 0.75, 1.0)
    mults = (3, 2, 2, 2, 3)
    return ctrl, weights, knots, mults


def brep_nurbs_cylinder(radius: float, height: float,
                        name: str = "nurbs_cylinder") -> str:
    """The same solid as brep_cylinder — one cylindrical wall with a seam,
    two disc caps — but with every piece of curved geometry encoded the
    way real CAD exporters write it: cap circles as rational quadratic
    NURBS curves and the wall as a rational B-spline surface (degree 2x1
    complex instances with RATIONAL_B_SPLINE_* parts). Exercises the
    native reader's homogeneous de Boor + circle/cylinder recognition:
    the parsed JSON must match the analytic-cylinder path (reference
    reads both encodings identically through OCC, read_step_file.py:9)."""
    b = StepBuilder()
    z0, z1 = -height / 2, height / 2
    c0, c1 = np.array([0, 0, z0]), np.array([0, 0, z1])
    ctrl0, wts, knots, mults = nurbs_circle_net(c0, radius)
    ctrl1, _, _, _ = nurbs_circle_net(c1, radius)
    circ0 = b.rational_edge(ctrl0, wts, 2, knots, mults)
    circ1 = b.rational_edge(ctrl1, wts, 2, knots, mults)
    seam = b.line_edge(ctrl0[0], ctrl1[0])
    grid = np.stack([ctrl0, ctrl1], axis=1)          # (9, 2, 3)
    wgrid = np.stack([wts, wts], axis=1)             # (9, 2)
    wall_surf = b.rational_surface(grid, wgrid, 2, 1, knots, mults,
                                   (0.0, 1.0), (2, 2))
    wall = [(seam, True), (circ1, False), (seam, False), (circ0, True)]
    faces = [
        b.face([wall], wall_surf),
        b.face([[(circ0, False)]], b.plane(c0, -_Z)),
        b.face([[(circ1, True)]], b.plane(c1, _Z)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_dome(radius: float, cap_height: float, name: str = "dome") -> str:
    """A spherical cap sitting on a flat disc: sphere of ``radius`` cut by
    the plane z = radius - cap_height (0 < cap_height < 2*radius). Two
    faces sharing one boundary circle — the smallest sphere-bearing closed
    B-Rep, exercising the SPHERICAL_SURFACE path end to end."""
    if not 0.0 < cap_height < 2.0 * radius - 1e-9:
        raise ValueError("cap_height must be in (0, 2*radius)")
    b = StepBuilder()
    z_c = radius - cap_height
    rho = float(np.sqrt(radius * radius - z_c * z_c))
    center = np.array([0.0, 0.0, 0.0])
    c_cut = np.array([0.0, 0.0, z_c])
    x_axis = np.array([1.0, 0.0, 0.0])
    seam = c_cut + np.array([rho, 0.0, 0.0])
    circ = b.circle_edge(c_cut, _Z, x_axis, rho, seam, seam)
    faces = [
        b.face([[(circ, True)]], b.sphere(center, _Z, x_axis, radius)),
        b.face([[(circ, False)]], b.plane(c_cut, -_Z)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_dome_block(radius: float, height: float,
                    name: str = "dome_block") -> str:
    """A cylinder capped by a hemisphere: bottom disc, cylindrical wall
    (with a seam), hemispherical top whose boundary is the wall's top
    circle — the shared-equator topology where the wall's silhouette split
    subdivides the sphere face's boundary arcs."""
    b = StepBuilder()
    z0, z1 = -height / 2, height / 2
    c0, c1 = np.array([0, 0, z0]), np.array([0, 0, z1])
    x_axis = np.array([1.0, 0.0, 0.0])
    seam0, seam1 = c0 + np.array([radius, 0, 0]), c1 + np.array([radius, 0, 0])
    circ0 = b.circle_edge(c0, _Z, x_axis, radius, seam0, seam0)
    circ1 = b.circle_edge(c1, _Z, x_axis, radius, seam1, seam1)
    seam = b.line_edge(seam0, seam1)
    wall = [(seam, True), (circ1, False), (seam, False), (circ0, True)]
    faces = [
        b.face([wall], b.cylinder(c0, _Z, x_axis, radius)),
        b.face([[(circ0, False)]], b.plane(c0, -_Z)),
        b.face([[(circ1, True)]], b.sphere(c1, _Z, x_axis, radius)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_torus(major: float, minor: float, name: str = "torus") -> str:
    """A full ring torus (donut), axis +z, center the origin, split into
    an outer (v in [-pi/2, pi/2]) and an inner (v in [pi/2, 3pi/2]) band —
    the two-face topology OCC produces for a revolved tube. Each band's
    u-seam is a half tube circle at u = 0 used twice in its wire (sewn);
    the bands share the top/bottom extreme circles."""
    if not 0.0 < minor < major:
        raise UnsupportedStep("only ring tori (0 < minor < major)")
    b = StepBuilder()
    x_axis = np.array([1.0, 0.0, 0.0])
    neg_y = np.array([0.0, -1.0, 0.0])
    c_top, c_bot = np.array([0, 0, minor]), np.array([0, 0, -minor])
    t_ring = np.array([major, 0.0, minor])    # (u=0, v=+pi/2)
    b_ring = np.array([major, 0.0, -minor])   # (u=0, v=-pi/2)
    tube_c = np.array([major, 0.0, 0.0])
    circ_top = b.circle_edge(c_top, _Z, x_axis, major, t_ring, t_ring)
    circ_bot = b.circle_edge(c_bot, _Z, x_axis, major, b_ring, b_ring)
    # tube circle at u=0 with axis -y: angle t sweeps x cos t + z sin t,
    # so CCW b_ring(-pi/2) -> t_ring(+pi/2) passes the outer point (v = t)
    seam_out = b.circle_edge(tube_c, neg_y, x_axis, minor, b_ring, t_ring)
    seam_in = b.circle_edge(tube_c, neg_y, x_axis, minor, t_ring, b_ring)
    surf = b.torus(np.zeros(3), _Z, x_axis, major, minor)
    faces = [
        b.face([[(circ_bot, True), (seam_out, True),
                 (circ_top, False), (seam_out, False)]], surf),
        b.face([[(circ_top, True), (seam_in, True),
                 (circ_bot, False), (seam_in, False)]], surf),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_round_top_cylinder(radius: float, height: float, fillet: float,
                            name: str = "round_top") -> str:
    """A cylinder whose top rim is rounded by a quarter-torus fillet — the
    canonical CAD use of a toroidal face. Bottom disc, cylindrical wall
    (line seam), fillet band (v in [0, pi/2], tube-arc seam) tangent to the
    wall along their shared circle, top disc of radius ``radius - fillet``."""
    # the fillet torus has major = radius - fillet, minor = fillet, so a
    # ring torus (minor < major) needs fillet < radius / 2
    if not 0.0 < fillet < radius / 2:
        raise UnsupportedStep("fillet must be in (0, radius/2) for a ring torus")
    b = StepBuilder()
    x_axis = np.array([1.0, 0.0, 0.0])
    neg_y = np.array([0.0, -1.0, 0.0])
    major = radius - fillet
    c0, c_mid = np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, height])
    c_small = np.array([0.0, 0.0, height + fillet])
    p0 = np.array([radius, 0.0, 0.0])
    p_mid = np.array([radius, 0.0, height])           # (u=0, v=0)
    p_small = np.array([major, 0.0, height + fillet])  # (u=0, v=pi/2)
    tube_c = np.array([major, 0.0, height])
    circ_bot = b.circle_edge(c0, _Z, x_axis, radius, p0, p0)
    circ_mid = b.circle_edge(c_mid, _Z, x_axis, radius, p_mid, p_mid)
    circ_small = b.circle_edge(c_small, _Z, x_axis, major, p_small, p_small)
    seam_line = b.line_edge(p0, p_mid)
    seam_arc = b.circle_edge(tube_c, neg_y, x_axis, fillet, p_mid, p_small)
    faces = [
        b.face([[(seam_line, True), (circ_mid, False),
                 (seam_line, False), (circ_bot, True)]],
               b.cylinder(c0, _Z, x_axis, radius)),
        b.face([[(circ_mid, True), (seam_arc, True),
                 (circ_small, False), (seam_arc, False)]],
               b.torus(c_mid, _Z, x_axis, major, fillet)),
        b.face([[(circ_bot, False)]], b.plane(c0, -_Z)),
        b.face([[(circ_small, True)]], b.plane(c_small, _Z)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_cone(radius: float, height: float, name: str = "cone") -> str:
    """An apex cone: one conical wall whose wire runs seam-up/seam-down
    through the apex vertex (the sewn-edge pattern), plus a disc cap. All
    silhouette rulings of the wall end at the shared apex vertex."""
    b = StepBuilder()
    c0, apex = np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, height])
    x_axis = np.array([1.0, 0.0, 0.0])
    seam0 = c0 + np.array([radius, 0.0, 0.0])
    circ0 = b.circle_edge(c0, _Z, x_axis, radius, seam0, seam0)
    seam = b.line_edge(seam0, apex)
    wall = [(seam, True), (seam, False), (circ0, True)]
    semi_angle = float(np.arctan2(-radius, height))
    faces = [
        b.face([wall], b.cone(c0, _Z, x_axis, radius, semi_angle)),
        b.face([[(circ0, False)]], b.plane(c0, -_Z)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_frustum(r_bottom: float, r_top: float, height: float,
                 name: str = "frustum") -> str:
    """A conical frustum: one conical wall with a seam, two disc caps.
    For an apex cone use brep_cone (a frustum needs two circles)."""
    if min(r_bottom, r_top) < 1e-6:
        raise UnsupportedStep("frustum with a vanishing cap; use brep_cone")
    b = StepBuilder()
    z0, z1 = -height / 2, height / 2
    c0, c1 = np.array([0, 0, z0]), np.array([0, 0, z1])
    x_axis = np.array([1.0, 0.0, 0.0])
    seam0 = c0 + np.array([r_bottom, 0, 0])
    seam1 = c1 + np.array([r_top, 0, 0])
    circ0 = b.circle_edge(c0, _Z, x_axis, r_bottom, seam0, seam0)
    circ1 = b.circle_edge(c1, _Z, x_axis, r_top, seam1, seam1)
    seam = b.line_edge(seam0, seam1)
    wall = [(seam, True), (circ1, False), (seam, False), (circ0, True)]
    semi_angle = float(np.arctan2(r_top - r_bottom, height))
    faces = [
        b.face([wall], b.cone(c0, _Z, x_axis, r_bottom, semi_angle)),
        b.face([[(circ0, False)]], b.plane(c0, -_Z)),
        b.face([[(circ1, True)]], b.plane(c1, _Z)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_pillow(grid_z, half_x: float, half_y: float,
                base_z: float = 0.0, name: str = "pillow",
                interior_weight: float = 0.0) -> str:
    """A box capped by a general doubly-curved B-spline patch roof: the
    (nu, nv) ``grid_z`` heights (all > base_z) sit on a uniform control
    grid over [-half_x, half_x] x [-half_y, half_y], so the patch's four
    boundary iso-curves are PLANAR curves in the wall planes — each wall
    is an ordinary planar face (straight bottom, vertical sides, B-spline
    top) and the solid is watertight. The roof is the one surface class
    the reference only reaches through OCC HLR on GeomAbs_BSplineSurface
    faces (TopoMapper.py:38-83). With ``interior_weight`` > 0, the roof
    is written as a RATIONAL B-spline surface whose interior control
    points carry that weight (boundary weights stay 1, so the boundary
    iso-curves — and the walls they bound — are unchanged): the NURBS
    encoding real exporters emit, driving the reader's homogeneous
    evaluation and quotient-rule silhouette marching."""
    gz = np.asarray(grid_z, dtype=float)
    nu, nv = gz.shape
    if nu < 3 or nv < 3:
        raise ValueError("need at least a 3x3 control grid")
    if np.min(gz) <= base_z + 1e-9:
        raise ValueError("roof control heights must sit above the base")
    xs = np.linspace(-half_x, half_x, nu)
    ys = np.linspace(-half_y, half_y, nv)
    grid = np.stack([np.repeat(xs[:, None], nv, 1),
                     np.repeat(ys[None, :], nu, 0), gz], axis=2)
    udeg, vdeg = min(3, nu - 1), min(3, nv - 1)

    def clamped(n, p):
        n_int = n - p - 1
        knots = tuple([0.0] + [(i + 1) / (n_int + 1) for i in range(n_int)]
                      + [1.0])
        mults = tuple([p + 1] + [1] * n_int + [p + 1])
        return knots, mults

    uk, um = clamped(nu, udeg)
    vk, vm = clamped(nv, vdeg)
    b = StepBuilder()
    # roof boundary iso-curves as shared edges (v0: u-curve at y=-half_y...)
    rim = {
        "v0": b.bspline_edge(grid[:, 0], udeg, uk, um),
        "v1": b.bspline_edge(grid[:, -1], udeg, uk, um),
        "u0": b.bspline_edge(grid[0], vdeg, vk, vm),
        "u1": b.bspline_edge(grid[-1], vdeg, vk, vm),
    }
    corners = {(0, 0): grid[0, 0], (1, 0): grid[-1, 0],
               (0, 1): grid[0, -1], (1, 1): grid[-1, -1]}
    base = {(i, j): np.array([xs[0] if i == 0 else xs[-1],
                              ys[0] if j == 0 else ys[-1], base_z])
            for i, j in corners}
    posts = {ij: b.line_edge(base[ij], corners[ij]) for ij in corners}
    bot = {
        "v0": b.line_edge(base[(0, 0)], base[(1, 0)]),
        "u1": b.line_edge(base[(1, 0)], base[(1, 1)]),
        "v1": b.line_edge(base[(0, 1)], base[(1, 1)]),
        "u0": b.line_edge(base[(0, 0)], base[(0, 1)]),
    }
    if interior_weight > 0.0:
        wgrid = np.ones((nu, nv))
        wgrid[1:-1, 1:-1] = interior_weight
        roof_surf = b.rational_surface(grid, wgrid, udeg, vdeg,
                                       uk, um, vk, vm)
    else:
        roof_surf = b.bspline_patch(grid, udeg, vdeg, uk, um, vk, vm)
    faces = [
        # roof: CCW seen from above (+u along v0, +v along u1, ...)
        b.face([[(rim["v0"], True), (rim["u1"], True),
                 (rim["v1"], False), (rim["u0"], False)]],
               roof_surf),
        # walls: bottom forward, far post up, rim back, near post down
        b.face([[(bot["v0"], True), (posts[(1, 0)], True),
                 (rim["v0"], False), (posts[(0, 0)], False)]],
               b.plane(np.array([0.0, -half_y, base_z]),
                       np.array([0.0, -1.0, 0.0]))),
        b.face([[(bot["u1"], True), (posts[(1, 1)], True),
                 (rim["u1"], False), (posts[(1, 0)], False)]],
               b.plane(np.array([half_x, 0.0, base_z]),
                       np.array([1.0, 0.0, 0.0]))),
        b.face([[(bot["v1"], False), (posts[(0, 1)], True),
                 (rim["v1"], True), (posts[(1, 1)], False)]],
               b.plane(np.array([0.0, half_y, base_z]),
                       np.array([0.0, 1.0, 0.0]))),
        b.face([[(bot["u0"], False), (posts[(0, 0)], True),
                 (rim["u0"], True), (posts[(0, 1)], False)]],
               b.plane(np.array([-half_x, 0.0, base_z]),
                       np.array([-1.0, 0.0, 0.0]))),
        # base: CW seen from above (outward normal -z)
        b.face([[(bot["v0"], False), (bot["u0"], True),
                 (bot["v1"], True), (bot["u1"], False)]],
               b.plane(np.array([0.0, 0.0, base_z]),
                       np.array([0.0, 0.0, -1.0]))),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_vase(profile_rz, name: str = "vase") -> str:
    """A solid of revolution: a clamped cubic-or-higher B-spline meridian
    profile (k, 2) of (radius, height) control points — radius > 0, height
    strictly increasing at the ends — revolved 2*pi around +z. One
    SURFACE_OF_REVOLUTION band whose wire is ring-bottom / seam-up /
    ring-top / seam-down (the seam profile edge used twice = sewn), plus
    two disc caps. The canonical turned-part topology the reference only
    reaches through OCC HLR (TopoMapper.py:38-83)."""
    prz = np.asarray(profile_rz, dtype=float)
    if len(prz) < 3:
        raise ValueError("need at least 3 profile control points")
    if np.min(prz[:, 0]) <= 1e-6:
        raise UnsupportedStep("vase profile touches the axis")
    b = StepBuilder()
    k = len(prz)
    degree, knots, mults = min(3, k - 1), (0.0, 1.0), None
    if degree == k - 1:
        mults = (k, k)
    else:  # clamped cubic with uniform interior knots
        n_int = k - degree - 1
        knots = tuple([0.0] + [(i + 1) / (n_int + 1) for i in range(n_int)]
                      + [1.0])
        mults = tuple([degree + 1] + [1] * n_int + [degree + 1])
    ctrl3 = np.stack([prz[:, 0], np.zeros(k), prz[:, 1]], axis=1)
    x_axis = np.array([1.0, 0.0, 0.0])
    p_bot, p_top = ctrl3[0], ctrl3[-1]
    c_bot = np.array([0.0, 0.0, p_bot[2]])
    c_top = np.array([0.0, 0.0, p_top[2]])
    circ_bot = b.circle_edge(c_bot, _Z, x_axis, p_bot[0], p_bot, p_bot)
    circ_top = b.circle_edge(c_top, _Z, x_axis, p_top[0], p_top, p_top)
    seam = b.bspline_edge(ctrl3, degree, knots, mults)
    surf = b.revolution(ctrl3, degree, knots, mults, np.zeros(3), _Z)
    wall = [(seam, True), (circ_top, False), (seam, False), (circ_bot, True)]
    faces = [
        b.face([wall], surf),
        b.face([[(circ_bot, False)]], b.plane(c_bot, -_Z)),
        b.face([[(circ_top, True)]], b.plane(c_top, _Z)),
    ]
    b.solid(faces, name=name)
    return b.text(f"{name}.step")


def brep_spline_prism(segments, z0: float, z1: float,
                      name: str = "spline_prism") -> str:
    """A prism over a closed CCW chain of 2D B-spline (Bezier) segments:
    each wall is ONE B_SPLINE_SURFACE_WITH_KNOTS face (the linear extrusion
    of its profile segment), caps are planes bounded by the spline edges —
    the freeform-surface topology the reference pipeline only reaches
    through OCC HLR (TopoMapper.py:38-83 splits outline edges on ANY
    surface type the adaptor reports, incl. GeomAbs_BSplineSurface).

    ``segments``: list of (k_i, 2) control-point arrays; each segment is a
    clamped degree-(k_i - 1) Bezier span, chained (last control point of
    one == first of the next, closing around)."""
    segs = [np.asarray(s, dtype=float) for s in segments]
    if len(segs) < 2:
        raise ValueError("need at least 2 segments for distinct wall faces")
    for s, t in zip(segs, segs[1:] + segs[:1]):
        if float(np.max(np.abs(s[-1] - t[0]))) > 1e-9:
            raise ValueError("segments do not chain into a closed profile")
    b = StepBuilder()

    def lift(seg: np.ndarray, z: float) -> np.ndarray:
        return np.concatenate([seg, np.full((len(seg), 1), z)], axis=1)

    n = len(segs)
    bez = [(len(s) - 1, (0.0, 1.0), (len(s), len(s))) for s in segs]
    bot_edges = [b.bspline_edge(lift(s, z0), p, k, m)
                 for s, (p, k, m) in zip(segs, bez)]
    top_edges = [b.bspline_edge(lift(s, z1), p, k, m)
                 for s, (p, k, m) in zip(segs, bez)]
    up_edges = [b.line_edge(lift(s, z0)[0], lift(s, z1)[0]) for s in segs]
    faces: List[str] = []
    for i in range(n):
        j = (i + 1) % n
        p, k, m = bez[i]
        loop = [(bot_edges[i], True), (up_edges[j], True),
                (top_edges[i], False), (up_edges[i], False)]
        faces.append(b.face([loop], b.bspline_extrusion(
            lift(segs[i], z0), p, k, m, np.array([0.0, 0.0, z1 - z0]))))
    bot_loops = [[(bot_edges[i], False) for i in range(n - 1, -1, -1)]]
    top_loops = [[(top_edges[i], True) for i in range(n)]]
    faces.append(b.face(bot_loops, b.plane(np.array([0, 0, z0]), -_Z)))
    faces.append(b.face(top_loops, b.plane(np.array([0, 0, z1]), _Z)))
    b.solid(faces, name=name)
    return b.text(f"{name}.step")
