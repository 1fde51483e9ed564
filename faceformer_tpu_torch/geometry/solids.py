"""Composite analytic solids: the rich fixture families for large corpora.

A copy of faceformer_tpu/geometry/solids.py, kept so the port imports
nothing of the JAX package: the same rng draws the same solids.

The reference's training corpus is 10,124 filtered ABC CAD solids
(dataset/dataset_gen_logs/filtered_id_list.json) whose wireframes reach
216 coedge tokens per sample (configs/ours.yml:20-22). The basic fixtures
in ``fixtures.py`` (box/prism/cylinder/...) top out near 50 coedges; this
module builds *composite* solids — plates with through-holes, bosses,
pockets, stacked towers, notched/concave extrusions, cylindrical and
conical features — that genuinely fill the reference dims.

Construction model
------------------
A sample only records, per face, ordered loops of oriented edges; global
validity is exactly "every undirected edge appears twice, once per
direction" (that is what OCC wire exploration produces and what the
pairing/enclosedness machinery relies on: dataset/prepare_data.py:249-265,
dataset/tests/check_faces_enclosed.py:18-46). So composition reduces to a
loop-bookkeeping rule: build each prismatic/cylindrical *column* as a
self-consistent standalone solid (wall faces + a bottom-cap loop + a
top-cap loop), then

  - through-hole: keep the column's walls as faces of the composite and
    donate BOTH cap loops to the host's caps as extra (hole) loops;
  - boss:   keep walls + top cap; donate the bottom-cap loop to the host's
    top cap;
  - pocket: keep walls + bottom cap; donate the top-cap loop to the host's
    top cap.

Each rule moves whole loops between faces without changing any edge
traversal, so the two-opposite-traversals invariant is inherited from the
standalone columns. (Traversal orientation relative to the outward normal
is not tracked — the reference pipeline never consumes it.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

PLANE, CYLINDER, OTHER = 0, 1, 2

Edge = np.ndarray  # (K, 3) polyline
Loop = List[Edge]
Face = Tuple[int, List[Loop]]


# ---------------------------------------------------------------------------
# 2D footprint polygons
# ---------------------------------------------------------------------------


def poly_rect(w: float, h: float) -> np.ndarray:
    return np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])


def poly_ngon(n: int, r: float, rot: float = 0.0) -> np.ndarray:
    t = rot + 2 * np.pi * np.arange(n) / n
    return np.stack([r * np.cos(t), r * np.sin(t)], axis=1)


def poly_convex(rng: np.random.Generator, n: int, r: float) -> np.ndarray:
    """Random convex n-gon: jittered angles + jittered radii on a circle."""
    t = np.sort(rng.uniform(0, 2 * np.pi, size=n))
    # enforce a minimum angular gap so no edge degenerates
    if np.min(np.diff(np.concatenate([t, [t[0] + 2 * np.pi]]))) < 0.25:
        t = 2 * np.pi * (np.arange(n) + rng.uniform(0.2, 0.8, size=n)) / n
    rr = r * rng.uniform(0.75, 1.0, size=n)
    return np.stack([rr * np.cos(t), rr * np.sin(t)], axis=1)


def bezier_star_segments(rng: np.random.Generator, n: int = 4,
                         r0: float = 0.7, r1: float = 1.0,
                         rot: float = 0.0) -> List[np.ndarray]:
    """Closed CCW chain of ``n`` cubic Bezier segments around a star-shaped
    radius profile, C1 at the junctions (mirrored tangents) — the freeform
    footprint for B-spline extrusion solids. Star-shapedness keeps the
    profile simple (non-self-intersecting) for any radius draw."""
    th = rot + np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    rad = rng.uniform(r0, r1, size=n)
    pts = np.stack([rad * np.cos(th), rad * np.sin(th)], axis=1)
    tang = np.stack([-rad * np.sin(th), rad * np.cos(th)], axis=1)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    segs: List[np.ndarray] = []
    for i in range(n):
        j = (i + 1) % n
        h = float(np.linalg.norm(pts[j] - pts[i])) / 3.0
        segs.append(np.stack([pts[i], pts[i] + h * tang[i],
                              pts[j] - h * tang[j], pts[j]]))
    return segs


def poly_lshape(a: float, b: float, cut_x: float, cut_y: float) -> np.ndarray:
    p = np.array([[0, 0], [a, 0], [a, b - cut_y], [a - cut_x, b - cut_y],
                  [a - cut_x, b], [0, b]], dtype=float)
    return p - p.mean(axis=0)


def poly_tshape(w: float, h: float, stem_w: float, stem_h: float) -> np.ndarray:
    """T: horizontal bar of w x (h - stem_h) with a stem below."""
    bar_h = h - stem_h
    s = stem_w / 2
    p = np.array([
        [-s, 0], [s, 0], [s, stem_h], [w / 2, stem_h], [w / 2, stem_h + bar_h],
        [-w / 2, stem_h + bar_h], [-w / 2, stem_h], [-s, stem_h],
    ], dtype=float)
    return p - p.mean(axis=0)


def poly_plus(w: float, h: float, arm_w: float, arm_h: float) -> np.ndarray:
    """Plus/cross: w x h core with four arms (12-gon)."""
    x, y, ax, ay = w / 2, h / 2, arm_w / 2, arm_h / 2
    p = np.array([
        [-ax, -y - ay], [ax, -y - ay], [ax, -y], [x + ax, -y], [x + ax, y],
        [ax, y], [ax, y + ay], [-ax, y + ay], [-ax, y], [-x - ax, y],
        [-x - ax, -y], [-ax, -y],
    ], dtype=float)
    return p


def poly_notched_rect(rng: np.random.Generator, w: float, h: float,
                      notches: int) -> np.ndarray:
    """Rectangle with rectangular notches cut into its sides — the main
    edge-count scaling knob (each notch adds 4 vertices). Notch spans are
    sampled disjoint per side, with margins, so the polygon stays simple."""
    sides = [  # (start, end) corners, CCW
        (np.array([-w / 2, -h / 2]), np.array([w / 2, -h / 2])),
        (np.array([w / 2, -h / 2]), np.array([w / 2, h / 2])),
        (np.array([w / 2, h / 2]), np.array([-w / 2, h / 2])),
        (np.array([-w / 2, h / 2]), np.array([-w / 2, -h / 2])),
    ]
    per_side = [0, 0, 0, 0]
    for _ in range(notches):
        per_side[int(rng.integers(0, 4))] += 1
    pts: List[np.ndarray] = []
    for (p0, p1), k in zip(sides, per_side):
        pts.append(p0)
        if k == 0:
            continue
        length = float(np.linalg.norm(p1 - p0))
        direction = (p1 - p0) / length
        inward = np.array([-direction[1], direction[0]])  # CCW -> inward normal
        # k disjoint [start, end] spans along the side; spans stay within
        # [0.2, 0.8] of the side and depth <= 0.18*min(w,h), which keeps
        # notches from perpendicular sides from intersecting near corners
        # (0.3*side span reach < 0.32*side clearance left by depth)
        slots = np.sort(rng.uniform(0.2, 0.8, size=2 * k)) * length
        min_span = 0.05 * length
        ok = all(slots[2 * i + 1] - slots[2 * i] > min_span for i in range(k)) and all(
            slots[2 * i + 2] - slots[2 * i + 1] > min_span for i in range(k - 1))
        if not ok:  # fall back to an even partition of the side
            slots = np.linspace(0.22, 0.78, 2 * k) * length
        depth = min(w, h) * float(rng.uniform(0.08, 0.18))
        for i in range(k):
            a, b = slots[2 * i], slots[2 * i + 1]
            pts.extend([
                p0 + direction * a,
                p0 + direction * a + inward * depth,
                p0 + direction * b + inward * depth,
                p0 + direction * b,
            ])
    return np.stack(pts)


# ---------------------------------------------------------------------------
# columns: standalone prismatic/cylindrical solids as (walls, cap loops)
# ---------------------------------------------------------------------------


@dataclass
class Column:
    walls: List[Face]
    bot_loop: Loop
    top_loop: Loop
    footprint_center: np.ndarray = field(default_factory=lambda: np.zeros(2))
    footprint_radius: float = 0.0  # bounding-circle radius, for placement


def _ring3d(poly: np.ndarray, z: float) -> np.ndarray:
    return np.concatenate([poly, np.full((len(poly), 1), z)], axis=1)


def _ring_edges(points: np.ndarray) -> Loop:
    n = len(points)
    return [np.stack([points[i], points[(i + 1) % n]]) for i in range(n)]


def column_poly(poly: np.ndarray, z0: float, z1: float) -> Column:
    """Prismatic column over a CCW polygon: standard outward walls, bottom
    cap traverses the ring reversed, top cap forward (the same conventions
    as the basic prism fixture, fixtures.py:59-72)."""
    bot, top = _ring3d(poly, z0), _ring3d(poly, z1)
    n = len(poly)
    walls: List[Face] = []
    for i in range(n):
        j = (i + 1) % n
        walls.append((PLANE, [_ring_edges(np.array([bot[i], bot[j], top[j], top[i]]))]))
    center = poly.mean(axis=0)
    radius = float(np.max(np.linalg.norm(poly - center, axis=1)))
    return Column(walls, _ring_edges(bot[::-1]), _ring_edges(top),
                  footprint_center=center, footprint_radius=radius)


def column_circle(cx: float, cy: float, r_bot: float, z0: float, z1: float,
                  r_top: Optional[float] = None, n_arc: int = 13,
                  phi: float = 0.0) -> Column:
    """Circular column split at angles (phi, phi+pi) into two wall faces —
    the reference's canonical cylinder topology after HLR outline splitting
    (fixtures.py:97-141). ``r_top != r_bot`` makes a conical frustum whose
    walls are Other-type faces (cone surfaces clamp to Other in the dataset
    type table, reference data_para.py:75-80)."""
    rt = r_bot if r_top is None else r_top
    ftype = CYLINDER if abs(rt - r_bot) < 1e-12 else OTHER

    def arc(radius: float, z: float, start: float) -> np.ndarray:
        t = np.linspace(start, start + np.pi, n_arc)
        return np.stack([cx + radius * np.cos(t), cy + radius * np.sin(t),
                         np.full(n_arc, z)], axis=1)

    def rim(radius: float, z: float, ang: float) -> np.ndarray:
        return np.array([cx + radius * np.cos(ang), cy + radius * np.sin(ang), z])

    p_a0, p_a1 = rim(r_bot, z0, phi), rim(rt, z1, phi)
    p_b0, p_b1 = rim(r_bot, z0, phi + np.pi), rim(rt, z1, phi + np.pi)
    line_a_up = np.stack([p_a0, p_a1])
    line_b_down = np.stack([p_b1, p_b0])

    arc_top_1, arc_top_2 = arc(rt, z1, phi), arc(rt, z1, phi + np.pi)
    arc_bot_1, arc_bot_2 = arc(r_bot, z0, phi), arc(r_bot, z0, phi + np.pi)

    side1 = [line_a_up, arc_top_1, line_b_down, arc_bot_1[::-1]]
    side2 = [line_b_down[::-1], arc_top_2, line_a_up[::-1], arc_bot_2[::-1]]
    cap_top = [arc_top_2[::-1], arc_top_1[::-1]]
    cap_bot = [arc_bot_1, arc_bot_2]
    return Column([(ftype, [side1]), (ftype, [side2])], cap_bot, cap_top,
                  footprint_center=np.array([cx, cy]),
                  footprint_radius=max(r_bot, rt))


# ---------------------------------------------------------------------------
# composite assembly
# ---------------------------------------------------------------------------


def assemble(host: Column,
             holes: Sequence[Column] = (),
             bosses: Sequence[Tuple[Column, List[Face]]] = (),
             pockets: Sequence[Tuple[Column, List[Face]]] = ()) -> List[Face]:
    """Compose a host column with through-holes, bosses, and pockets.

    ``bosses``/``pockets`` entries are (column, extra_faces): extra_faces
    carries the child's own cap face plus any recursively stacked features
    (a boss on a boss), already assembled; the child's *donated* loop (boss:
    bottom, pocket: top) is spliced into the host's top cap here.
    """
    faces: List[Face] = []
    bot_loops: List[Loop] = [host.bot_loop]
    top_loops: List[Loop] = [host.top_loop]
    for col in holes:
        faces.extend(col.walls)
        bot_loops.append(col.bot_loop)
        top_loops.append(col.top_loop)
    for col, extra in bosses:
        faces.extend(col.walls)
        faces.extend(extra)
        top_loops.append(col.bot_loop)
    for col, extra in pockets:
        faces.extend(col.walls)
        faces.extend(extra)
        top_loops.append(col.top_loop)
    faces.extend(host.walls)
    faces.append((PLANE, bot_loops))
    faces.append((PLANE, top_loops))
    return faces


def _place_children(rng: np.random.Generator, host_inradius: float,
                    radii: Sequence[float], margin: float = 0.06,
                    tries: int = 64) -> Optional[List[np.ndarray]]:
    """Place disjoint child footprints (bounding circles) strictly inside a
    host of the given inradius. Returns centers, or None if it failed."""
    centers: List[np.ndarray] = []
    for r in radii:
        limit = host_inradius - r - margin
        if limit <= 0:
            return None
        for _ in range(tries):
            c = rng.uniform(-limit, limit, size=2)
            if np.linalg.norm(c) > limit:
                continue
            if all(np.linalg.norm(c - c2) > r + r2 + margin
                   for c2, r2 in zip(centers, radii)):
                centers.append(c)
                break
        else:
            return None
    return centers


def _child_column(rng: np.random.Generator, center: np.ndarray, radius: float,
                  z0: float, z1: float, allow_cone: bool = False) -> Column:
    kind = rng.choice(["rect", "ngon", "circle"])
    if kind == "circle":
        r_top = None
        if allow_cone and rng.uniform() < 0.35:
            r_top = radius * float(rng.uniform(0.45, 0.8))
        return column_circle(center[0], center[1], radius, z0, z1, r_top=r_top,
                             n_arc=int(rng.integers(7, 15)),
                             phi=float(rng.uniform(0, np.pi)))
    if kind == "rect":
        ar = float(rng.uniform(0.6, 1.6))
        w = 2 * radius / np.hypot(1.0, ar)
        poly = poly_rect(w, w * ar)
    else:
        poly = poly_ngon(int(rng.integers(3, 9)), radius,
                         rot=float(rng.uniform(0, np.pi)))
    ang = float(rng.uniform(0, np.pi))
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    return column_poly(poly @ rot.T + center, z0, z1)


# ---------------------------------------------------------------------------
# random family generators: rng -> List[Face]
# ---------------------------------------------------------------------------


def origin_clearance(poly: np.ndarray) -> float:
    """Distance from the origin to the polygon boundary; 0.0 if the origin
    lies outside the polygon. This is the TRUE radius of the child-placement
    disc `_place_children` assumes (children live within `inradius` of the
    origin), so any inradius a host generator claims must not exceed it.

    The even-odd crossing test duplicates reconstruction/mesh.py's
    point_in_polygon on purpose: geometry/ sits below reconstruction/ in
    the dependency order, and corpus generation must not grow an import on
    the reconstruction stack."""
    n = len(poly)
    inside = False
    j = n - 1
    for i in range(n):
        (xi, yi), (xj, yj) = poly[i], poly[j]
        if (yi > 0.0) != (yj > 0.0) and 0.0 < (xj - xi) * (0.0 - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    if not inside:
        return 0.0
    d = np.inf
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        ab = b - a
        t = float(np.clip(-(a @ ab) / (ab @ ab), 0.0, 1.0))
        d = min(d, float(np.linalg.norm(a + t * ab)))
    return d


def _draw_host(rng: np.random.Generator, scale: float) -> Tuple[np.ndarray, float]:
    kind = rng.choice(["rect", "ngon", "convex", "notched"], p=[0.3, 0.25, 0.2, 0.25])
    if kind == "rect":
        w, h = rng.uniform(1.2, 1.9, size=2) * scale
        return poly_rect(w, h), min(w, h) / 2
    if kind == "ngon":
        n = int(rng.integers(5, 13))
        r = float(rng.uniform(0.8, 1.1)) * scale
        return poly_ngon(n, r, rot=float(rng.uniform(0, np.pi))), r * np.cos(np.pi / n)
    if kind == "notched":
        w, h = rng.uniform(1.4, 1.9, size=2) * scale
        poly = poly_notched_rect(rng, w, h, int(rng.integers(1, 5)))
        return poly, 0.3 * min(w, h)
    n = int(rng.integers(5, 9))
    r = float(rng.uniform(0.85, 1.1)) * scale
    return poly_convex(rng, n, r), 0.6 * r


def _host_polygon(rng: np.random.Generator, scale: float) -> Tuple[np.ndarray, float]:
    """A host footprint and its inradius (for child placement).

    The claimed per-kind inradius formulas are NOT all conservative (a
    first-draw poly_convex angle set can pass the min-gap check while a
    >pi gap puts the origin outside the polygon entirely — measured 27% of
    draws claiming more clearance than exists, letting ~2.7% of
    child-bearing samples place a hole/boss crossing the host boundary),
    so the claim is clamped to the measured `origin_clearance` and thin
    hosts are redrawn."""
    poly = claimed = None
    for _ in range(16):
        poly, claimed = _draw_host(rng, scale)
        clear = origin_clearance(poly)
        if clear >= 0.25 * scale:
            return poly, min(claimed, clear)
    # rect hosts always have honest clearance; guaranteed fallback
    w, h = rng.uniform(1.4, 1.9, size=2) * scale
    return poly_rect(w, h), min(w, h) / 2


def gen_extrusion(rng: np.random.Generator, max_notches: int = 7) -> List[Face]:
    """Concave / convex polygon extrusions (L, T, plus, notched, convex)."""
    kind = rng.choice(["lshape", "tshape", "plus", "notched", "convex", "ngon"])
    if kind == "lshape":
        poly = poly_lshape(rng.uniform(0.9, 1.5), rng.uniform(0.9, 1.5),
                           rng.uniform(0.3, 0.6), rng.uniform(0.3, 0.6))
    elif kind == "tshape":
        poly = poly_tshape(rng.uniform(1.2, 1.8), rng.uniform(1.0, 1.6),
                           rng.uniform(0.3, 0.6), rng.uniform(0.4, 0.8))
    elif kind == "plus":
        poly = poly_plus(rng.uniform(0.5, 0.9), rng.uniform(0.5, 0.9),
                         rng.uniform(0.35, 0.6), rng.uniform(0.25, 0.5))
    elif kind == "notched":
        poly = poly_notched_rect(rng, rng.uniform(1.3, 1.9), rng.uniform(1.1, 1.7),
                                 int(rng.integers(1, max_notches + 1)))
    elif kind == "convex":
        poly = poly_convex(rng, int(rng.integers(5, 11)), rng.uniform(0.8, 1.1))
    else:
        poly = poly_ngon(int(rng.integers(3, 13)), rng.uniform(0.7, 1.1),
                         rot=float(rng.uniform(0, np.pi)))
    h = float(rng.uniform(0.4, 1.3))
    col = column_poly(poly, -h / 2, h / 2)
    return assemble(col)


def gen_plate_with_holes(rng: np.random.Generator, max_holes: int = 3) -> List[Face]:
    """Plate with 1..max_holes through-holes (rect/ngon/circle mix): the
    caps become multi-loop faces, the circle holes add concave cylinder
    walls."""
    poly, inradius = _host_polygon(rng, scale=1.0)
    h = float(rng.uniform(0.25, 0.7))
    n_holes = int(rng.integers(1, max_holes + 1))
    radii = [inradius * float(rng.uniform(0.14, 0.3)) for _ in range(n_holes)]
    centers = _place_children(rng, inradius, radii)
    if centers is None:
        return gen_plate_with_holes(rng, max_holes=1)
    host = column_poly(poly, -h / 2, h / 2)
    holes = [_child_column(rng, c, r, -h / 2, h / 2)
             for c, r in zip(centers, radii)]
    return assemble(host, holes=holes)


def gen_boss(rng: np.random.Generator, max_bosses: int = 2,
             tower_p: float = 0.3, hole_p: float = 0.35) -> List[Face]:
    """Plate with 1..max_bosses raised bosses (optionally one stacked into a
    two-level tower, optionally a conical frustum), plus an optional
    through-hole."""
    poly, inradius = _host_polygon(rng, scale=1.0)
    h = float(rng.uniform(0.3, 0.6))
    z1 = h / 2
    n_boss = int(rng.integers(1, max_bosses + 1))
    want_hole = rng.uniform() < hole_p
    radii = [inradius * float(rng.uniform(0.18, 0.34)) for _ in range(n_boss)]
    if want_hole:
        radii.append(inradius * float(rng.uniform(0.12, 0.2)))
    centers = _place_children(rng, inradius, radii)
    if centers is None:
        return gen_boss(rng, max_bosses=1, tower_p=0.0, hole_p=0.0)
    host = column_poly(poly, -h / 2, z1)
    bosses = []
    for c, r in zip(centers[:n_boss], radii[:n_boss]):
        bh = float(rng.uniform(0.25, 0.7))
        col = _child_column(rng, c, r, z1, z1 + bh, allow_cone=True)
        is_cone = col.walls[0][0] == OTHER
        extra: List[Face] = []
        if rng.uniform() < tower_p and not is_cone:
            # stack a smaller second level on the boss (fits inside the
            # boss's top ring: inradius of any child kind is >= 0.5 * r)
            col2 = _child_column(rng, c, r * float(rng.uniform(0.3, 0.45)),
                                 z1 + bh, z1 + bh + float(rng.uniform(0.2, 0.5)))
            extra.extend(col2.walls)
            extra.append((PLANE, [col2.top_loop]))
            extra.append((PLANE, [col.top_loop, col2.bot_loop]))
        else:
            extra.append((PLANE, [col.top_loop]))
        bosses.append((col, extra))
    holes = [_child_column(rng, c, r, -h / 2, z1)
             for c, r in zip(centers[n_boss:], radii[n_boss:])]
    return assemble(host, holes=holes, bosses=bosses)


def gen_pocket(rng: np.random.Generator, max_pockets: int = 2) -> List[Face]:
    """Plate with 1..max_pockets blind pockets sunk into the top face."""
    poly, inradius = _host_polygon(rng, scale=1.0)
    h = float(rng.uniform(0.5, 0.9))
    z1 = h / 2
    n_pockets = int(rng.integers(1, max_pockets + 1))
    radii = [inradius * float(rng.uniform(0.16, 0.32)) for _ in range(n_pockets)]
    centers = _place_children(rng, inradius, radii)
    if centers is None:
        return gen_pocket(rng, max_pockets=1)
    host = column_poly(poly, -h / 2, z1)
    pockets = []
    for c, r in zip(centers, radii):
        depth = h * float(rng.uniform(0.35, 0.7))
        col = _child_column(rng, c, r, z1 - depth, z1)
        pockets.append((col, [(PLANE, [col.bot_loop])]))
    return assemble(host, pockets=pockets)


def gen_stepped_shaft(rng: np.random.Generator, max_levels: int = 3) -> List[Face]:
    """Coaxial stacked cylinders of decreasing radius (a turned shaft):
    cylinder-heavy samples with annular multi-loop planar faces."""
    levels = int(rng.integers(2, max_levels + 1))
    r = float(rng.uniform(0.7, 1.0))
    z = -0.6
    cols = []
    for _ in range(levels):
        dz = float(rng.uniform(0.3, 0.6))
        cols.append(column_circle(0.0, 0.0, r, z, z + dz,
                                  n_arc=int(rng.integers(9, 15)),
                                  phi=float(rng.uniform(0, np.pi))))
        z += dz
        r *= float(rng.uniform(0.5, 0.75))
    faces: List[Face] = [(PLANE, [cols[0].bot_loop])]
    for lower, upper in zip(cols, cols[1:]):
        faces.extend(lower.walls)
        # annular shoulder: lower top ring + upper bottom ring
        faces.append((PLANE, [lower.top_loop, upper.bot_loop]))
    faces.extend(cols[-1].walls)
    faces.append((PLANE, [cols[-1].top_loop]))
    return faces
