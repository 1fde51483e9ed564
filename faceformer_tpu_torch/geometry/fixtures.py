"""Synthetic wireframe fixtures: parametric solids -> reference-format JSON samples.

A copy of faceformer_tpu/geometry/fixtures.py, kept so the port imports
nothing of the JAX package: the same rng draws the same samples.

The reference's training data comes from OpenCascade HLR projections of ABC
STEP files (dataset/prepare_data.py). For tests, benchmarks, and CAD-free
smoke training we generate structurally identical samples from analytic
solids: every face is an ordered loop of oriented coedges, edges are sorted
lexicographically and indexed, loops are rolled/sorted canonically, and the
JSON schema matches dataset/README.md:3-20 exactly:

    { "edges": [...], "edges3d": [...], "shrinked_edges": [...],
      "faces_indices": [[type, [loop, ...]], ...],
      "dominant_directions": [x, y, z projected], "pairings": {i: j} }

No hidden-line removal is performed — all faces of the solid are emitted,
which yields a *harder* (more cluttered) wireframe than true HLR output but
preserves every topological invariant the models and metrics rely on.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from faceformer_tpu_torch.geometry.enclosedness import is_face_enclosed

PLANE, CYLINDER, OTHER = 0, 1, 2


# ---------------------------------------------------------------------------
# solids: (vertices, faces) where faces = [(type, [loops of oriented edges])]
# an oriented edge is a 3D polyline (list of 3D points); loops chain
# end-to-start around the face.
# ---------------------------------------------------------------------------


def make_box(w: float = 1.0, h: float = 1.0, d: float = 1.0):
    """Axis-aligned box centered at the origin: 6 planar quad faces."""
    x, y, z = w / 2, h / 2, d / 2
    v = np.array(
        [
            [-x, -y, -z], [x, -y, -z], [x, y, -z], [-x, y, -z],
            [-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z],
        ]
    )
    quads = [
        (0, 3, 2, 1),  # bottom (z-)
        (4, 5, 6, 7),  # top (z+)
        (0, 1, 5, 4),  # front (y-)
        (2, 3, 7, 6),  # back (y+)
        (1, 2, 6, 5),  # right (x+)
        (3, 0, 4, 7),  # left (x-)
    ]
    faces = [(PLANE, [_polygon_loop(v, q)]) for q in quads]
    return faces


def make_prism(n_sides: int = 6, radius: float = 0.8, height: float = 1.0):
    """Regular n-gon prism: 2 cap planes + n side planes."""
    theta = 2 * np.pi * np.arange(n_sides) / n_sides
    bottom = np.stack([radius * np.cos(theta), radius * np.sin(theta), -height / 2 * np.ones(n_sides)], axis=1)
    top = bottom + np.array([0.0, 0.0, height])
    faces = [
        (PLANE, [_ring_loop(bottom[::-1])]),
        (PLANE, [_ring_loop(top)]),
    ]
    for i in range(n_sides):
        j = (i + 1) % n_sides
        quad = np.array([bottom[i], bottom[j], top[j], top[i]])
        faces.append((PLANE, [_ring_loop(quad)]))
    return faces


def make_lblock(a: float = 1.0, b: float = 1.0, cut: float = 0.45, height: float = 0.8):
    """L-shaped extrusion: 8 planar faces (6-gon caps + 6 sides)."""
    poly = np.array(
        [
            [0, 0], [a, 0], [a, b - cut], [a - cut, b - cut], [a - cut, b], [0, b]
        ],
        dtype=float,
    )
    poly -= poly.mean(axis=0)
    bottom = np.concatenate([poly, np.full((6, 1), -height / 2)], axis=1)
    top = np.concatenate([poly, np.full((6, 1), height / 2)], axis=1)
    faces = [
        (PLANE, [_ring_loop(bottom[::-1])]),
        (PLANE, [_ring_loop(top)]),
    ]
    for i in range(6):
        j = (i + 1) % 6
        quad = np.array([bottom[i], bottom[j], top[j], top[i]])
        faces.append((PLANE, [_ring_loop(quad)]))
    return faces


def make_cylinder(radius: float = 0.6, height: float = 1.2, n_arc: int = 17,
                  split_axis: float = 0.0):
    """Cylinder split by two vertical outlines into the reference's canonical
    topology: 2 half-cylinder side faces (type 1, each bounded by 2 straight
    outlines + 2 arcs) and 2 planar caps (each bounded by 2 arcs). This is the
    structure the wireframe reconstructor expects
    (reconstruction/reconstruct_to_wireframe.py:44-143).

    The split-cylinder construction itself lives in ``solids.column_circle``
    (the composite-corpus generator shares the same canonical topology)."""
    from faceformer_tpu_torch.geometry import solids

    col = solids.column_circle(0.0, 0.0, radius, -height / 2, height / 2,
                               n_arc=n_arc, phi=split_axis)
    return col.walls + [(PLANE, [col.top_loop]), (PLANE, [col.bot_loop])]


def _polygon_loop(vertices: np.ndarray, ring: Sequence[int]) -> List[np.ndarray]:
    return [np.stack([vertices[ring[i]], vertices[ring[(i + 1) % len(ring)]]]) for i in range(len(ring))]


def _ring_loop(points: np.ndarray) -> List[np.ndarray]:
    n = len(points)
    return [np.stack([points[i], points[(i + 1) % n]]) for i in range(n)]


def make_plate_with_hole(a: float = 1.6, b: float = 1.2, height: float = 0.4,
                         hole_w: float = 0.6, hole_d: float = 0.4):
    """Rectangular plate with a rectangular through-hole: the top and bottom
    faces carry TWO loops each (outer boundary + hole boundary) — the
    multi-loop face case the reference's ABC data contains."""
    outer = np.array([[-a / 2, -b / 2], [a / 2, -b / 2],
                      [a / 2, b / 2], [-a / 2, b / 2]])
    hole = np.array([[-hole_w / 2, -hole_d / 2], [hole_w / 2, -hole_d / 2],
                     [hole_w / 2, hole_d / 2], [-hole_w / 2, hole_d / 2]])
    z0, z1 = -height / 2, height / 2

    def ring3d(poly2d, z):
        return np.concatenate([poly2d, np.full((len(poly2d), 1), z)], axis=1)

    ob, ot = ring3d(outer, z0), ring3d(outer, z1)
    hb, ht = ring3d(hole, z0), ring3d(hole, z1)

    faces = [
        # bottom: outer loop one way + hole loop the other (coherent with
        # the side/wall traversals)
        (PLANE, [_ring_loop(ob[::-1]), _ring_loop(hb)]),
        # top: outer loop + hole loop reversed
        (PLANE, [_ring_loop(ot), _ring_loop(ht[::-1])]),
    ]
    for i in range(4):
        j = (i + 1) % 4
        faces.append((PLANE, [_ring_loop(np.array([ob[i], ob[j], ot[j], ot[i]]))]))
    for i in range(4):
        j = (i + 1) % 4
        # hole walls traverse opposite the outer sides' convention
        faces.append((PLANE, [_ring_loop(np.array([hb[j], hb[i], ht[i], ht[j]]))]))
    return faces


def make_frustum(r_bottom: float = 0.8, r_top: float = 0.45, height: float = 1.0,
                 n_arc: int = 17, split_axis: float = 0.0):
    """Conical frustum split by two slanted outlines, mirroring the cylinder
    topology but with CONE side surfaces — genuine Other-type faces after the
    dataset's type clamp (cone = GeomAbs type 2, data_para.py:75-80).
    Delegates to ``solids.column_circle``, which emits Other-type walls
    whenever ``r_top != r_bot``."""
    from faceformer_tpu_torch.geometry import solids

    col = solids.column_circle(0.0, 0.0, r_bottom, -height / 2, height / 2,
                               r_top=r_top, n_arc=n_arc, phi=split_axis)
    return col.walls + [(PLANE, [col.top_loop]), (PLANE, [col.bot_loop])]


SOLID_BUILDERS = {
    "box": make_box,
    "prism": make_prism,
    "lblock": make_lblock,
    "cylinder": make_cylinder,
    "plate_with_hole": make_plate_with_hole,
    "frustum": make_frustum,
}


# ---------------------------------------------------------------------------
# camera + projection
# ---------------------------------------------------------------------------


def camera_basis(theta_deg: float, phi_deg: float) -> np.ndarray:
    """Orthonormal (right, up, forward) rows for a camera looking at the
    origin from spherical angles (reference camera convention:
    dataset/utils/projection_utils.py:13-45)."""
    theta, phi = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    forward = -np.array(
        [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
    )
    world_up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, world_up)
    nr = np.linalg.norm(right)
    if nr < 1e-9:  # looking straight down/up
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    up = np.cross(right, forward)
    return np.stack([right, up, forward])


def project_polyline(pts: np.ndarray, basis: np.ndarray, focus: float = 0.0,
                     cam_dist: float = 4.0) -> np.ndarray:
    """Project 3D points into camera space (x, y, depth). focus == 0 means
    orthographic (reference: projection_utils.py:67-70); otherwise a simple
    perspective divide with the camera ``cam_dist`` away from the origin."""
    cam = pts @ basis.T  # rows: right/up/forward components
    if focus == 0.0:
        return cam
    depth = cam_dist + cam[:, 2]
    scale = focus / np.maximum(depth, 1e-6)
    return np.stack([cam[:, 0] * scale, cam[:, 1] * scale, cam[:, 2]], axis=1)


# ---------------------------------------------------------------------------
# canonical sample assembly (mirrors dataset/prepare_data.py:49-181 semantics)
# ---------------------------------------------------------------------------


# canonical ordering comes from ONE place — these comparators define the
# dataset's canonical form, so a drifting duplicate would silently break
# corpus/reference parity
from faceformer_tpu_torch.geometry.canonical import (  # noqa: E402
    comp_points as _comp_points,
    comp_point_seqs as _comp_edges,
)


def build_sample(
    faces: Sequence[Tuple[int, List[List[np.ndarray]]]],
    theta: float = 30.0,
    phi: float = 35.0,
    focus: float = 0.0,
    coedge: bool = True,
    no_face_type: bool = False,
    direction_token: bool = False,
    tol: float = 2e-4,
    round_decimals: int = 8,
) -> Dict:
    """Assemble one reference-format JSON sample from analytic faces.

    coedge=True emits each undirected edge once per face traversal (two
    directions), matching the `ours`/`seq2seq+coedge` data flavors; False
    combines coedges into one canonical-direction edge per undirected edge
    (the `--combine_coedge` flavor, prepare_data.py:104-111,145-147).
    direction_token=True stores each undirected edge once in its
    first-traversal direction and emits (index, orientation) pairs per face
    (the `--direction_token` flavor, prepare_data.py:183-245; orientation 1
    means the face traverses the stored polyline reversed).
    """
    basis = camera_basis(theta, phi)
    scale = _normalization_scale(faces)

    # project every oriented edge of every face loop
    projected_faces = []  # [(type, [[(edge2d, edge3d), ...] per loop])]
    for ftype, loops in faces:
        ploops = []
        for loop in loops:
            pedges = []
            for seg in loop:
                cam = project_polyline(np.asarray(seg, dtype=float) * scale, basis, focus)
                edge2d = [[round(float(x), round_decimals), round(float(y), round_decimals)] for x, y, _ in cam]
                edge3d = [[round(float(c), round_decimals) for c in p] for p in cam]
                pedges.append((edge2d, edge3d))
            ploops.append(pedges)
        projected_faces.append((ftype, ploops))

    # collect unique directed (coedge) or undirected (combined) edges
    records: List[Dict] = []  # {points, points3d}
    key_to_record: Dict[tuple, int] = {}

    def intern_edge(edge2d, edge3d) -> int:
        key = tuple(map(tuple, edge2d))
        if key in key_to_record:
            return key_to_record[key]
        records.append({"points": edge2d, "points3d": edge3d})
        key_to_record[key] = len(records) - 1
        return key_to_record[key]

    face_records: List[Tuple[int, List[List[int]]]] = []
    for ftype, ploops in projected_faces:
        loops_rec = []
        for pedges in ploops:
            if direction_token:
                # store the edge raw in its first-traversal direction; a
                # later traversal of the reversed polyline reuses the record
                # with orientation bit 1
                pairs = []
                for e2, e3 in pedges:
                    rev_key = tuple(map(tuple, e2[::-1]))
                    if rev_key in key_to_record:
                        pairs.append((key_to_record[rev_key], 1))
                    else:
                        pairs.append((intern_edge(e2, e3), 0))
                loops_rec.append(pairs)
            elif coedge:
                loops_rec.append([intern_edge(e2, e3) for e2, e3 in pedges])
            else:
                canon = []
                for e2, e3 in pedges:
                    if _comp_points(e2[0], e2[-1]) > 0:
                        e2, e3 = e2[::-1], e3[::-1]
                    canon.append(intern_edge(e2, e3))
                loops_rec.append(canon)
        face_records.append((ftype, loops_rec))

    # sort edges lexicographically and reindex (prepare_data.py:128-133)
    order = sorted(range(len(records)), key=functools.cmp_to_key(
        lambda i, j: _comp_edges(records[i]["points"], records[j]["points"])))
    remap = {old: new for new, old in enumerate(order)}
    edges = [records[i]["points"] for i in order]
    edges3d = [records[i]["points3d"] for i in order]
    if direction_token:
        face_records = [
            (ftype, [[(remap[i], o) for i, o in loop] for loop in loops])
            for ftype, loops in face_records
        ]
    else:
        face_records = [
            (ftype, [[remap[i] for i in loop] for loop in loops])
            for ftype, loops in face_records
        ]

    # canonicalize loops via the enclosedness walk (prepare_data.py:150-168)
    faces_indices = []
    for ftype, loops in face_records:
        flat = [i for loop in loops for i in loop]
        if direction_token:
            found = is_face_enclosed(edges, flat, tol)
            if not found:
                raise AssertionError("fixture face not enclosed — degenerate view")
            rolled = [
                np.roll(lp, -int(np.argmin([t[0] for t in lp])), axis=0).tolist()
                for lp in found
            ]
            rolled = sorted(rolled, key=lambda lp: lp[0][0])
            faces_indices.append(rolled)  # no face type in this flavor
        elif coedge:
            found = is_face_enclosed(edges, flat, tol)
            if not found:
                raise AssertionError("fixture face not enclosed — degenerate view")
            rolled = [
                np.roll(lp, -int(np.argmin(lp)), axis=0).tolist() for lp in found
            ]
            rolled = sorted(rolled, key=lambda lp: lp[0])
            faces_indices.append(rolled if no_face_type else [int(ftype), rolled])
        else:
            faces_indices.append(sorted(flat))

    if direction_token:
        faces_indices = sorted(faces_indices, key=lambda f: f[0][0][0])
    elif coedge:
        key = (lambda f: f[0][0]) if no_face_type else (lambda f: f[1][0][0])
        faces_indices = sorted(faces_indices, key=key)
    else:
        faces_indices = sorted(faces_indices)

    # pairings: lower coedge index -> its reversed twin (prepare_data.py:258-263).
    # One dict lookup per edge: interning guarantees point sequences are
    # unique, so the reversed twin (if any) is a single exact-key hit —
    # equivalent to the old O(E^2) scan (j > i also excludes palindromes,
    # exactly as the old upper-triangle loop did)
    index_of = {tuple(map(tuple, e)): i for i, e in enumerate(edges)}
    pairings = {}
    for i, e in enumerate(edges):
        j = index_of.get(tuple(map(tuple, e[::-1])))
        if j is not None and j > i:
            pairings[str(i)] = j

    dominant_directions = [
        project_polyline(np.array([[0.0, 0, 0], [1.0 if k == 0 else 0.0, 1.0 if k == 1 else 0.0, 1.0 if k == 2 else 0.0]]), basis, focus)
        for k in range(3)
    ]
    dominant_directions = [
        (d[1] - d[0]).tolist() for d in dominant_directions
    ]

    return {
        "edges": edges,
        "edges3d": edges3d,
        "shrinked_edges": edges,  # viz-only field; fixtures reuse the edges
        "faces_indices": faces_indices,
        "dominant_directions": dominant_directions,
        "pairings": pairings,
    }


def _normalization_scale(faces) -> float:
    """Scale so the bbox diagonal is 2, like prepare_data.py:294-300."""
    pts = np.concatenate([np.asarray(seg) for _, loops in faces for loop in loops for seg in loop])
    extent = pts.max(axis=0) - pts.min(axis=0)
    return 2.0 / float(np.linalg.norm(extent))


def random_solid(rng: np.random.Generator, profile: str = "classic"):
    """Sample a random solid's faces from the given family profile.

    "classic" draws only the six basic families above (the round-1/2 test
    corpus). "rich" mixes in the composite families (multi-hole plates,
    bosses, pockets, towers, notched/concave extrusions, stepped shafts —
    geometry/solids.py), which reach the reference's full `ours` dims
    (216 coedges / 42 faces / 36-token face rows, configs/ours.yml:20-22).
    """
    from faceformer_tpu_torch.geometry import solids

    if profile == "rich":
        kind = rng.choice(
            ["classic", "extrusion", "plate_holes", "boss", "pocket", "shaft"],
            p=[0.18, 0.22, 0.2, 0.2, 0.12, 0.08])
        if kind == "extrusion":
            return solids.gen_extrusion(rng)
        if kind == "plate_holes":
            return solids.gen_plate_with_holes(rng)
        if kind == "boss":
            return solids.gen_boss(rng)
        if kind == "pocket":
            return solids.gen_pocket(rng)
        if kind == "shaft":
            return solids.gen_stepped_shaft(rng)
        # fall through to a classic draw
    elif profile != "classic":
        raise ValueError(f"unknown fixture profile {profile!r}")

    kind = rng.choice(list(SOLID_BUILDERS))
    if kind == "box":
        return make_box(*rng.uniform(0.5, 1.5, size=3))
    if kind == "prism":
        return make_prism(int(rng.integers(3, 8)), rng.uniform(0.4, 1.0), rng.uniform(0.5, 1.5))
    if kind == "lblock":
        return make_lblock(rng.uniform(0.8, 1.4), rng.uniform(0.8, 1.4), rng.uniform(0.25, 0.55), rng.uniform(0.5, 1.2))
    if kind == "plate_with_hole":
        return make_plate_with_hole(
            rng.uniform(1.2, 1.8), rng.uniform(0.9, 1.4), rng.uniform(0.3, 0.6),
            rng.uniform(0.4, 0.7), rng.uniform(0.3, 0.5))
    if kind == "frustum":
        return make_frustum(rng.uniform(0.5, 0.9), rng.uniform(0.25, 0.45),
                            rng.uniform(0.6, 1.4),
                            split_axis=rng.uniform(0, np.pi))
    return make_cylinder(rng.uniform(0.3, 0.8), rng.uniform(0.6, 1.6), split_axis=rng.uniform(0, np.pi))


def random_sample(rng: np.random.Generator, coedge: bool = True,
                  no_face_type: bool = False, direction_token: bool = False,
                  focus: float = 0.0, max_tries: int = 8,
                  profile: str = "classic") -> Dict:
    """One random solid under a random camera; retries degenerate views
    (reference retries random cameras 5x, prepare_data.py:303-319)."""
    for _ in range(max_tries):
        faces = random_solid(rng, profile=profile)
        theta = float(rng.uniform(0, 360))
        phi = float(rng.uniform(22.5, 67.5))
        try:
            return build_sample(faces, theta=theta, phi=phi, focus=focus,
                                coedge=coedge, no_face_type=no_face_type,
                                direction_token=direction_token)
        except AssertionError:
            continue
    raise RuntimeError("could not generate a non-degenerate fixture")


