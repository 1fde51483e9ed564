"""OpenCascade-backed dataset generation: ABC STEP files -> training JSONs.

A copy of faceformer_tpu/tools/occ_pipeline.py with its imports renamed to
the port's modules, but for one change: TopoMapper merges the edge pairs
left by sewn-edge removal in the order it found them, each pair in its
edges' order, where the JAX module orders them by object hash (address).
Its OCC paths need pythonocc-core, and without it raise as the JAX
module's do.

Requires `pythonocc-core` (not bundled; the synthetic generator
faceformer_tpu_torch/tools/synthetic_data.py covers CAD-free workflows). Implements
the reference generation algorithm (dataset/prepare_data.py,
dataset/utils/TopoMapper.py):

  1. read STEP (bounded time), reject multi-solid / >64-edge shapes,
     normalize to bbox-diagonal 2;
  2. HLR-project to find outline edges; split the solid's faces by those
     outlines (iterated until the edge count converges, with tolerance
     escalation on failed splits);
  3. map faces -> ordered oriented edges via wire exploration; discretize and
     project every edge to 2D (+ camera-space 3D);
  4. find sewn edges (an edge used twice within one face), remove them and
     merge their faces, merging newly-adjacent edge pairs when no third edge
     meets the shared vertex;
  5. canonical JSON emission (edges sorted lexicographically, loops rolled
     to min index, faces sorted by first index, enclosedness asserted, coedge
     pairings recorded) lives in tools/prepare_data.py::assemble_json; this
     module supplies the topology records it consumes.

Camera conventions follow projection_utils.py: random spherical poses with
focus 3-5 (perspective) or orthographic when focus == 0.
"""

from __future__ import annotations

import os
import signal
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def require_occ():
    try:
        import OCC.Core  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "pythonocc-core is required for STEP/HLR dataset generation; "
            "use faceformer_tpu_torch.tools.synthetic_data for CAD-free data"
        ) from exc


# ---------------------------------------------------------------------------
# STEP reading (bounded time, reference read_step_file.py:9-55)
# ---------------------------------------------------------------------------


class _ReadTimeout(Exception):
    pass


def read_step_file(filename: str, timeout_s: int = 5, filter_num_shape: int = 10):
    """Read a STEP file into a (shape, num_root_shapes) pair within a time
    budget (SIGALRM; the reference used a watchdog subprocess)."""
    require_occ()
    from OCC.Core.IFSelect import IFSelect_RetDone
    from OCC.Core.STEPControl import STEPControl_Reader
    from OCC.Extend.TopologyUtils import list_of_shapes_to_compound

    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)

    def _alarm(signum, frame):
        raise _ReadTimeout(filename)

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(timeout_s)
    try:
        reader = STEPControl_Reader()
        if reader.ReadFile(filename) != IFSelect_RetDone:
            raise AssertionError("can't read file")
        if not reader.TransferRoots():
            raise AssertionError("transfer failed")
        nbs = reader.NbShapes()
        if nbs == 0:
            raise AssertionError("no shape to transfer")
        if nbs == 1:
            return reader.Shape(1), nbs
        if nbs > filter_num_shape:
            return None, nbs
        shapes = [reader.Shape(k) for k in range(1, nbs + 1)]
        shapes = [s for s in shapes if not s.IsNull()]
        compound, _ = list_of_shapes_to_compound(shapes)
        return compound, nbs
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# projection (reference projection_utils.py)
# ---------------------------------------------------------------------------


def generate_random_camera_pos(seed=None, rng=None):
    """Random spherical camera: focus 3-5, radius 1.25-1.5, elevation
    22.5-67.5 deg (reference projection_utils.py:10-20).

    Documented deviation (PARITY.md): the reference reseeds the GLOBAL
    np.random with the constant args.seed on every call
    (projection_utils.py:11-12), so every shape — and every degenerate-
    camera re-roll — draws the same camera, defeating the flag's purpose.
    Pass an ``rng`` (np.random.Generator) for genuinely per-shape/per-
    attempt cameras; a plain int ``seed`` reproduces a deterministic draw
    for that seed (without touching global state)."""
    if rng is None:
        rng = np.random.default_rng(seed)

    def randnum(low, high):
        return float(rng.random()) * (high - low) + low

    focus = randnum(3, 5)
    radius = randnum(1.25, 1.5)
    phi = randnum(22.5, 67.5)
    theta = randnum(0, 360)
    return focus, pose_spherical(theta, phi, radius)


def pose_spherical(theta_deg, phi_deg, radius):
    """Camera-to-world matrix (reference projection_utils.py:22-45)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    phi, theta = np.deg2rad(phi_deg), np.deg2rad(theta_deg)
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1:3, 1:3] = [[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]]
    rot_theta = np.eye(4, dtype=np.float32)
    rot_theta[0:2, 0:2] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    return flip @ rot_theta @ rot_phi @ c2w


@dataclass
class ProjectionArgs:
    location: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    direction: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    focus: float = 3.0
    tol: float = 1e-4
    pose: Optional[np.ndarray] = None
    discretize_last: bool = False


def _projector(args: ProjectionArgs):
    from OCC.Core.gp import gp_Ax2, gp_Dir, gp_Pnt
    from OCC.Core.HLRAlgo import HLRAlgo_Projector

    if args.pose is not None:
        pose = args.pose
        ax = gp_Ax2(gp_Pnt(*pose[:3, -1]), gp_Dir(*pose[:3, -2]), gp_Dir(*pose[:3, 0]))
    else:
        ax = gp_Ax2(gp_Pnt(*args.location), gp_Dir(*args.direction))
    if args.focus == 0:
        return HLRAlgo_Projector(ax)
    return HLRAlgo_Projector(ax, args.focus)


def project_shapes(shapes, args: ProjectionArgs):
    from OCC.Core.HLRBRep import HLRBRep_Algo, HLRBRep_HLRToShape

    hlr = HLRBRep_Algo()
    for shape in shapes if isinstance(shapes, list) else [shapes]:
        hlr.Add(shape)
    hlr.Projector(_projector(args))
    hlr.Update()
    return HLRBRep_HLRToShape(hlr)


def project_points(points, args: ProjectionArgs):
    from OCC.Core.gp import gp_Pnt

    projector = _projector(args)
    return [projector.Project(gp_Pnt(*p)) for p in points]


def d3_to_d2(points):
    return [tuple(p[:2]) for p in points]


def discretize_compound(compound, tol):
    from OCC.Extend.TopologyUtils import TopologyExplorer, discretize_edge

    return [d3_to_d2(discretize_edge(e, tol))
            for e in TopologyExplorer(compound).edges()]


# ---------------------------------------------------------------------------
# topology mapping (reference TopoMapper.py / Face.py / Edge.py)
# ---------------------------------------------------------------------------

FACE_TYPE_MERGED = 10  # faces of differing types merged across a sewn edge


@dataclass
class EdgeRecord:
    edge: object  # TopoDS_Edge
    faces: List["FaceRecord"] = field(default_factory=list)
    orientations: List[int] = field(default_factory=list)
    dedge: Optional[list] = None  # 2D polyline
    dedge3d: Optional[list] = None
    index: Optional[int] = None

    @property
    def key(self):
        return hash(self.edge)

    def oriented(self, orientation, is_3d=False):
        pts = self.dedge3d if is_3d else self.dedge
        return pts[::-1] if orientation else pts

    def same_orientation(self, other) -> bool:
        d1 = np.sum(np.abs(np.asarray(self.dedge[-1]) - np.asarray(other.dedge[0])))
        d2 = np.sum(np.abs(np.asarray(other.dedge[-1]) - np.asarray(self.dedge[0])))
        return d1 < d2


@dataclass
class FaceRecord:
    face: object  # TopoDS_Face
    face_type: int
    parameters: Optional[dict]
    edges: List[EdgeRecord] = field(default_factory=list)
    orientations: List[int] = field(default_factory=list)

    @property
    def keys(self):
        return [e.key for e in self.edges]

    def add(self, edge: EdgeRecord, orientation: int):
        self.edges.append(edge)
        self.orientations.append(orientation)

    def remove_key(self, key):
        ind = self.keys.index(key)
        del self.edges[ind]
        del self.orientations[ind]

    def roll(self, n):
        self.edges = self.edges[n:] + self.edges[:n]
        self.orientations = self.orientations[n:] + self.orientations[:n]

    def oriented_dedges(self, is_3d=False):
        return [e.oriented(o, is_3d) for e, o in zip(self.edges, self.orientations)]


def _face_record(face) -> FaceRecord:
    from OCC.Core.BRepAdaptor import BRepAdaptor_Surface
    from OCC.Core.GeomAbs import GeomAbs_Cylinder, GeomAbs_Plane

    surface = BRepAdaptor_Surface(face)
    face_type = int(surface.GetType())
    parameters = None
    if face_type == int(GeomAbs_Plane):
        plane = surface.Surface().Plane()
        parameters = {"Coefficients": plane.Coefficients()}
    elif face_type == int(GeomAbs_Cylinder):
        cyl = surface.Surface().Cylinder()
        parameters = {"Coefficients": cyl.Coefficients(), "Radius": cyl.Radius()}
    return FaceRecord(face, face_type, parameters)


class TopoMapper:
    """Edge/face topology of an HLR-outlined solid (reference TopoMapper.py)."""

    def __init__(self, shape, args: ProjectionArgs):
        require_occ()
        self.shape = shape
        self.args = args
        self.tol = args.tol
        outline_edges = self._find_outline_edges()
        self.full_topo = self._add_outline_edges(outline_edges)
        self._construct_mapping()
        self._project(args.discretize_last)
        self._remove_sewn_edges(self._find_sewn_edges())

    # -- outline splitting ----------------------------------------------------

    def _find_outline_edges(self):
        from OCC.Extend.TopologyUtils import TopologyExplorer

        outline = project_shapes(self.shape, self.args).OutLineVCompound3d()
        return list(TopologyExplorer(outline).edges()) if outline else []

    def _add_outline_edges(self, outline_edges):
        """Split faces by outline curves, iterating until the edge count
        converges; escalate tolerance when a split fails
        (reference TopoMapper.py:58-83)."""
        from OCC.Core.BRepFeat import BRepFeat_SplitShape
        from OCC.Core.ShapeFix import ShapeFix_ShapeTolerance
        from OCC.Core.TopTools import TopTools_SequenceOfShape
        from OCC.Extend.TopologyUtils import TopologyExplorer

        if not outline_edges:
            return TopologyExplorer(self.shape)

        def num_edges(split):
            probing = split.Shape()
            return BRepFeat_SplitShape(probing), len(list(TopologyExplorer(probing).edges()))

        def add_edge(split, edge, count):
            seq = TopTools_SequenceOfShape()
            seq.Append(edge)
            ok = split.Add(seq)
            split, new_count = num_edges(split)
            return split, new_count, ok and new_count > count

        prev_total = 0
        while True:
            split = BRepFeat_SplitShape(self.shape)
            split, count = num_edges(split)
            for edge in outline_edges:
                probing = split.Shape()
                backup = BRepFeat_SplitShape(probing)
                split = BRepFeat_SplitShape(probing)
                split, count, ok = add_edge(split, edge, count)
                if not ok:
                    ShapeFix_ShapeTolerance().SetTolerance(edge, 1)
                    split, count, ok = add_edge(backup, edge, count)
                    if not ok:
                        raise RuntimeError("failed to add splitting outline")
            if prev_total == count:
                break
            prev_total = count
        return TopologyExplorer(split.Shape())

    # -- edge/face graph ---------------------------------------------------------

    def _ordered_face_edges(self, topo, face):
        from OCC.Extend.TopologyUtils import WireExplorer

        edges = []
        for wire in topo.wires_from_face(face):
            edges += list(WireExplorer(wire).ordered_edges())
        return edges

    def _construct_mapping(self):
        self.all_edges: Dict[int, EdgeRecord] = {}
        self.all_faces: Dict[int, FaceRecord] = {}
        for face in self.full_topo.faces():
            record = _face_record(face)
            self.all_faces[hash(face)] = record
            for edge in self._ordered_face_edges(self.full_topo, face):
                key = hash(edge)
                if key in self.all_edges:
                    erec = self.all_edges[key]
                else:
                    erec = EdgeRecord(edge)
                    self.all_edges[key] = erec
                erec.faces.append(record)
                erec.orientations.append(edge.Orientation())
                record.add(erec, edge.Orientation())

    def _project(self, discretize_last=False):
        from OCC.Extend.TopologyUtils import discretize_edge

        for erec in list(self.all_edges.values()):
            if not discretize_last:
                pts3d = discretize_edge(erec.edge, self.args.tol)
                erec.dedge3d = [tuple(p) for p in project_points(pts3d, self.args)]
                erec.dedge = d3_to_d2(erec.dedge3d)
                continue
            compound = project_shapes(erec.edge, self.args).VCompound()
            if compound is None:
                del self.all_edges[erec.key]
                for face in erec.faces:
                    face.remove_key(erec.key)
                continue
            erec.dedge = discretize_compound(compound, self.tol)[0]
            # documented deviation: the reference leaves dedge3d None here,
            # so --discretize_last crashes its per-coedge path on the first
            # reversed edge (Edge.py:29-30 does None[::-1]) — it only ever
            # worked with --combine_coedge. Discretize the 3D curve
            # directly so edges3d stays populated (sampling may differ
            # from the projected-compound dedge; consumers use edges3d as
            # standalone 3D ground truth, never zipped pointwise).
            pts3d = discretize_edge(erec.edge, self.args.tol)
            erec.dedge3d = [tuple(p) for p in project_points(pts3d, self.args)]

    # -- sewn edges -----------------------------------------------------------------

    def _find_sewn_edges(self) -> List[int]:
        """Edges used twice within one face of the ORIGINAL (unsplit) shape
        (reference TopoMapper.py:118-143)."""
        from OCC.Extend.TopologyUtils import TopologyExplorer

        sewn = []
        topo = TopologyExplorer(self.shape)
        for face in topo.faces():
            seen = []
            for edge in self._ordered_face_edges(topo, face):
                key = hash(edge)
                if key in seen:
                    sewn.append(key)
                else:
                    seen.append(key)
        return sewn

    def _remove_sewn_edges(self, sewn_keys: List[int]):
        # candidate pairs in first-seen order, each ordered by its edges'
        # order in all_edges: keys are object hashes, so a set of them, or
        # a pair sorted by them, would order the merges by address
        rank = {key: i for i, key in enumerate(self.all_edges)}
        candidates: Dict[Tuple[int, int], None] = {}
        for key in sewn_keys:
            if key not in self.all_edges:
                continue
            sewn = self.all_edges[key]
            for face in sewn.faces:
                face.roll(face.keys.index(key))
            result = sewn.faces[0]
            for face in sewn.faces[1:]:
                pairs = self._merge_faces(result, face, key)
                if pairs:
                    candidates.update(dict.fromkeys(
                        tuple(sorted(p, key=lambda k: rank.get(k, len(rank))))
                        for p in pairs))

        for key1, key2 in candidates:
            if key1 not in self.all_edges or key2 not in self.all_edges:
                continue
            d1 = np.asarray(self.all_edges[key1].dedge)
            d2 = np.asarray(self.all_edges[key2].dedge)
            combos = [(d1[0], d2[0]), (d1[-1], d2[0]), (d1[0], d2[-1]), (d1[-1], d2[-1])]
            p1, p2 = min(combos, key=lambda t: float(np.sum((t[0] - t[1]) ** 2)))
            vertex = (np.asarray(p1) + np.asarray(p2)) / 2
            # a third edge meeting the shared vertex blocks the merge
            blocked = False
            for key, erec in self.all_edges.items():
                if key in (key1, key2) or key in sewn_keys:
                    continue
                for endpoint in (erec.dedge[0], erec.dedge[-1]):
                    # SQUARED distance against the LINEAR tol — that is the
                    # reference's own comparison (TopoMapper.py:170,179:
                    # dist = sum((a-b)**2) tested < self.tol), i.e. an
                    # effective radius of sqrt(tol); replicated bug-for-bug
                    # so emitted topology matches the reference's
                    if float(np.sum((vertex - np.asarray(endpoint)) ** 2)) < self.tol:
                        blocked = True
                        break
                if blocked:
                    break
            if not blocked:
                self._merge_edges(self.all_edges[key1], self.all_edges[key2])

    def _merge_faces(self, result: FaceRecord, other: FaceRecord, sewn_key: int):
        """Merge two faces across a sewn edge; both are rolled so the sewn
        edge leads (reference Face.py:73-113). Returns edge-merge candidates."""
        if result is other:
            result.edges = result.edges[1:]
            result.orientations = result.orientations[1:]
            if sewn_key in result.keys:
                result.remove_key(sewn_key)
            self.all_edges.pop(sewn_key, None)
            return None
        for erec in other.edges[1:]:
            erec.faces[erec.faces.index(other)] = result
        candidates = [(result.keys[1], other.keys[-1]),
                      (result.keys[-1], other.keys[1])]
        result.edges = result.edges[1:] + other.edges[1:]
        result.orientations = result.orientations[1:] + other.orientations[1:]
        if result.face_type != other.face_type:
            result.face_type = FACE_TYPE_MERGED
        self.all_edges.pop(sewn_key, None)
        self.all_faces.pop(hash(other.face), None)
        return candidates

    def _merge_edges(self, e1: EdgeRecord, e2: EdgeRecord):
        if e1.same_orientation(e2):
            e1.dedge = e1.dedge + e2.dedge
            if e1.dedge3d and e2.dedge3d:
                e1.dedge3d = e1.dedge3d + e2.dedge3d
        else:
            e1.dedge = e2.dedge + e1.dedge
            if e1.dedge3d and e2.dedge3d:
                e1.dedge3d = e2.dedge3d + e1.dedge3d
        for face in e2.faces:
            if e2.key in face.keys:
                face.remove_key(e2.key)
        self.all_edges.pop(e2.key, None)

    def dominant_directions(self):
        """Projected unit axes (reference TopoMapper.py:224-230)."""
        pts = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]
        origin, x, y, z = [np.asarray(p) for p in project_points(pts, self.args)]
        return [(x - origin).tolist(), (y - origin).tolist(), (z - origin).tolist()]
