"""ABC STEP files -> training JSONs (+ SVG viz).

The port's copy of the root tools/prepare_data.py, run as
``python -m faceformer_tpu_torch.tools.prepare_data``: the same flags write
the same files, byte for byte.

Same CLI surface and output layout as the reference
(dataset/prepare_data.py:378-426):

    python -m faceformer_tpu_torch.tools.prepare_data --root <ABC root with step/> [--id_list F]
        [--backend auto|occ|native]
        [--combine_coedge] [--order_by_position] [--direction_token]
        [--random_camera] [--focus F] [--no_face_type] [--discretize_last]
        [--three_view] [--name ID] [--only_split]

Per shape: read STEP (5 s budget), reject multi-solid / >64-edge shapes,
normalize to bbox-diagonal 2, optionally re-roll a random camera up to 5x,
run the HLR/topology pipeline, emit canonical JSON (+ per-face SVGs), then
write seeded 0.93/0.02/0.05 splits. --three_view instead renders the four
canonical views used by the 3-view similarity filter
(reference dataset/filters/3view_render.py).

Backends: ``occ`` runs the full OpenCascade pipeline
(faceformer_tpu_torch/tools/occ_pipeline.py, requires pythonocc-core);
``native`` runs the CAD-free STEP reader + analytic-HLR pipeline
(faceformer_tpu_torch/tools/step_native.py, plane/cylinder/cone solids with
line/circle edges — no extra dependencies). ``auto`` picks occ when
pythonocc is importable, native otherwise.

CAD-free fixture alternative (no STEP files at all):
python -m faceformer_tpu_torch.tools.synthetic_data.
"""

import argparse
import json
import os
import zlib
from functools import partial
from typing import Optional, Sequence

import numpy as np

from faceformer_tpu_torch.geometry.canonical import (
    sort_faces_by_indices,
    sort_key_edges,
)
from faceformer_tpu_torch.geometry.enclosedness import is_face_enclosed
from faceformer_tpu_torch.tools.svg import save_svg
from faceformer_tpu_torch.tools.synthetic_data import prepare_splits


def assemble_json(topo, args, name: str) -> dict:
    """Canonicalize one TopoMapper result into the dataset JSON schema
    (reference prepare_data.py:49-181, 249-265)."""
    faces = list(topo.all_faces.values())

    # collect per-face oriented discretized edges
    records = []  # unique edge records: dicts with points/points3d
    face_pointers = []  # per face: list of record indices (or (idx, orient))
    face_types = []

    if args.combine_coedge or args.direction_token:
        # one record per undirected edge, stored in the edge's own (raw)
        # direction — the reference keeps edge.dedge as-is in these modes
        # (prepare_data.py:108-114, 204-208; DiscretizedEdge's
        # correct_edge_direction is never called anywhere in the reference),
        # and the direction-token orientation bit is relative to that raw
        # direction
        key_to_idx = {}
        for face in faces:
            pointers = []
            for erec, orient in zip(face.edges, face.orientations):
                key = erec.key
                if key not in key_to_idx:
                    key_to_idx[key] = len(records)
                    records.append({"points": list(erec.dedge),
                                    "points3d": erec.dedge3d or []})
                if args.direction_token:
                    pointers.append((key_to_idx[key], 1 if orient else 0))
                else:
                    pointers.append(key_to_idx[key])
            face_pointers.append(pointers)
            face_types.append(face.face_type)
    else:
        # coedge mode: every face traversal emits its own oriented copy
        for face in faces:
            pointers = []
            for pts2d, pts3d in zip(face.oriented_dedges(),
                                    face.oriented_dedges(is_3d=True)):
                pointers.append(len(records))
                records.append({"points": list(pts2d), "points3d": list(pts3d or [])})
            face_pointers.append(pointers)
            face_types.append(face.face_type)

    # sort edges lexicographically and remap indices
    order = sort_key_edges([r["points"] for r in records])
    remap = {old: new for new, old in enumerate(order)}
    edges = [records[i]["points"] for i in order]
    edges3d = [records[i]["points3d"] for i in order]

    def remap_ptr(p):
        return (remap[p[0]], p[1]) if isinstance(p, tuple) else remap[p]

    face_pointers = [[remap_ptr(p) for p in ptrs] for ptrs in face_pointers]

    if args.combine_coedge and not args.direction_token:
        faces_indices = [sorted(ptrs) if args.order_by_position else ptrs
                         for ptrs in face_pointers]
        faces_indices = [
            np.roll(face, -int(np.argmin(face)), axis=0).tolist()
            for face in faces_indices]
        faces_indices = sort_faces_by_indices(faces_indices)
    else:
        faces_indices = []
        for ftype, ptrs in zip(face_types, face_pointers):
            loops = is_face_enclosed(edges, ptrs, args.tol * 2)
            if not loops:
                raise AssertionError("faces unenclosed")
            if args.direction_token:
                rolled = [np.roll(lp, -int(np.argmin([t[0] for t in lp])),
                                  axis=0).tolist() for lp in loops]
                rolled = sorted(rolled, key=lambda lp: lp[0][0])
            else:
                rolled = [np.roll(lp, -int(np.argmin(lp)), axis=0).tolist()
                          for lp in loops]
                rolled = sorted(rolled, key=lambda lp: lp[0])
            if args.no_face_type or args.direction_token:
                faces_indices.append(rolled)
            else:
                faces_indices.append([int(ftype), rolled])
        if args.direction_token or args.no_face_type:
            faces_indices = sorted(faces_indices, key=lambda f: (
                f[0][0][0] if args.direction_token else f[0][0]))
        else:
            faces_indices = sorted(faces_indices, key=lambda f: f[1][0][0])

    pairings = {}
    for i in range(len(edges)):
        for j in range(i + 1, len(edges)):
            if edges[i] == edges[j][::-1]:
                pairings[i] = j

    return {
        "edges": edges,
        "edges3d": edges3d,
        "shrinked_edges": edges,
        "faces_indices": faces_indices,
        "dominant_directions": topo.dominant_directions(),
        "pairings": pairings,
    }


def resolve_backend(args) -> str:
    if args.backend != "auto":
        return args.backend
    try:
        import OCC.Core  # noqa: F401

        return "occ"
    except ImportError:
        return "native"


def run_with_camera(name: str, args, proj, emit) -> None:
    """Shared camera policy: optional random re-rolls (up to 5, reference
    prepare_data.py:305-319), then the deterministic fallback camera."""
    from faceformer_tpu_torch.tools import occ_pipeline as occ

    if args.random_camera:
        # per-shape, per-attempt cameras. Documented deviation: the
        # reference reseeds global np.random with the constant args.seed
        # before every draw (projection_utils.py:11-12), so every shape
        # gets the SAME camera and a degenerate camera can never be
        # re-rolled; it also falls through to the final attempt with the
        # last failed pose still set. Here each shape derives its own
        # stream from (seed, name) and the fallback restores the
        # deterministic --location/--direction camera.
        shape_key = (int(name) if name.isdigit()
                     else zlib.crc32(name.encode()))
        rng = np.random.default_rng(
            np.random.SeedSequence([args.seed, shape_key]))
        for _ in range(5):  # re-roll degenerate cameras (reference :305-319)
            try:
                focus, pose = occ.generate_random_camera_pos(rng=rng)
                proj.pose = pose
                if args.focus != 0:
                    proj.focus = focus
                emit()
                return
            except Exception:
                continue
        proj.pose = None  # restore the default camera for the fallback
        proj.focus = args.focus
    emit()


def render_shape_native(name: str, args) -> None:
    """Per-shape worker on the CAD-free backend: parse the STEP B-Rep,
    filter, normalize, analytic-HLR split + project, emit. Mirrors
    render_shape (reference prepare_data.py:268-327) without OCC."""
    from faceformer_tpu_torch.tools import occ_pipeline as occ
    from faceformer_tpu_torch.tools import step_native

    try:
        path = os.path.join(args.root, "step", f"{name}.step")
        try:
            solid, num_shapes = step_native.load_solid(
                path, filter_num_shapes=args.filter_num_shapes)
        except step_native.UnsupportedStep as exc:
            print(f"{name} is outside the native STEP subset ({exc}); "
                  "rerun with --backend occ")
            return
        if solid is None:
            print(f"{name} rejected: {num_shapes} shapes")
            return
        if len(solid.edges()) > args.filter_num_edges:
            print(f"{name} has too many edges.")
            return
        step_native.normalize_solid(solid)

        proj = occ.ProjectionArgs(
            location=tuple(args.location), direction=tuple(args.direction),
            focus=args.focus, tol=args.tol, discretize_last=args.discretize_last)

        def emit():
            topo = step_native.NativeTopoMapper(solid, proj)
            data = assemble_json(topo, args, name)
            os.makedirs(os.path.join(args.root, "json"), exist_ok=True)
            with open(os.path.join(args.root, "json", f"{name}.json"), "w") as f:
                json.dump(data, f)
            save_svg(data["edges"], os.path.join(args.root, "svg", f"{name}.svg"),
                     width=args.width, height=args.height)

        run_with_camera(name, args, proj, emit)
        # ABC ships stat/*.yml sidecars that the topology filter bins on
        # (filter_topology.py); generated corpora must emit their own for
        # the filter chain to run. Derived from the RAW (pre-split) B-Rep.
        from faceformer_tpu_torch.tools.stats import write_stat

        os.makedirs(os.path.join(args.root, "stat"), exist_ok=True)
        write_stat(path, os.path.join(args.root, "stat", f"{name}.yml"),
                   tol=args.tol)
    except Exception as exc:
        print(f"{name} received unknown error", exc)


def render_shape(name: str, args) -> None:
    """Per-shape worker: read, filter, normalize, project, emit
    (reference prepare_data.py:268-327). Errors are swallowed and logged."""
    from faceformer_tpu_torch.tools import occ_pipeline as occ

    if resolve_backend(args) == "native":
        render_shape_native(name, args)
        return

    try:
        try:
            shape, num_shapes = occ.read_step_file(
                os.path.join(args.root, "step", f"{name}.step"))
        except Exception:
            print(f"{name} took too long to read")
            return
        if shape is None or num_shapes > args.filter_num_shapes:
            print(f"{name} rejected: {num_shapes} shapes")
            return

        from OCC.Core.BRepBuilderAPI import BRepBuilderAPI_Transform
        from OCC.Core.Bnd import Bnd_Box
        from OCC.Core.BRepBndLib import brepbndlib_Add
        from OCC.Core.gp import gp_Pnt, gp_Trsf, gp_Vec
        from OCC.Extend.TopologyUtils import TopologyExplorer

        if len(list(TopologyExplorer(shape).edges())) > args.filter_num_edges:
            print(f"{name} has too many edges.")
            return

        bbox = Bnd_Box()
        bbox.SetGap(1e-6)
        brepbndlib_Add(shape, bbox, False)
        xmin, ymin, zmin, xmax, ymax, zmax = bbox.Get()
        center = ((xmax + xmin) / 2, (ymin + ymax) / 2, (zmin + zmax) / 2)
        extent = (xmax - xmin, ymax - ymin, zmax - zmin)
        trans, scale = gp_Trsf(), gp_Trsf()
        trans.SetTranslation(-gp_Vec(*center))
        scale.SetScale(gp_Pnt(0, 0, 0), 2 / float(np.linalg.norm(extent)))
        shape = BRepBuilderAPI_Transform(shape, scale * trans).Shape()

        proj = occ.ProjectionArgs(
            location=tuple(args.location), direction=tuple(args.direction),
            focus=args.focus, tol=args.tol, discretize_last=args.discretize_last)

        def emit():
            topo = occ.TopoMapper(shape, proj)
            data = assemble_json(topo, args, name)
            os.makedirs(os.path.join(args.root, "json"), exist_ok=True)
            with open(os.path.join(args.root, "json", f"{name}.json"), "w") as f:
                json.dump(data, f)
            save_svg(data["edges"], os.path.join(args.root, "svg", f"{name}.svg"),
                     width=args.width, height=args.height)

        run_with_camera(name, args, proj, emit)
    except Exception as exc:
        print(f"{name} received unknown error", exc)


THREE_VIEW_DIRECTIONS = [
    (1.0, 1.0, 1.0),   # 45 degree
    (0.0, -1.0, 0.0),  # front
    (1.0, 0.0, 0.0),   # right
    (0.0, 0.0, 1.0),   # top
]

#: deterministic fallback tilts for degenerate canonical views: exact
#: axis-aligned cameras land silhouette events on seams/stations for
#: solids of revolution, which the splitter rejects by design. Every
#: solid retries through the SAME perturbation ladder, so near-duplicate
#: solids still produce pixel-comparable renders for filter_3view.
THREE_VIEW_TILTS = [
    (0.0, 0.0, 0.0),
    (0.017, 0.029, 0.011),
    (-0.031, 0.013, 0.023),
    (0.041, -0.037, 0.019),
]


def _render_one_native_view(name: str, args, direction, view_index) -> None:
    """One HLR view: split curves + visibility -> SVG + PNG. Raises
    UnsupportedStep on splitter degeneracies (caller retries tilted)."""
    from faceformer_tpu_torch.tools import step_native
    from faceformer_tpu_torch.tools.hlr_visibility import OcclusionTester, unproject
    from faceformer_tpu_torch.tools.occ_pipeline import ProjectionArgs
    from faceformer_tpu_torch.tools.svg import save_png

    path = os.path.join(args.root, "step", f"{name}.step")
    # fresh parse per view: normalization/splitting work in place
    solid, num_shapes = step_native.load_solid(
        path, filter_num_shapes=args.filter_num_shapes)
    if solid is None:
        raise _ShapeCountRejected(num_shapes)
    step_native.normalize_solid(solid)
    occ_args = ProjectionArgs(
        location=(0.0, 0.0, 0.0), direction=direction,
        focus=0.0, tol=args.tol)
    topo = step_native.NativeTopoMapper(solid, occ_args)
    # unique split edges with their 2D + camera-3D polylines
    records = []
    seen = set()
    for face in topo.all_faces.values():
        for erec in face.edges:
            if erec.key in seen:
                continue
            seen.add(erec.key)
            records.append((np.asarray(erec.dedge, dtype=float),
                            np.asarray(erec.dedge3d, dtype=float)))
    occ_solid, _ = step_native.load_solid(
        path, filter_num_shapes=args.filter_num_shapes)
    step_native.normalize_solid(occ_solid)
    projector = step_native.NativeProjector(occ_args)
    tester = OcclusionTester(occ_solid, projector, args.tol)
    visible = []
    for pts2d, pts3d in records:
        world = unproject(projector, pts3d)
        for run in tester.visible_runs(world):
            visible.append(pts2d[run].tolist())
    svg_path = os.path.join(args.root, "3view_svg", f"{name}-{view_index}.svg")
    save_svg(visible, svg_path, width=args.width, height=args.height)
    save_png(svg_path,
             os.path.join(args.root, "3view_png", f"{name}-{view_index}.png"),
             args.width, args.height, edges=visible)


class _ShapeCountRejected(Exception):
    pass


def render_three_views_native(name: str, args) -> None:
    """CAD-free 4-view HLR render for the 3-view filter: the native
    topo mapper supplies the split curve set (sharp edges + silhouette
    outlines, sewn seams removed — the same compounds OCC HLR hands the
    reference, 3view_render.py:63-72) and the ray-cast occlusion tester
    keeps only the VISIBLE sub-polylines, which is what HLR's V-compounds
    are. Degenerate canonical views retry through THREE_VIEW_TILTS."""
    from faceformer_tpu_torch.tools import step_native

    if all(os.path.exists(os.path.join(args.root, "3view_png",
                                       f"{name}-{i}.png"))
           for i in range(len(THREE_VIEW_DIRECTIONS))):
        return  # resume-by-skip, like the reconstruction runner
    try:
        for i, direction in enumerate(THREE_VIEW_DIRECTIONS):
            last_exc = None
            for tilt in THREE_VIEW_TILTS:
                d = np.asarray(direction, dtype=float) + np.asarray(tilt)
                try:
                    _render_one_native_view(name, args, tuple(d), i)
                    last_exc = None
                    break
                except step_native.UnsupportedStep as exc:
                    last_exc = exc
            if last_exc is not None:
                print(f"{name} is outside the native STEP subset "
                      f"({last_exc}); rerun with --backend occ")
                return
    except _ShapeCountRejected as exc:
        print(f"{name} rejected: {exc.args[0]} shapes")
    except Exception as exc:
        print(f"{name} 3view failed", exc)


def render_three_views(name: str, args) -> None:
    """Render the 4 canonical HLR views for the 3-view filter
    (reference dataset/filters/3view_render.py:29-105)."""
    from faceformer_tpu_torch.tools import occ_pipeline as occ
    from faceformer_tpu_torch.tools.svg import save_png

    if resolve_backend(args) == "native":
        render_three_views_native(name, args)
        return

    try:
        shape, _ = occ.read_step_file(os.path.join(args.root, "step", f"{name}.step"))
        views = [
            ((1.0, 1.0, 1.0), None),   # 45 degree
            ((0.0, -1.0, 0.0), None),  # front
            ((1.0, 0.0, 0.0), None),   # right
            ((0.0, 0.0, 1.0), None),   # top
        ]
        from OCC.Extend.TopologyUtils import TopologyExplorer

        for i, (direction, _) in enumerate(views):
            proj = occ.ProjectionArgs(location=(0, 0, 0), direction=direction,
                                      focus=0, tol=args.tol)
            hlr = occ.project_shapes(shape, proj)
            edges = []
            for compound in (hlr.OutLineVCompound(), hlr.Rg1LineVCompound()):
                if compound:
                    edges += occ.discretize_compound(compound, args.tol)
            sharp = occ.project_shapes(
                list(TopologyExplorer(shape).edges()), proj).VCompound()
            if sharp:
                sharp_edges = occ.discretize_compound(sharp, args.tol)
                sewn = hlr.RgNLineVCompound()
                if sewn:
                    for edge in occ.discretize_compound(sewn, args.tol):
                        try:
                            sharp_edges.remove(edge)
                        except ValueError:
                            print("sewn edge assumption broken", name)
                            break
                edges += sharp_edges
            svg_path = os.path.join(args.root, "3view_svg", f"{name}-{i}.svg")
            save_svg(edges, svg_path, width=args.width, height=args.height)
            save_png(svg_path, os.path.join(args.root, "3view_png", f"{name}-{i}.png"),
                     args.width, args.height)
    except Exception as exc:
        print(f"{name} 3view failed", exc)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="./data")
    parser.add_argument("--id_list", type=str, default="None")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--num_cores", type=int, default=5)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--tol", type=float, default=1e-4)
    parser.add_argument("--filter_num_shapes", type=int, default=1)
    parser.add_argument("--filter_num_edges", type=int, default=64)
    parser.add_argument("--location", nargs="+", type=float, default=[1, 1, 1])
    parser.add_argument("--direction", nargs="+", type=float, default=[1, 1, 1])
    parser.add_argument("--focus", type=float, default=3)
    parser.add_argument("--split", nargs="+", type=float, default=[0.93, 0.02, 0.05])
    parser.add_argument("--only_split", action="store_true")
    parser.add_argument("--combine_coedge", action="store_true")
    parser.add_argument("--order_by_position", action="store_true")
    parser.add_argument("--direction_token", action="store_true")
    parser.add_argument("--random_camera", action="store_true")
    parser.add_argument("--discretize_last", action="store_true")
    parser.add_argument("--no_face_type", action="store_true")
    parser.add_argument("--three_view", action="store_true")
    parser.add_argument("--backend", choices=["auto", "occ", "native"],
                        default="auto")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    if resolve_backend(args) == "occ":
        from faceformer_tpu_torch.tools.occ_pipeline import require_occ

        require_occ()

    np.random.seed(args.seed)
    for sub in ("json", "svg", "png", "3view_svg", "3view_png"):
        os.makedirs(os.path.join(args.root, sub), exist_ok=True)

    if os.path.exists(args.id_list):
        with open(args.id_list) as f:
            names = json.load(f)
    else:
        names = sorted(os.path.splitext(n)[0]
                       for n in os.listdir(os.path.join(args.root, "step")))

    worker = render_three_views if args.three_view else render_shape
    if args.name is not None:
        worker(args.name, args)
        return
    if not args.only_split:
        from concurrent.futures import ProcessPoolExecutor

        if args.num_cores > 1:
            with ProcessPoolExecutor(max_workers=args.num_cores) as pool:
                list(pool.map(partial(worker, args=args), names))
        else:
            for name in names:
                worker(name, args)
    if not args.three_view:
        prepare_splits(args.root, names, split=tuple(args.split), seed=args.seed)


if __name__ == "__main__":
    main()
