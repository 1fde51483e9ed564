"""PyTorch port: reconstruction (the L1 LP, circles, cycle assembly, ear
clipping, the wireframe and mesh lifts, the file exporters) against the JAX
package on the same numpy inputs. Tolerance: exact (np.array_equal on
arrays, byte-equal files, equal None)."""

import json
import os

import numpy as np
import pytest

from faceformer_tpu.config import ModelConfig as JaxModelConfig
from faceformer_tpu.geometry import circles as jax_circles
from faceformer_tpu.geometry import loops as jax_loops
from faceformer_tpu.reconstruction import io3d as jax_io3d
from faceformer_tpu.reconstruction import lp as jax_lp
from faceformer_tpu.reconstruction import mesh as jax_mesh
from faceformer_tpu.reconstruction import wireframe as jax_wireframe
from faceformer_tpu_torch.config import ModelConfig
from faceformer_tpu_torch.geometry import circles, loops
from faceformer_tpu_torch.geometry.fixtures import (
    build_sample,
    make_box,
    make_cylinder,
    make_plate_with_hole,
    random_sample,
)
from faceformer_tpu_torch.reconstruction import io3d, lp, mesh, wireframe

from torch_recon_helpers import jax_record, port_record

FIXTURE_CFG = ModelConfig(num_points_per_line=8, num_lines=64, max_face_length=16)
FIXTURES = {
    "box": (make_box, 30.0, 40.0),
    "cylinder": (make_cylinder, 40.0, 35.0),
    "holed-plate": (make_plate_with_hole, 50.0, 42.0),
}
RICH_SEED, RICH_COUNT = 3, 14
RICH_LIFT_MIN = 10


def fixture_record(name):
    make, theta, phi = FIXTURES[name]
    return port_record(build_sample(make(), theta=theta, phi=phi), FIXTURE_CFG)


@pytest.fixture(scope="module")
def rich_records():
    rng = np.random.default_rng(RICH_SEED)
    return [port_record(random_sample(rng, profile="rich")) for _ in range(RICH_COUNT)]


def same(a, b):
    """Exact equality of nested results: arrays by np.array_equal (shape
    and dtype-free value equality), sequences and dicts element by element."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


# ---------------------------------------------------------------------------
# the L1 plane fit
# ---------------------------------------------------------------------------


def lp_problem(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        m, n = int(rng.integers(4, 12)), int(rng.integers(2, 7))
        return rng.normal(size=(m, n)), rng.normal(size=m), rng.normal(size=(2, n))
    if kind == "active-inequality":  # wants f = -5, held at f >= 0
        return np.array([[1.0], [1.0]]), np.array([5.0, 4.0 + seed]), np.array([[1.0]])
    if kind == "outlier":  # three votes for 1 + seed, one far off
        return np.ones((4, 1)), -np.array([1.0, 1.0, 1.0, 100.0]) - [seed, seed, seed, 0], \
            np.zeros((1, 1))
    if kind == "plane-rows":  # the wireframe's shape: 3 variables a face, depth rows
        faces = int(rng.integers(2, 5))
        P = rng.normal(size=(3 * faces, 3 * faces))
        P[rng.random(P.shape) < 0.5] = 0.0
        return P, np.zeros(3 * faces), -np.abs(rng.normal(size=(faces, 3 * faces)))
    return np.zeros((0, 3)), np.zeros(0), np.zeros((0, 3))  # empty: None on both


@pytest.mark.parametrize("kind,seed", [("random", s) for s in range(4)]
                         + [("active-inequality", 0), ("active-inequality", 1),
                            ("outlier", 0), ("outlier", 2), ("plane-rows", 5),
                            ("plane-rows", 6), ("empty", 0)])
def test_solve_l1_plane_fit(kind, seed):
    P, b, C = lp_problem(kind, seed)
    ours, theirs = lp.solve_l1_plane_fit(P, b, C), jax_lp.solve_l1_plane_fit(P, b, C)
    assert same(ours, theirs)
    if kind == "active-inequality":
        assert ours[0] == pytest.approx(0.0, abs=1e-9)  # the inequality binds
    if kind == "outlier":
        assert ours[0] == pytest.approx(1.0 + seed, abs=1e-8)


# ---------------------------------------------------------------------------
# circles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_circles(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        p1, p2, p3 = rng.normal(size=(3, 3)) * rng.uniform(0.1, 3.0)
        assert same(circles.circle_through_points(p1, p2, p3),
                    jax_circles.circle_through_points(p1, p2, p3))
        arc = circles.fit_arc_through_points(p1, p2, p3)
        assert len(arc) > 2
        assert same(arc, jax_circles.fit_arc_through_points(p1, p2, p3))
    with pytest.raises(ValueError):
        circles.circle_through_points([0, 0, 0], [1, 1, 1], [2, 2, 2])


# ---------------------------------------------------------------------------
# cycle assembly
# ---------------------------------------------------------------------------


def faces_of(record, face_type=None):
    for t, face in record["pred_faces"]:
        if face_type is None or t == face_type:
            inds = wireframe._flatten_face(face)
            yield [record["edges"][i] for i in inds], inds


def test_assemble_cylinder_cycle():
    record = fixture_record("cylinder")
    cylinders = list(faces_of(record, face_type=1))
    assert cylinders
    for edges, inds in cylinders:
        ours = loops.assemble_cylinder_cycle(edges, inds)
        assert same(ours, jax_loops.assemble_cylinder_cycle(edges, inds))
        assert len(ours[1]) >= 4


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_assemble_cycles(name):
    record = fixture_record(name)
    walked = 0
    for edges, inds in faces_of(record):
        ours = loops.assemble_cycles(edges, inds)
        assert same(ours, jax_loops.assemble_cycles(edges, inds))
        walked += len(ours[0])
    assert walked >= len(record["pred_faces"])
    if name == "holed-plate":  # the caps carry an outer ring and a hole ring
        assert walked > len(record["pred_faces"])


# ---------------------------------------------------------------------------
# ear clipping and hole bridging (the cases of tests/test_reconstruction.py)
# ---------------------------------------------------------------------------


def ring(cx, cy, r, n=8):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=1)


POLYGONS = {
    "square": np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]]),
    "l-shape": np.array([[0.0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]]),
    "clockwise-ring": ring(0.3, -0.2, 1.5, 11)[::-1],
}
HOLED = {
    "bridge-avoids-other-holes": (np.array([[-1.0, -0.2], [1, -0.2], [1, 0.2], [-1, 0.2]]),
                                  [ring(-0.4, 0.0, 0.1), ring(-0.75, 0.13, 0.05)]),
    "square-with-hole": (np.array([[0.0, 0], [4, 0], [4, 4], [0, 4]]),
                         [np.array([[1.0, 1], [1, 3], [3, 3], [3, 1]])]),
    "two-holes": (np.array([[0.0, 0], [8, 0], [8, 4], [0, 4]]),
                  [np.array([[1.0, 1], [1, 3], [3, 3], [3, 1]]),
                   np.array([[5.0, 1], [5, 3], [7, 3], [7, 1]])]),
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_ear_clip(name):
    poly = POLYGONS[name]
    ours = mesh.ear_clip(poly)
    assert ours == jax_mesh.ear_clip(poly)
    area = sum(abs(mesh.polygon_area(poly[list(t)])) for t in ours)
    assert area == pytest.approx(abs(mesh.polygon_area(poly)))


@pytest.mark.parametrize("name", sorted(HOLED))
def test_merge_holes(name):
    outer, holes = HOLED[name]
    merged = mesh.merge_holes(outer, holes)
    assert same(merged, jax_mesh.merge_holes(outer, holes))
    tris = mesh.ear_clip(merged)
    assert tris == jax_mesh.ear_clip(merged)
    assert [mesh.point_in_polygon(p, outer) for p in merged] == \
        [jax_mesh.point_in_polygon(p, outer) for p in merged]


# ---------------------------------------------------------------------------
# the lifts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_lifts(name):
    record = fixture_record(name)
    make, theta, phi = FIXTURES[name]
    jax_cfg = JaxModelConfig(num_points_per_line=8, num_lines=64, max_face_length=16)
    assert record == jax_record(build_sample(make(), theta=theta, phi=phi), jax_cfg)
    points = wireframe.reconstruct_wireframe(record)
    assert points is not None and len(points) > 100
    assert same(points, jax_wireframe.reconstruct_wireframe(record))
    ours = mesh.reconstruct_mesh(record)
    assert ours is not None and len(ours[1]) > 2
    assert same(ours, jax_mesh.reconstruct_mesh(record))


def test_rich_lifts(rich_records):
    lifted = 0
    for record in rich_records:
        points = wireframe.reconstruct_wireframe(record)
        assert same(points, jax_wireframe.reconstruct_wireframe(record))
        ours = mesh.reconstruct_mesh(record)
        assert same(ours, jax_mesh.reconstruct_mesh(record))
        lifted += points is not None
    assert lifted >= RICH_LIFT_MIN


def test_reconstruct_file_both_exporters(tmp_path, rich_records):
    records = {f"{i:08d}": r for i, r in enumerate(rich_records[:6])}
    records["00000100"] = fixture_record("cylinder")
    records["00000101"] = {**fixture_record("box"), "pred_faces": []}  # unreconstructible
    outputs = {}
    for side, wire, obj in (("port", wireframe, mesh), ("jax", jax_wireframe, jax_mesh)):
        root = tmp_path / side
        os.makedirs(root / "json")
        os.makedirs(root / "ply")
        os.makedirs(root / "obj")
        for name, record in records.items():
            with open(root / "json" / f"{name}.json", "w") as f:
                json.dump(record, f)
        done = [(wire.reconstruct_file(n, str(root)), obj.reconstruct_file(n, str(root)))
                for n in sorted(records)]
        outputs[side] = (done, {d: {n: open(root / d / n, "rb").read()
                                    for n in sorted(os.listdir(root / d))}
                                for d in ("ply", "obj")})
    assert outputs["port"] == outputs["jax"]
    done, files = outputs["port"]
    assert done[-1] == (False, False) and sum(p for p, _ in done) >= 5
    for name, data in files["ply"].items():
        back = io3d.read_ply_points(str(tmp_path / "port" / "ply" / name))
        assert same(back, jax_io3d.read_ply_points(str(tmp_path / "jax" / "ply" / name)))
        assert np.all(np.isfinite(back))


def test_io3d_writers(tmp_path):
    pts = np.random.default_rng(0).standard_normal((17, 3)) * 1e3
    io3d.write_ply_points(str(tmp_path / "a.ply"), pts)
    jax_io3d.write_ply_points(str(tmp_path / "b.ply"), pts)
    assert open(tmp_path / "a.ply", "rb").read() == open(tmp_path / "b.ply", "rb").read()
    back = io3d.read_ply_points(str(tmp_path / "a.ply"))
    assert np.array_equal(back, np.array([[float(f"{v:.10g}") for v in p] for p in pts]))
    io3d.write_obj_mesh(str(tmp_path / "a.obj"), pts[:4], [(0, 1, 2), (1, 2, 3)])
    jax_io3d.write_obj_mesh(str(tmp_path / "b.obj"), pts[:4], [(0, 1, 2), (1, 2, 3)])
    assert open(tmp_path / "a.obj", "rb").read() == open(tmp_path / "b.obj", "rb").read()
