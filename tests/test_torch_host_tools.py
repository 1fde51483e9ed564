"""PyTorch port: the host tools against their JAX twins on the same
inputs: ``check_faces_enclosed`` on clean and corrupted corpora of each
flavor, ``split_jsons``, ``svg`` (SVG text, the rasterizer, the PNG
writer, the batch command line), an ``objio`` round trip, ``stats``, and
each filter's ``main(argv)`` (length, topology, thinness and thickness on
OBJ and ``feat/*.yml`` fixtures written here, and the 3-view dedup chain
after ``prepare_data --three_view``): the same files, byte for byte, and
the same lines printed."""

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import yaml

from faceformer_tpu.tools import check_faces_enclosed as jax_check
from faceformer_tpu.tools import objio as jax_objio
from faceformer_tpu.tools import split_jsons as jax_split_jsons
from faceformer_tpu.tools import stats as jax_stats
from faceformer_tpu.tools import step21 as jax_step21
from faceformer_tpu.tools import svg as jax_svg
from faceformer_tpu.tools.filters import filter_length as jax_filter_length
from faceformer_tpu.tools.filters import filter_thickness as jax_filter_thickness
from faceformer_tpu.tools.filters import filter_thinness as jax_filter_thinness
from faceformer_tpu.tools.filters import filter_topology as jax_filter_topology
from faceformer_tpu_torch.reconstruction.io3d import write_obj_mesh
from faceformer_tpu_torch.tools import check_faces_enclosed, objio, split_jsons, stats, step21, svg
from faceformer_tpu_torch.tools.filters import (
    filter_length,
    filter_thickness,
    filter_thinness,
    filter_topology,
)
from faceformer_tpu_torch.tools.gen_step_solids import FAMILIES, random_step_solid
from faceformer_tpu_torch.tools.synthetic_data import generate

from torch_corpus_helpers import REPO, env, read_tree

FLAVORS = {"coedge": {}, "no_face_type": {"no_face_type": True},
           "combined": {"coedge": False}, "direction_token": {"direction_token": True}}


def both(port_main, jax_main, root, argv_of, tmp_path):
    """Each package's ``main(argv_of(copy))`` on its own copy of ``root``:
    the two trees and the two printed outputs."""
    out = []
    for side, fn in (("port", port_main), ("jax", jax_main)):
        copy = str(tmp_path / side)
        shutil.copytree(root, copy)
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(argv_of(copy))
        out.append((read_tree(copy), buf.getvalue().replace(copy, "<root>")))
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A six-solid corpus of each flavor, from the port's synthetic_data."""
    out = {}
    for flavor, kwargs in FLAVORS.items():
        out[flavor] = str(tmp_path_factory.mktemp(flavor))
        generate(out[flavor], num=6, seed=3, split=(0.5, 0.2, 0.3), **kwargs)
    return out


@pytest.fixture(scope="module")
def step_root(tmp_path_factory):
    """One STEP solid of each generator family, two of them twice."""
    root = tmp_path_factory.mktemp("step")
    os.makedirs(root / "step")
    draws = list(range(len(FAMILIES))) + [0, 4]
    for i, k in enumerate(draws):
        probs = [float(j == k) for j in range(len(FAMILIES))]
        text = random_step_solid(np.random.default_rng(k), f"{i:08d}", probs=probs)
        (root / "step" / f"{i:08d}.step").write_text(text.replace(f"'{i:08d}'", "'x'"))
    return str(root)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_check_faces_enclosed_clean_and_corrupted(flavor, corpora, tmp_path):
    clean = corpora[flavor]
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(os.path.join(clean, "json")))
    assert check_faces_enclosed.check_dataset(clean) == jax_check.check_dataset(clean) == []
    bad = str(tmp_path / "bad")
    shutil.copytree(clean, bad)
    for name in names[1::2]:  # every other solid: one edge's start moved off its vertex
        path = os.path.join(bad, "json", f"{name}.json")
        with open(path) as f:
            data = json.load(f)
        data["edges"][0][0] = [data["edges"][0][0][0] + 0.5, data["edges"][0][0][1] + 0.5]
        with open(path, "w") as f:
            json.dump(data, f)
    failed = check_faces_enclosed.check_dataset(bad, num_cores=2)
    assert failed == jax_check.check_dataset(bad) == names[1::2]
    for argv in (["--remove"], ["--remove", "--num_cores", "2"],
                 ["--flavor", "coedge" if flavor == "no_face_type" else flavor]):
        ours, theirs = both(check_faces_enclosed.main, jax_check.main, bad,
                            lambda r: ["--root", r] + argv, tmp_path / "-".join(argv))
        assert ours == theirs
        assert ours[1].endswith(f"{len(names[1::2])} bad samples\n")


def test_split_jsons_equal_jax(corpora, tmp_path):
    root = corpora["coedge"]
    for argv in (["--seed", "7"], ["--seed", "3", "--split", "0.5", "0.25", "0.25"]):
        ours, theirs = both(split_jsons.main, jax_split_jsons.main, root,
                            lambda r: ["--root", r] + argv, tmp_path / argv[1])
        assert ours == theirs
    flat = tmp_path / "flat"  # downloaded flat JSONs moved into json/
    os.makedirs(flat)
    for name in os.listdir(os.path.join(root, "json")):
        shutil.copy(os.path.join(root, "json", name), flat / name)
    ours, theirs = both(split_jsons.main, jax_split_jsons.main, str(flat),
                        lambda r: ["--root", r, "--move_flat"], tmp_path / "move")
    assert ours == theirs and "json/00000000.json" in ours[0]
    abc = tmp_path / "abc"  # ABC's per-id folders flattened
    for i in range(3):
        os.makedirs(abc / "src" / f"{i:08d}")
        (abc / "src" / f"{i:08d}" / f"{i:08d}_feat_{i}.yml").write_text(f"{i}\n")
        (abc / "src" / f"{i:08d}" / f"{i:08d}_trimesh_{i}.obj").write_text(f"v {i} 0 0\n")
    trees = []
    for side, fn in (("port", split_jsons.reorganize_abc_dirs),
                     ("jax", jax_split_jsons.reorganize_abc_dirs)):
        shutil.copytree(abc, tmp_path / f"abc-{side}")
        fn(str(tmp_path / f"abc-{side}" / "src"), str(tmp_path / f"abc-{side}" / "feat"), "feat")
        trees.append(read_tree(str(tmp_path / f"abc-{side}")))
    assert trees[0] == trees[1] and "feat/00000001.yml" in trees[0]


def test_svg_rendering_and_png_equal_jax(corpora, tmp_path):
    with open(os.path.join(corpora["coedge"], "json", "00000000.json")) as f:
        edges = json.load(f)["edges"]
    for kwargs in ({}, {"width": 128, "height": 96, "mark_starts": False},
                   {"colors": ["#ff0000"] * len(edges), "padding": 0.1}):
        assert svg.render_svg(edges, **kwargs) == jax_svg.render_svg(edges, **kwargs)
    groups = [edges[:3], edges[3:]]
    assert svg.render_svg_groups(groups) == jax_svg.render_svg_groups(groups)
    np.testing.assert_array_equal(svg.rasterize_edges(edges, 64, 48),
                                  jax_svg.rasterize_edges(edges, 64, 48))
    blobs = []
    for side, module in (("port", svg), ("jax", jax_svg)):
        module.save_svg(edges, str(tmp_path / side / "a.svg"))
        assert module.save_png(str(tmp_path / side / "a.svg"), str(tmp_path / side / "a.png"),
                               edges=edges)  # cairosvg absent: the edges' rasterizer
        blobs.append(read_tree(str(tmp_path / side)))
    assert blobs[0] == blobs[1] and blobs[0]["a.png"].startswith(b"\x89PNG")
    for k, argv in enumerate(([], ["--num_cores", "2", "--width", "128"],
                              ["--name", "00000002"])):
        ours, theirs = both(svg.main, jax_svg.main, corpora["direction_token"],
                            lambda r: ["--root", r] + argv, tmp_path / f"cli{k}")
        assert ours == theirs and any(p.startswith("svg") for p in ours[0])


def test_objio_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    vertices = rng.normal(size=(9, 3))
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 6, 7], [7, 8, 0]]
    write_obj_mesh(str(tmp_path / "a.obj"), vertices, faces)
    with open(tmp_path / "a.obj", "a") as f:  # texture/normal slots
        f.write("vt 0.5 0.5\nvn 0 0 1\nf 1/1/1 3/1/1 9/1/1\n")
    ours, theirs = objio.load_obj(str(tmp_path / "a.obj")), jax_objio.load_obj(str(tmp_path / "a.obj"))
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1] == faces + [[0, 2, 8]]
    np.testing.assert_allclose(ours[0], vertices, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(objio.bounding_extents(ours[0]),
                                  jax_objio.bounding_extents(ours[0]))
    np.testing.assert_array_equal(objio.scale_to_unit_sphere(ours[0]),
                                  jax_objio.scale_to_unit_sphere(ours[0]))


def test_stats_equal_jax(step_root, tmp_path):
    for name in sorted(os.listdir(os.path.join(step_root, "step"))):
        path = os.path.join(step_root, "step", name)
        for tol in (1e-3, 1e-1):
            assert (stats.solid_stat(step21.read_brep(path), tol)
                    == jax_stats.solid_stat(jax_step21.read_brep(path), tol))
        blobs = []
        for side, module in (("port", stats), ("jax", jax_stats)):
            out = str(tmp_path / f"{side}-{name}.yml")
            assert module.write_stat(path, out) == yaml.safe_load(open(out))
            blobs.append(open(out, "rb").read())
        assert blobs[0] == blobs[1]
    ours, theirs = both(stats.main, jax_stats.main, step_root, lambda r: ["--root", r],
                        tmp_path / "cli")
    assert ours == theirs
    assert ours[1] == f"{len(FAMILIES) + 2} stats written, 0 failed\n"


def test_filter_length_equal_jax(corpora, tmp_path):
    root = corpora["no_face_type"]
    ids = str(tmp_path / "ids.json")
    with open(ids, "w") as f:
        json.dump(["00000001", "00000003", "00000004"], f)
    for k, argv in enumerate(([], ["--face_seq_max", "30", "--num_edge_max", "40"],
                              ["--id_list", ids])):
        ours, theirs = both(filter_length.main, jax_filter_length.main, root,
                            lambda r: ["--root", r, "--out", os.path.join(r, "kept.json")] + argv,
                            tmp_path / f"len{k}")
        assert ours == theirs and "kept.json" in ours[0]


def test_filter_topology_equal_jax(step_root, tmp_path):
    pytest.importorskip("sklearn", reason="filter_topology bins with sklearn's NearestNeighbors")
    root = str(tmp_path / "root")
    shutil.copytree(step_root, root)
    stats.main(["--root", root])
    with open(tmp_path / "errors.log", "w") as f:
        f.write("00000003 received unknown error\n")
    for k, argv in enumerate(([], ["--similarity_threshold", "2.5"],
                              ["--error_log", str(tmp_path / "errors.log")])):
        ours, theirs = both(filter_topology.main, jax_filter_topology.main, root,
                            lambda r: ["--root", r, "--out", os.path.join(r, "bins.json")] + argv,
                            tmp_path / f"topo{k}")
        assert ours == theirs
    bins = json.loads(ours[0]["bins.json"])
    assert sorted(len(b) for b in bins)[-1] >= 2  # the repeated draws share a bin


def feat_root(tmp_path):
    """OBJ meshes and ABC-style feat/*.yml annotations for five shapes: a
    circle-and-line plate, a thin double wall (two curves 0.01 apart), an
    ellipse, a shape with no curved feature, and one whose curve indexes
    past its vertices."""
    root = tmp_path / "feat_root"
    os.makedirs(root / "obj")
    os.makedirs(root / "feat")
    t = np.linspace(0.0, 1.0, 12)
    for i, (offset, curves) in enumerate([
            (0.8, [{"type": "Circle", "radius": 0.4}, {"type": "Line"}]),
            (0.01, [{"type": "Line"}, {"type": "Circle", "radius": 0.05}]),
            (0.5, [{"type": "Ellipse", "maj_radius": 0.9, "min_radius": 0.3}]),
            (0.3, [{"type": "Line"}, {"type": "BSpline"}]),
            (0.6, [{"type": "Line"}])]):
        vertices = np.concatenate([np.stack([t, 0 * t, 0 * t], 1),
                                   np.stack([t, offset + 0 * t, 0 * t], 1),
                                   [[0.0, 1.0, 1.0]]])
        write_obj_mesh(str(root / "obj" / f"{i:08d}.obj"), vertices, [[0, 1, 24], [12, 13, 24]])
        for k, curve in enumerate(curves):
            curve["vert_indices"] = list(range(12 * (k % 2), 12 * (k % 2) + 12))
        if i == 4:
            curves[0]["vert_indices"] = [0, 1, 99]
        with open(root / "feat" / f"{i:08d}.yml", "w") as f:
            yaml.safe_dump({"curves": curves}, f)
    with open(root / "ids.json", "w") as f:
        json.dump([f"{i:08d}" for i in range(4)], f)
    with open(root / "all_ids.json", "w") as f:
        json.dump([f"{i:08d}" for i in range(5)], f)
    return str(root)


def test_filter_thinness_equal_jax(tmp_path):
    root = feat_root(tmp_path)
    ours, theirs = both(filter_thinness.main, jax_filter_thinness.main, root,
                        lambda r: ["--root", r, "--id_list", os.path.join(r, "ids.json"),
                                   "--out", os.path.join(r, "thin.json")], tmp_path / "thin")
    assert ours == theirs
    assert sorted(p for p in ours[0] if p.startswith("radius")) == [
        f"radius/{i:08d}.json" for i in range(3)]


@pytest.mark.parametrize("argv", [[], ["--p2p"], ["--num_cores", "2", "--threshold", "0.2"]],
                         ids=["p2l", "p2p", "pool"])
def test_filter_thickness_equal_jax(argv, tmp_path):
    root = feat_root(tmp_path)
    ours, theirs = both(filter_thickness.main, jax_filter_thickness.main, root,
                        lambda r: ["--root", r, "--id_list", os.path.join(r, "all_ids.json"),
                                   "--out", os.path.join(r, "thick.json"), "--num_cores",
                                   "1"] + argv, tmp_path / "thick")
    assert ours == theirs
    kept = json.loads(ours[0]["thick.json"])
    assert "00000001" not in kept and "00000004" not in kept and "00000000" in kept


def test_3view_dedup_chain_equal_jax(tmp_path):
    """The dedup chain of tests/test_tools.py (stat sidecars -> topology
    bins -> 3-view Jaccard clusters) on five solids with two exact
    duplicates, through each package: the same bins, the same survivors."""
    pytest.importorskip("cv2", reason="filter_3view reads the rendered views with cv2")
    pytest.importorskip("sklearn", reason="filter_topology and filter_3view cluster with sklearn")
    from faceformer_tpu.tools.filters import filter_3view as jax_filter_3view
    from faceformer_tpu_torch.tools.filters import filter_3view

    solids = [step21.brep_cylinder(0.7, 1.1), step21.brep_cylinder(0.7, 1.1),
              step21.brep_cylinder(0.7, 0.25), step21.brep_dome_block(0.6, 1.0),
              step21.brep_dome_block(0.6, 1.0)]
    kept = []
    for side, prepare, topo, view in (
            ("port", ["-m", "faceformer_tpu_torch.tools.prepare_data"], filter_topology,
             filter_3view),
            ("jax", [os.path.join("tools", "prepare_data.py")], jax_filter_topology,
             jax_filter_3view)):
        root = tmp_path / side
        os.makedirs(root / "step")
        for i, text in enumerate(solids):
            (root / "step" / f"{i:08d}.step").write_text(text)
        for extra in ([], ["--three_view"]):
            subprocess.run([sys.executable, *prepare, "--root", str(root), "--backend", "native",
                            "--seed", "3", "--num_cores", "1"] + extra,
                           check=True, cwd=REPO, env=env(), capture_output=True, timeout=240)
        topo.main(["--root", str(root), "--out", str(root / "bins.json")])
        view.main(["--root", str(root), "--bins", str(root / "bins.json"),
                   "--out", str(root / "kept.json")])
        kept.append((json.loads((root / "bins.json").read_text()),
                     json.loads((root / "kept.json").read_text())))
    assert kept[0] == kept[1]
    assert kept[0][1] == ["00000000", "00000002", "00000003"]
