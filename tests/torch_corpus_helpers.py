"""Shared setup for the port's corpus tests (tests/test_torch_corpus*.py),
and the source of the oracle constants in chip_smoke.py [8].

    PYTHONPATH=. python tests/torch_corpus_helpers.py --root <dir> [--num_cores K]

builds chip_smoke.py [8]'s corpus with the JAX package's root scripts
(``tools/gen_step_solids.py --num 256 --seed 5``, then
``tools/prepare_data.py --backend native --random_camera --seed 9``), runs
the JAX package's checker and filters on it, and prints one JSON object:
chip_smoke.py's ``ORACLE_CORPUS`` (~40 s at 4 cores).

The JAX package's own output is not reproducible for solids with a traced
silhouette (a torus or revolution band, a B-spline patch): it starts each
trace from whichever open end a set of object ids yields first, so two of
its runs can differ in the last bits of a point, or in where a traced
polyline is sampled, and so in the order of edges that sort by those
points. The port starts from the first open end in event order. For those
solids a JSON must hold the same faces, types, vertices (to 1e-9) and
counts up to the order of its edges, and an SVG or PNG may differ; every
other file must be equal byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def env():
    out = dict(os.environ)
    out["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, out.get("PYTHONPATH")) if p)
    return out


def run(argv, timeout=240):
    """``python argv`` from the repository's root; returns its stdout."""
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env(), capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def read_tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def traced_solids(step_dir):
    """Names of the solids with a face the native backend traces."""
    from faceformer_tpu_torch.tools import step21

    return {os.path.splitext(name)[0] for name in os.listdir(step_dir)
            if chip_smoke.has_traced_face(step21.read_brep(os.path.join(step_dir, name))[0])}


def json_topology(blob):
    """A JSON's faces with each edge index replaced by its end points
    (to 1e-9) and every loop and face list sorted: its content up to the
    order of its edges."""
    data = json.loads(blob)
    ends = [tuple(round(c, 9) for c in edge[0] + edge[-1]) for edge in data["edges"]]

    def token(t):  # a coedge index, or (edge index, orientation): the walk's ends
        if isinstance(t, int):
            return ends[t]
        a, b = ends[t[0]][:2], ends[t[0]][2:]
        return a + b if t[1] else b + a

    faces = []
    for entry in data["faces_indices"]:
        if all(isinstance(t, int) for t in entry):  # combined: a set of undirected edges
            undirected = (min(ends[i][:2], ends[i][2:]) + max(ends[i][:2], ends[i][2:])
                          for i in entry)
            faces.append((None, (tuple(sorted(undirected)),)))
            continue
        ftype, loops = ((entry[0], entry[1]) if isinstance(entry[0], int) else (None, entry))
        faces.append((ftype, tuple(sorted(tuple(sorted(map(token, loop))) for loop in loops))))
    return (sorted(faces, key=repr), len(data["pairings"]), data["dominant_directions"],
            len(data["edges"]), len(data["edges3d"]))


def png_rows(blob):
    """The decoded pixel rows of a PNG written by tools.svg.write_png."""
    at, idat = 8, b""
    while at < len(blob):
        length = int.from_bytes(blob[at:at + 4], "big")
        if blob[at + 4:at + 8] == b"IDAT":
            idat += blob[at + 8:at + 8 + length]
        at += 12 + length
    return zlib.decompress(idat)


def assert_same_corpus(ours, theirs, traced):
    """Every file equal byte for byte, except the JSONs, SVGs and PNGs of
    traced solids: there the JSONs' topology is equal, and a PNG differs
    in under 2 % of its pixel bytes."""
    assert sorted(ours) == sorted(theirs)
    loose = 0
    for path, blob in ours.items():
        if blob == theirs[path]:
            continue
        sub, name = os.path.split(path)
        solid = name.split(".")[0].split("-")[0]
        assert solid in traced and sub in ("json", "svg", "3view_svg", "3view_png"), path
        loose += 1
        if sub == "json":
            assert json_topology(blob) == json_topology(theirs[path]), path
        elif sub == "3view_png":
            a, b = png_rows(blob), png_rows(theirs[path])
            assert len(a) == len(b), path
            assert sum(x != y for x, y in zip(a, b)) < 0.02 * len(a), path
    assert loose < len(ours) // 4, loose


FLAG_SETS = {
    "default": [],
    "random_camera": ["--random_camera"],
    "combine_coedge": ["--combine_coedge"],
    "direction_token": ["--direction_token"],
    "order_by_position": ["--combine_coedge", "--order_by_position"],
    "no_face_type": ["--no_face_type"],
    "discretize_last": ["--discretize_last"],
    "three_view": ["--three_view"],
    "only_split": ["--only_split"],
}
CORPUS_NUM, CORPUS_GEN_SEED, CORPUS_SEED = 8, 5, 9
ROOT_PREPARE = [os.path.join("tools", "prepare_data.py")]
PORT_PREPARE = ["-m", "faceformer_tpu_torch.tools.prepare_data"]


def make_corpus(tmp_path_factory):
    """8 STEP solids from the root script and from the port's module:
    their files, the port's step/ and the names of its traced solids."""
    roots = {}
    for side, argv in (("jax", [os.path.join("tools", "gen_step_solids.py")]),
                       ("port", ["-m", "faceformer_tpu_torch.tools.gen_step_solids"])):
        roots[side] = str(tmp_path_factory.mktemp(f"gen-{side}"))
        run(argv + ["--root", roots[side], "--num", str(CORPUS_NUM),
                    "--seed", str(CORPUS_GEN_SEED)])
    step = os.path.join(roots["port"], "step")
    return {"step": step, "jax_files": read_tree(roots["jax"]),
            "port_files": read_tree(roots["port"]), "traced": traced_solids(step)}


def prepared(corpus, root, argv, flags, cores):
    """``argv`` (a prepare_data command line) over a copy of the corpus's
    step/ in ``root``: (the files written, the sorted lines printed)."""
    shutil.copytree(corpus["step"], os.path.join(root, "step"))
    out = run(argv + ["--root", root, "--backend", "native", "--seed", str(CORPUS_SEED),
                      "--num_cores", str(cores)] + FLAG_SETS[flags])
    return read_tree(root), sorted(out.splitlines())


def root_script_corpora(corpus, tmp_path_factory):
    """The root script's output for each flag set at one core, made once
    a flag set."""
    cache = {}

    def get(flags):
        if flags not in cache:
            cache[flags] = prepared(corpus, str(tmp_path_factory.mktemp(f"jax-{flags}")),
                                    ROOT_PREPARE, flags, 1)
        return cache[flags]
    return get


def check_prepared(corpus, ours, theirs, flags):
    """The port's prepare_data output against the root script's: the same
    lines printed, the same files (assert_same_corpus), and the
    directories the flag set writes."""
    (files, log), (jax_files, jax_log) = ours, theirs
    assert log == jax_log
    assert_same_corpus(files, jax_files, corpus["traced"])
    made = {path.split(os.sep)[0] for path in files}
    want = {"step", "train.txt", "valid.txt", "test.txt"}
    if flags == "three_view":
        want = {"step", "3view_svg", "3view_png"}
    elif flags != "only_split":
        want |= {"json", "svg", "stat"}
    assert made == want, made


def oracle(root: str, num_cores: int) -> dict:
    """chip_smoke.py [8]'s ORACLE_CORPUS, from the JAX package."""
    import yaml

    from faceformer_tpu.tools.check_faces_enclosed import check_dataset
    from faceformer_tpu.tools.filters import filter_topology
    from faceformer_tpu.tools.filters.filter_length import filter_length

    if not os.path.isdir(os.path.join(root, "json")):
        run([os.path.join("tools", "gen_step_solids.py"), "--root", root,
             *chip_smoke.CORPUS_GEN])
        run([os.path.join("tools", "prepare_data.py"), "--root", root, *chip_smoke.CORPUS_PREP,
             "--num_cores", str(num_cores)], timeout=1800)
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(os.path.join(root, "json")))
    out = {"unclosed": len(check_dataset(root, num_cores=num_cores)),
           "length_kept": len(filter_length(root, names))}
    features = []
    for name in sorted(os.listdir(os.path.join(root, "stat"))):
        with open(os.path.join(root, "stat", name)) as f:
            features.append(filter_topology.topology_feature(yaml.safe_load(f)))
    out["topology_features"] = len({tuple(f) for f in features})
    out["topology_bins"] = len(filter_topology.bin_by_topology(features, names))
    out.update(chip_smoke.corpus_digest(root))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--num_cores", type=int, default=4)
    args = parser.parse_args()
    print(json.dumps(oracle(args.root, args.num_cores)))
