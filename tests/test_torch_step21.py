"""PyTorch port: the ISO-10303-21 reader and writer (``tools/step21.py``)
and the STEP corpus generator (``tools/gen_step_solids.py``) against the
JAX package's: every ``brep_*`` writer and every generator family writes
the same text, ``read_brep`` builds the same B-rep trees from it, and
malformed inputs (the fuzz harness's mutations and payloads) fail with the
same exception and message in both."""

import dataclasses
import os
import random
import struct

import numpy as np
import pytest

from faceformer_tpu.tools import step21 as jax_step21
from faceformer_tpu_torch.tools import gen_step_solids, step21
from tools import gen_step_solids as jax_gen
from tools.fuzz_step_reader import make_seeds, mutate, pathological

POLY = np.array([[0.0, 0.0], [1.6, 0.0], [1.6, 1.2], [0.7, 1.5], [0.0, 1.2]]) - [0.8, 0.7]
SEGMENTS = [np.array([[0.7, 0.0], [0.9, 0.5], [0.2, 0.8], [-0.3, 0.7]]),
            np.array([[-0.3, 0.7], [-0.9, 0.5], [-0.6, -0.6], [0.0, -0.8]]),
            np.array([[0.0, -0.8], [0.5, -0.9], [0.8, -0.4], [0.7, 0.0]])]
GRID = np.array([[0.5, 0.7, 0.6, 0.5], [0.6, 1.1, 0.9, 0.6], [0.5, 0.8, 0.7, 0.4]])

# every writer, with the rational and NURBS encodings
WRITERS = {
    "extrusion": lambda m: m.brep_extrusion(POLY, -0.4, 0.4, name="ext"),
    "extrusion_holes": lambda m: m.brep_extrusion(
        POLY, -0.3, 0.5, holes=[(-0.3, -0.2, 0.15), (0.3, 0.2, 0.2)], name="holes"),
    "plate_features": lambda m: m.brep_plate_features(
        POLY, -0.3, 0.3, [("hole", -0.4, -0.2, 0.12, 0.0), ("boss", 0.3, 0.1, 0.15, 0.4),
                          ("dome_boss", -0.1, 0.4, 0.1, 0.3), ("pocket", 0.2, -0.3, 0.1, 0.2)],
        name="plate"),
    "cylinder": lambda m: m.brep_cylinder(0.7, 1.1),
    "nurbs_cylinder": lambda m: m.brep_nurbs_cylinder(0.6, 0.9),
    "dome": lambda m: m.brep_dome(0.8, 0.6),
    "dome_block": lambda m: m.brep_dome_block(0.6, 1.0),
    "torus": lambda m: m.brep_torus(0.8, 0.3),
    "round_top": lambda m: m.brep_round_top_cylinder(0.7, 0.9, 0.2),
    "cone": lambda m: m.brep_cone(0.7, 1.1),
    "frustum": lambda m: m.brep_frustum(0.8, 0.5, 0.9),
    "pillow": lambda m: m.brep_pillow(GRID, 0.8, 0.7),
    "pillow_rational": lambda m: m.brep_pillow(GRID, 0.8, 0.7, interior_weight=2.2),
    "vase": lambda m: m.brep_vase(np.array([[0.5, 0.0], [0.8, 0.3], [0.4, 0.7], [0.6, 1.1]])),
    "spline_prism": lambda m: m.brep_spline_prism(SEGMENTS, -0.4, 0.4),
}


def brep_tree(obj, memo=None):
    """A B-rep (or any value inside one) as nested tuples of plain values:
    floats and arrays by their bytes, shared records by the index of their
    first appearance, so two trees are equal when every number, every
    record and every sharing is."""
    memo = {} if memo is None else memo
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, (float, np.floating)):
        return ("float", struct.pack("<d", float(obj)))
    if obj is None or isinstance(obj, (bool, int, str, np.integer)):
        return (type(obj).__name__, obj if isinstance(obj, str) or obj is None else int(obj))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(brep_tree(x, memo) for x in obj))
    if isinstance(obj, dict):
        return ("dict", tuple((brep_tree(k, memo), brep_tree(v, memo)) for k, v in obj.items()))
    assert dataclasses.is_dataclass(obj), type(obj)
    if id(obj) in memo:
        return ("shared", memo[id(obj)])
    memo[id(obj)] = len(memo)
    return (type(obj).__name__,
            tuple((k, brep_tree(v, memo)) for k, v in sorted(vars(obj).items())))


def read_outcome(module, path):
    """What ``read_brep`` makes of a file: the B-rep tree, or the
    exception's class name and message."""
    try:
        with np.errstate(all="ignore"):
            return ("ok", brep_tree(module.read_brep(path)))
    except Exception as exc:  # noqa: BLE001 — the outcome is what is compared
        return (type(exc).__name__, str(exc))


def write(tmp_path, name, text):
    path = os.path.join(str(tmp_path), f"{name}.step")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_writer_text_and_read_brep_equal_jax(writer, tmp_path):
    text = WRITERS[writer](step21)
    assert text == WRITERS[writer](jax_step21)
    path = write(tmp_path, writer, text)
    ours = read_outcome(step21, path)
    assert ours[0] == "ok" and len(ours[1][1]) == 1, ours[:1]
    assert ours == read_outcome(jax_step21, path)


@pytest.mark.parametrize("family", jax_gen.FAMILIES)
def test_gen_step_solids_family_equals_jax(family, tmp_path):
    """Each family drawn alone, from three seeds, writes the root script's
    text; both readers build the same trees from it."""
    assert gen_step_solids.FAMILIES == jax_gen.FAMILIES
    assert gen_step_solids.FAMILY_PROBS == jax_gen.FAMILY_PROBS
    probs = [float(f == family) for f in jax_gen.FAMILIES]
    for seed in range(3):
        name = f"{seed:08d}"
        ours = gen_step_solids.random_step_solid(
            np.random.default_rng(np.random.SeedSequence([seed, 7])), name, probs=probs)
        theirs = jax_gen.random_step_solid(
            np.random.default_rng(np.random.SeedSequence([seed, 7])), name, probs=probs)
        assert ours == theirs
        path = write(tmp_path, name, ours)
        assert read_outcome(step21, path) == read_outcome(jax_step21, path)


def test_parse_weights_equals_jax():
    spec = "torus=4,cone=4,vase=3"
    assert gen_step_solids.parse_weights(spec) == jax_gen.parse_weights(spec)
    for module in (gen_step_solids, jax_gen):
        with pytest.raises(SystemExit, match="unknown family"):
            module.parse_weights("blob=2")


@pytest.fixture(scope="module")
def seed_texts():
    return make_seeds(7, 6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mutated_inputs_fail_alike(seed, seed_texts, tmp_path):
    """The fuzz harness's mutations of writer output: each gives the same
    tree in both readers, or the same exception with the same message."""
    rng = random.Random(seed)
    kinds = []
    for k in range(12):
        path = write(tmp_path, f"mut{k:02d}", mutate(rng.choice(seed_texts), rng))
        ours = read_outcome(step21, path)
        assert ours == read_outcome(jax_step21, path), (k, ours[:1])
        kinds.append(ours[0])
    assert set(kinds) - {"ok"}, kinds  # some input of each seed is refused


def test_pathological_and_unsupported_inputs_fail_alike(tmp_path):
    texts = [t for n, t in pathological() if n != "giant_flat"]
    cylinder = step21.brep_cylinder(0.7, 1.1)
    # geometry outside the reader's subset, and a dangling reference
    texts.append(cylinder.replace("CYLINDRICAL_SURFACE", "OFFSET_SURFACE"))
    texts.append(cylinder.replace("CIRCLE(", "HYPERBOLA(", 1))
    texts.append(cylinder.replace("MANIFOLD_SOLID_BREP('cylinder',#",
                                  "MANIFOLD_SOLID_BREP('cylinder',#9999", 1))
    seen = set()
    for k, text in enumerate(texts):
        path = write(tmp_path, f"bad{k:02d}", text)
        ours = read_outcome(step21, path)
        assert ours == read_outcome(jax_step21, path), (k, ours[:1])
        seen.add(ours[0])
    assert {"UnsupportedStep", "StepSyntaxError"} <= seen, seen
