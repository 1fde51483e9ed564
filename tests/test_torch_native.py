"""PyTorch port: the C++ host library's geometry bridge
(``geometry/native.py``, built by ``ops/_build.py`` from ``csrc/host/``)
against the JAX package: resampling bit for bit, batch enclosedness equal
to the Python predicate, the ABI handshake and the build's failures, which
raise (there is no fallback). The counterparts of tests/test_native.py's
cases come first."""

import os
import shutil

import numpy as np
import pytest

from faceformer_tpu.geometry import native as jax_native
from faceformer_tpu.geometry.enclosedness import is_face_enclosed as jax_is_face_enclosed
from faceformer_tpu.geometry.fixtures import random_sample as jax_random_sample
from faceformer_tpu.geometry.sampling import resample_edge as jax_resample_edge
from faceformer_tpu.post_processing import (
    filter_faces_by_encloseness as jax_filter_faces_by_encloseness,
)
from faceformer_tpu_torch.geometry import native
from faceformer_tpu_torch.geometry.fixtures import random_sample
from faceformer_tpu_torch.geometry.sampling import resample_edge, resample_edge_batch
from faceformer_tpu_torch.ops import _build
from faceformer_tpu_torch.post_processing import filter_faces_by_encloseness

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is absent: the host library cannot be built")

SQUARE = [[[0, 0], [1, 0]], [[1, 0], [1, 1]], [[1, 1], [0, 1]], [[0, 1], [0, 0]]]


def random_edges(rng, count=30):
    return [rng.standard_normal((int(rng.integers(2, 40)), 2)).tolist() for _ in range(count)]


def typed_faces(sample):
    return [(t, tuple(i for lp in loops for i in lp)) for t, loops in sample["faces_indices"]]


# --- counterparts of tests/test_native.py ------------------------------------


class TestAbiHandshake:
    def test_version_matches(self):
        assert int(native.load().faceformer_abi_version()) == native.FACEFORMER_NATIVE_ABI

    def test_mismatch_refuses_to_bind(self, monkeypatch):
        # a library of another ABI raises (the JAX package warns and falls
        # back; the port has no fallback)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "FACEFORMER_NATIVE_ABI", native.FACEFORMER_NATIVE_ABI + 1)
        with pytest.raises(RuntimeError, match="ABI"):
            native.load()
        assert native._lib is None
        monkeypatch.undo()
        assert native.load() is not None  # the real version binds again


class TestResample:
    def test_parity_random_edges(self):
        edges = random_edges(np.random.default_rng(0))
        points, offsets = native.flatten_edges(edges)
        nat = native.resample_edges_native(points, offsets, 50)
        ref = np.stack([np.asarray(resample_edge(e, 50), dtype=np.float32) for e in edges])
        np.testing.assert_array_equal(nat, ref)

    def test_wired_into_packing(self):
        rng = np.random.default_rng(1)
        edges = [rng.standard_normal((5, 2)).tolist() for _ in range(4)]
        out = resample_edge_batch(edges, num_lines=6, num_samples=8)
        assert out.shape == (6, 8, 2)
        assert np.all(out[4:] == 0)
        np.testing.assert_array_equal(out, resample_edge_batch(edges, 6, 8, impl="plain"))


class TestEnclosedness:
    def test_parity_on_fixtures(self):
        rng = np.random.default_rng(2)
        for _ in range(5):
            sample = random_sample(rng)
            edges = sample["edges"]
            points, offsets = native.flatten_edges(edges)
            faces = [[i for lp in loops for i in lp] for _, loops in sample["faces_indices"]]
            all_faces = faces + [list(reversed(f)) for f in faces[:2]]  # corrupted
            nat = native.check_faces_enclosed_native(points, offsets, all_faces, 2e-4)
            for face, out in zip(all_faces, nat):
                py = jax_is_face_enclosed(edges, face, 2e-4)
                if py is False:
                    assert out is None
                else:
                    assert out == [sum(len(lp) for lp in py[: k + 1]) for k in range(len(py))]

    def test_filter_batch_matches_python(self):
        sample = random_sample(np.random.default_rng(3))
        edges = sample["edges"]
        typed = typed_faces(sample)
        typed += [(0, tuple(reversed(typed[0][1])))]  # one broken face
        nat = native.filter_faces_by_encloseness_batch(edges, typed, 2e-4)
        assert nat == jax_filter_faces_by_encloseness(edges, typed, 2e-4)
        assert nat == filter_faces_by_encloseness(edges, typed, 2e-4)

    @pytest.mark.parametrize("faces", [
        [(0, (99,))],             # every index out of range -> dropped
        [(0, (-1, -2))],          # in-range negatives wrap like Python indexing
        [(0, (0, 1, 2, 3))],      # plain enclosed square
        [(1, (3, 99, 2, 1, 0))],  # an out-of-range id skipped mid-face
        [(0, ())],                # no index at all -> zero loops, dropped
        [(2, (-4, 1, 2, 3)), (0, (0, 1, 7, 2, 3, 0, 1, 2, 3))],  # two loops
    ])
    def test_filter_batch_degenerate_faces_match_python(self, faces):
        ref = jax_filter_faces_by_encloseness(SQUARE, faces, 1e-6)
        assert native.filter_faces_by_encloseness_batch(SQUARE, faces, 1e-6) == ref
        assert jax_native.filter_faces_by_encloseness_batch(SQUARE, faces, 1e-6) == ref


# --- the port against the JAX package ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_resample_bit_equal_jax(seed):
    """Random polylines (2 points: interpolated; more: subsampled, with
    half-way indices rounded to even) and fixture edges, as float32."""
    rng = np.random.default_rng(seed)
    edges = random_edges(rng, 40) + [[[0.0, 0.0], [1.0, 0.5]], [[1.0, 2.0]],
                                     [[0, 0], [1, 1], [2, 2], [3, 3]]]
    edges += random_sample(rng, profile="rich")["edges"]
    for num_samples in (1, 2, 3, 5, 8, 50):  # 3 and 5 meet half-way indices
        nat = native.resample_edges_native(*native.flatten_edges(edges), num_samples)
        want = np.stack([jax_resample_edge(e, num_samples).astype(np.float32) for e in edges])
        assert nat.tobytes() == want.tobytes(), num_samples
    out = resample_edge_batch(edges, len(edges) + 3, 50)
    assert out[len(edges):].tobytes() == bytes(3 * 50 * 2 * 4)


def test_flatten_edges_equals_jax():
    rng = np.random.default_rng(4)
    cases = [random_edges(rng, 12), [], [np.ones((3, 3)) * k for k in range(4)],
             [[[0.5, 1.5, 9.0], [2.0, 3.0, 9.0]], [[1.0, 1.0], [2.0, 2.0]]]]
    for edges in cases:
        (p, o), (jp, jo) = native.flatten_edges(edges), jax_native.flatten_edges(edges)
        assert p.dtype == jp.dtype == np.float64 and o.dtype == jo.dtype == np.int64
        assert p.tobytes() == jp.tobytes() and o.tobytes() == jo.tobytes()
    with pytest.raises(IndexError):
        native.flatten_edges([[[0.0, 0.0], [1.0, 1.0]], []])


@pytest.mark.parametrize("seed", range(3))
def test_filter_batch_equals_jax_predicate(seed):
    """Fixture faces, reversed, rotated and shuffled ones, negative and
    out-of-range ids: the batch filter equals the JAX package's Python
    predicate, with edges flattened once for two calls."""
    rng = np.random.default_rng(10 + seed)
    sample = jax_random_sample(rng, profile="rich")
    edges = sample["edges"]
    n = len(edges)
    faces = typed_faces(sample)
    extra = []
    for t, face in faces[:6]:
        f = list(face)
        extra.append((t, tuple(reversed(f))))
        extra.append((t, tuple(f[1:] + f[:1])))
        extra.append((t, tuple(i - n for i in f)))  # every id negative, in range
        extra.append((t, tuple(f + [n + 5])))
        extra.append((t, tuple(rng.permutation(f).tolist())))
    faces += extra
    flat = native.flatten_edges(edges)
    for subset in (faces, faces[::-1]):
        ref = jax_filter_faces_by_encloseness(edges, subset, 2e-4)
        assert native.filter_faces_by_encloseness_batch(edges, subset, 2e-4, flat) == ref
        assert native.filter_faces_by_encloseness_batch(edges, subset, 2e-4) == ref


def test_filter_batch_tuple_indices_take_the_python_predicate():
    """Direction-token faces ((index, orientation) pairs) go to the Python
    predicate, as in the JAX package."""
    sample = random_sample(np.random.default_rng(5), direction_token=True)
    edges = sample["edges"]
    faces = [(0, tuple(tuple(i) for lp in loops for i in lp))  # no face types
             for loops in sample["faces_indices"]]
    faces += [(0, tuple(reversed(faces[0][1])))]
    ref = jax_filter_faces_by_encloseness(edges, faces, 2e-4)
    assert ref  # the fixture's faces are enclosed
    assert native.filter_faces_by_encloseness_batch(edges, faces, 2e-4) == ref


@pytest.fixture
def cold_build(tmp_path, monkeypatch):
    """A build directory of its own, with nothing built and nothing loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_missing_compiler_raises(cold_build, monkeypatch):
    monkeypatch.setattr(_build, "GXX", "no-such-g++")
    with pytest.raises(RuntimeError, match="no-such-g.. not found"):
        native.load()
    with pytest.raises(RuntimeError, match="not found"):
        resample_edge_batch([[[0.0, 0.0], [1.0, 1.0]]], 2, 4)
    assert not os.path.exists(_build.lib_path(_build.HOST))


def test_failed_compile_raises_with_the_log(cold_build, monkeypatch):
    csrc = cold_build / "csrc"
    (csrc / "host").mkdir(parents=True)
    (csrc / "host" / "broken.cc").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    with pytest.raises(RuntimeError, match=r"faceformer_host \(g\+\+ exit [1-9](.|\n)*broken"):
        native.load()
    assert not os.path.exists(_build.lib_path(_build.HOST))
    with open(_build.log_path(_build.HOST)) as f:
        assert "error" in f.read()


def test_cold_build_then_stale_rule(cold_build):
    """A cold build writes one library; a newer source makes it stale."""
    assert _build.build_all([_build.HOST]) == [_build.HOST]
    assert _build.build_all([_build.HOST]) == []
    lib = _build.lib_path(_build.HOST)
    assert os.path.dirname(lib) == _build.BUILD_DIR and os.path.isfile(lib)
    src = os.path.join(_build.CSRC, "host", "geometry_kernel.cc")
    os.utime(lib, (os.path.getmtime(src) - 10,) * 2)
    assert _build._stale(_build.HOST)
    assert int(native.load().faceformer_abi_version()) == 2
