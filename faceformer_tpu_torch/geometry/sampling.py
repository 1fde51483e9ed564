"""Edge-polyline resampling to a fixed point count.

PyTorch port's counterpart of faceformer_tpu/geometry/sampling.py: a 2D
float32 batch resamples through the host library's ``resample_edges``
(``geometry/native.py``), as the JAX package's does; the numpy loop is its
plain version (``impl="plain"``), which tests hold it to bit for bit.

Behavior contract (reference: faceformer/datasets/data.py:11-28):
  - a 2-point polyline (straight line) is linearly interpolated to P points;
  - a longer polyline (curve) is subsampled by rounding P evenly spaced
    fractional indices over [0, len-1] — NOT by arc-length interpolation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from faceformer_tpu_torch.geometry import native


def resample_edge(edge: Sequence[Sequence[float]], num_samples: int = 50) -> np.ndarray:
    """Resample one polyline to exactly ``num_samples`` 2D points."""
    pts = np.asarray(edge, dtype=np.float64)
    if len(pts) == 2:
        t = np.linspace(0.0, 1.0, num_samples)[:, None]
        return pts[0] + (pts[1] - pts[0]) * t
    idx = np.linspace(0, len(pts) - 1, num_samples).round(0).astype(int)
    return pts[idx]


def resample_edge_batch(
    edges: Sequence[Sequence[Sequence[float]]],
    num_lines: int,
    num_samples: int = 50,
    point_dim: int = 2,
    dtype=np.float32,
    impl: str = "native",
) -> np.ndarray:
    """Pack a ragged edge list into a static (num_lines, num_samples, D) array.

    Rows past ``len(edges)`` stay zero (static padding, reference
    data.py:62-67). ``impl="native"`` resamples 2D float32 batches in the
    host library (other layouts run the numpy loop, which the library does
    not cover); ``"plain"`` always runs the numpy loop.
    """
    if impl not in ("native", "plain"):
        raise ValueError(f"impl must be 'native' or 'plain', not {impl!r}")
    out = np.zeros((num_lines, num_samples, point_dim), dtype=dtype)
    if len(edges) > num_lines:
        raise ValueError(f"{len(edges)} edges exceed num_lines={num_lines}")
    if len(edges) == 0:
        return out
    if impl == "native" and point_dim == 2 and dtype == np.float32:
        points, offsets = native.flatten_edges(edges)
        out[: len(edges)] = native.resample_edges_native(points, offsets, num_samples)
        return out
    for i, edge in enumerate(edges):
        out[i] = resample_edge(edge, num_samples)
    return out
