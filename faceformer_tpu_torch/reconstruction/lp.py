"""L1 plane-fit linear program (a copy of faceformer_tpu/reconstruction/lp.py).

Reference formulation (reconstruct_to_wireframe.py:302-310):
    minimize ||P f + b||_1   subject to   C f >= 0
solved there with cvxpy -> ECOS. Problem sizes are tiny (3 vars per face).
Here the L1 norm is reformulated as a standard LP over [f; t]:
    minimize 1^T t   s.t.  P f - t <= -b,  -P f - t <= b,  -C f <= 0
and handed to scipy's HiGHS simplex/IPM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.optimize import linprog


def solve_l1_plane_fit(P: np.ndarray, b: np.ndarray, C: np.ndarray) -> Optional[np.ndarray]:
    """Solve min ||P f + b||_1 s.t. C f >= 0. Returns f or None on failure."""
    P = np.atleast_2d(np.asarray(P, dtype=float))
    b = np.asarray(b, dtype=float).reshape(-1)
    n_rows, n_vars = P.shape
    if n_vars == 0 or n_rows == 0:
        return None
    C = np.atleast_2d(np.asarray(C, dtype=float))
    if C.size == 0:
        C = np.zeros((0, n_vars))

    eye = np.eye(n_rows)
    A_ub = np.vstack([
        np.hstack([P, -eye]),
        np.hstack([-P, -eye]),
        np.hstack([-C, np.zeros((C.shape[0], n_rows))]),
    ])
    b_ub = np.concatenate([-b, b, np.zeros(C.shape[0])])
    cost = np.concatenate([np.zeros(n_vars), np.ones(n_rows)])
    bounds = [(None, None)] * n_vars + [(0, None)] * n_rows

    result = linprog(cost, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
    if not result.success:
        return None
    return result.x[:n_vars]
