"""Knot-vector nesting and exact knot-insertion transfer matrices (port of
``coarsen_knots`` and ``insertion_matrix_1d`` of
tigar_tpu/solvers/multigrid.py; host numpy).  Nested spline spaces under
knot insertion give an exact prolongation V_coarse -> V_fine (Boehm's
algorithm, ops/refine.py), applied per direction by the stencil
multigrid of solvers/newton_stencil.py."""

from __future__ import annotations

import numpy as np

from ..ops.knots import KnotVector
from ..ops.refine import insert_knot
from ..config import KNOT_NEAR_EPS


def coarsen_knots(knots, p=None):
    """Remove every other interior unique knot (keeping multiplicities):
    the standard geometric coarsening, exact inverse of one dyadic
    refinement for uniform vectors.  Returns a plain knot array."""
    if not isinstance(knots, KnotVector) and p is None:
        raise ValueError("coarsen_knots needs the degree p for a plain "
                         "knot array")
    kv = knots if isinstance(knots, KnotVector) else KnotVector(p, knots)
    uniq, mult = kv.unique_knots, kv.multiplicities
    out = [uniq[0]] * int(mult[0])
    for i in range(1, len(uniq) - 1):
        if i % 2 == 0:
            out += [uniq[i]] * int(mult[i])
    out += [uniq[-1]] * int(mult[-1])
    return np.asarray(out, dtype=np.float64)


def insertion_matrix_1d(kv_coarse: KnotVector, kv_fine: KnotVector):
    """[ncp_f, ncp_c] refinement matrix: fine coefficients representing the
    same function as given coarse coefficients (exact for nested knots).
    Built by running Boehm knot insertion (ops/refine.py) on identity
    coefficient columns (open knot vectors)."""
    if kv_coarse.p != kv_fine.p:
        raise ValueError("multigrid levels must share the spline degree")
    if kv_coarse.is_periodic != kv_fine.is_periodic:
        raise ValueError("cannot mix periodic and open multigrid levels")
    if kv_coarse.is_periodic:
        raise NotImplementedError("periodic transfers are not ported yet")
    ck = list(kv_coarse.knots)
    fk = list(kv_fine.knots)
    # multiset difference fine \ coarse (with tolerance)
    missing = []
    i = 0
    for u in fk:
        if i < len(ck) and abs(ck[i] - u) <= KNOT_NEAR_EPS:
            i += 1
        else:
            missing.append(u)
    if i != len(ck):
        raise ValueError("coarse knot vector is not nested in the fine one")
    kv = np.asarray(ck, dtype=np.float64)
    M = np.eye(kv_coarse.ncp)
    for u in missing:
        kv, M = insert_knot(kv_coarse.p, kv, M, float(u))
    if len(kv) != len(fk) or np.max(np.abs(kv - np.asarray(fk))) \
            > 10 * KNOT_NEAR_EPS:
        raise ValueError("knot insertion did not reproduce the fine vector")
    assert M.shape == (kv_fine.ncp, kv_coarse.ncp)
    return M
