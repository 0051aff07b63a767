"""Knot insertion / h-refinement for (NURBS) control nets.

The reference delegates geometry refinement to igakit
(demos/poisson/poisson-nurbs.py:45-59 calls NURBS.refine on each direction
before extraction).  igakit is not part of this framework's substrate, so
Boehm's knot-insertion algorithm is implemented here directly, acting on
homogeneous control nets (insertion is exact for NURBS in homogeneous
coordinates).

Host-side numpy copy of tigar_tpu/ops/refine.py for the PyTorch port (which never
imports the JAX package).
"""

from __future__ import annotations

import numpy as np


def insert_knot(p, knots, ctrl, u):
    """Insert a single knot ``u`` into the degree-``p`` B-spline with knot
    vector ``knots`` and control points ``ctrl`` ([n, ...], axis 0 is the
    control-point index).  Returns (new_knots, new_ctrl)."""
    knots = np.asarray(knots, dtype=np.float64)
    ctrl = np.asarray(ctrl)
    n = ctrl.shape[0]
    # span k: last index with knots[k] <= u
    k = int(np.searchsorted(knots, u, side="right") - 1)
    new_ctrl = np.zeros((n + 1,) + ctrl.shape[1:], dtype=ctrl.dtype)
    new_ctrl[:k - p + 1] = ctrl[:k - p + 1]
    for i in range(k - p + 1, k + 1):
        denom = knots[i + p] - knots[i]
        alpha = (u - knots[i]) / denom if denom > 0.0 else 0.0
        new_ctrl[i] = alpha * ctrl[i] + (1.0 - alpha) * ctrl[i - 1]
    new_ctrl[k + 1:] = ctrl[k:]
    new_knots = np.insert(knots, k + 1, u)
    return new_knots, new_ctrl


def refine_axis(p, knots, ctrl_grid, new_knots, axis):
    """Insert each value of ``new_knots`` along ``axis`` of a tensor-product
    control grid ``ctrl_grid`` (shape [n0, n1, ..., ncomp])."""
    ctrl = np.moveaxis(np.asarray(ctrl_grid), axis, 0)
    kv = np.asarray(knots, dtype=np.float64)
    for u in np.atleast_1d(new_knots):
        kv, ctrl = insert_knot(p, kv, ctrl, float(u))
    return kv, np.moveaxis(ctrl, 0, axis)


def uniform_refine(degrees, kvecs, ctrl_grid, levels=1):
    """Dyadically refine all directions ``levels`` times by inserting element
    midpoints (mirrors the igakit refinement loop in poisson-nurbs.py:49-59).
    """
    kvecs = [np.asarray(k, dtype=np.float64) for k in kvecs]
    ctrl = np.asarray(ctrl_grid)
    for _ in range(levels):
        for d, p in enumerate(degrees):
            uniq = np.unique(kvecs[d])
            mids = 0.5 * (uniq[:-1] + uniq[1:])
            kvecs[d], ctrl = refine_axis(p, kvecs[d], ctrl, mids, d)
    return kvecs, ctrl
