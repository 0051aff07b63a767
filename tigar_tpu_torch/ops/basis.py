"""Batched Cox-de Boor evaluation of B-spline basis functions and derivatives.

Host-side numpy copy of the numpy path of tigar_tpu/ops/basis.py
(NURBS-book algorithms A2.2/A2.3, vectorized over arrays of parameter
values).  The JAX package routes large batches through a host C++ helper
(tigar_tpu/native) computing the same recurrence; the port keeps the numpy
path only.
"""

from __future__ import annotations

import numpy as np


def bspline_basis_ders(ghost_knots, n_ghost, p, u, span, nders):
    """Evaluate the ``p+1`` nonzero B-spline basis functions and their first
    ``nders`` derivatives at each parameter in ``u``.

    Parameters
    ----------
    ghost_knots : [nknots + 2*n_ghost] padded knot array (KnotVector.ghost_knots)
    n_ghost     : padding offset (KnotVector.n_ghost)
    p           : polynomial degree
    u           : [n] parameter values
    span        : [n] knot-span index of each value, in *unpadded* indexing
                  (u in [knots[span], knots[span+1]))
    nders       : number of derivatives requested (>= 0)

    Returns
    -------
    ders : [n, nders+1, p+1] with ders[:, k, a] the k-th derivative of the
           a-th supported basis function (function index span - p + a).
    """
    u = np.asarray(u, dtype=np.float64)
    span = np.asarray(span, dtype=np.int64)
    n = u.shape[0]
    U = np.asarray(ghost_knots, dtype=np.float64)
    off = int(n_ghost)

    # Triangular table of basis values by degree (A2.2, vectorized over n).
    ndu = np.zeros((n, p + 1, p + 1))
    left = np.zeros((n, p + 1))
    right = np.zeros((n, p + 1))
    ndu[:, 0, 0] = 1.0
    for j in range(1, p + 1):
        left[:, j] = u - U[span + 1 - j + off]
        right[:, j] = U[span + j + off] - u
        saved = np.zeros(n)
        for r in range(j):
            ndu[:, j, r] = right[:, r + 1] + left[:, j - r]
            # Safe division: a zero support width implies a zero numerator
            # (can only occur for degenerate/discontinuous knot data).
            denom = ndu[:, j, r]
            temp = np.where(denom != 0.0, ndu[:, r, j - 1] / np.where(denom == 0.0, 1.0, denom), 0.0)
            ndu[:, r, j] = saved + right[:, r + 1] * temp
            saved = left[:, j - r] * temp
        ndu[:, j, j] = saved

    ders = np.zeros((n, nders + 1, p + 1))
    ders[:, 0, :] = ndu[:, :, p]
    if nders == 0:
        return ders

    kmax = min(nders, p)  # derivatives of order > p vanish identically
    # A2.3, vectorized over n; loops are O(p^2) in scalar work.
    for r in range(p + 1):
        a = np.zeros((n, 2, p + 1))
        a[:, 0, 0] = 1.0
        s1, s2 = 0, 1
        for k in range(1, kmax + 1):
            d = np.zeros(n)
            rk = r - k
            pk = p - k
            if r >= k:
                denom = ndu[:, pk + 1, rk]
                a[:, s2, 0] = np.where(denom != 0.0, a[:, s1, 0] / np.where(denom == 0.0, 1.0, denom), 0.0)
                d = a[:, s2, 0] * ndu[:, rk, pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = k - 1 if (r - 1) <= pk else p - r
            for j in range(j1, j2 + 1):
                denom = ndu[:, pk + 1, rk + j]
                a[:, s2, j] = np.where(
                    denom != 0.0,
                    (a[:, s1, j] - a[:, s1, j - 1]) / np.where(denom == 0.0, 1.0, denom),
                    0.0)
                d = d + a[:, s2, j] * ndu[:, rk + j, pk]
            if r <= pk:
                denom = ndu[:, pk + 1, r]
                a[:, s2, k] = np.where(denom != 0.0, -a[:, s1, k - 1] / np.where(denom == 0.0, 1.0, denom), 0.0)
                d = d + a[:, s2, k] * ndu[:, r, pk]
            ders[:, k, r] = d
            s1, s2 = s2, s1

    fac = float(p)
    for k in range(1, kmax + 1):
        ders[:, k, :] *= fac
        fac *= p - k
    return ders


def eval_basis(kv, u, nders=0):
    """Evaluate the basis functions of ``KnotVector`` kv at parameters u.

    Returns (nodes, ders): nodes [n, p+1] global function indices (wrapping
    for periodic splines), ders [n, nders+1, p+1].
    """
    u = np.atleast_1d(np.asarray(u, dtype=np.float64))
    span = kv.knot_span(u)
    ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p, u, span, nders)
    nodes = span[:, None] - kv.p + np.arange(kv.p + 1)[None, :]
    nodes = np.mod(nodes, kv.ncp)
    return nodes.astype(np.int64), ders


def bernstein_basis_ders(p, u, nders, interval=(-1.0, 1.0)):
    """Bernstein polynomials of degree ``p`` on ``interval`` with their
    first ``nders`` derivatives (the bi-cubic Bezier basis of the Rhino
    T-spline extraction format): the open B-spline basis of the knot
    vector with two distinct values, each of multiplicity p+1.

    Returns [n, nders+1, p+1].
    """
    from .knots import KnotVector
    u = np.atleast_1d(np.asarray(u, dtype=np.float64))
    a, b = interval
    knots = np.concatenate([np.full(p + 1, float(a)),
                            np.full(p + 1, float(b))])
    _, ders = eval_basis(KnotVector(p, knots), u, nders)
    return ders
