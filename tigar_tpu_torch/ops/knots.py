"""Knot-vector utilities: the univariate layer of the spline core.

TPU-native re-design of the univariate B-spline bookkeeping in the reference
(tIGAr/BSplines.py:14-351, classes ``uniformKnots``/``BSpline1``).  All
heavy evaluation is batched over arrays of parameter values (see
ops/basis.py); this module holds the host-side (numpy) metadata: unique
knots, multiplicities, ghost knots for periodic splines, Greville points,
element spans and per-element supported-function indices.

Host-side numpy copy of tigar_tpu/ops/knots.py for the PyTorch port (which never
imports the JAX package).
"""

from __future__ import annotations

import numpy as np

from ..config import INDEX_TYPE, KNOT_NEAR_EPS


def uniform_knots(p, start, end, nel, periodic=False, continuity_drop=0):
    """Uniform knot vector of degree ``p`` with ``nel`` elements on
    [start, end].

    Open (end knots repeated ``p+1`` times) unless ``periodic``; interior
    knots have multiplicity ``continuity_drop + 1``.  Matches the semantics
    of the reference helper (BSplines.py:14-38).
    """
    if continuity_drop >= p:
        raise ValueError("Continuity drop too high for spline degree.")
    knots = []
    if not periodic:
        knots += [float(start)] * (p - continuity_drop)
    h = (end - start) / float(nel)
    for i in range(nel + 1):
        knots += [start + i * h] * (continuity_drop + 1)
    if not periodic:
        knots += [float(end)] * (p - continuity_drop)
    return np.asarray(knots, dtype=np.float64)


class KnotVector:
    """Univariate B-spline knot vector of degree ``p``.

    Periodic (unclamped) knot vectors are supported through ghost knots
    conjured by reflection, and basis-function indices that wrap modulo the
    number of control points (reference: BSplines.py:196-319).
    """

    def __init__(self, p, knots):
        self.p = int(p)
        self.knots = np.asarray(knots, dtype=np.float64).copy()
        if self.knots.ndim != 1 or len(self.knots) < 2 * (p + 1) - p:
            raise ValueError("knot vector too short for degree %d" % p)
        if np.any(np.diff(self.knots) < -KNOT_NEAR_EPS):
            raise ValueError("knots must be non-decreasing")
        self._compute_unique()
        # ncp = len(knots) - multiplicity of first unique knot
        # (reference: BSplines.py:273-277; open vector -> len(knots)-p-1,
        #  periodic vector with mult 1 -> len(knots)-1).
        self.ncp = len(self.knots) - int(self.multiplicities[0])
        self.nel = len(self.unique_knots) - 1
        self.n_ghost = self.p + 1
        self.ghost_knots = self._compute_ghost_knots()

    # -- construction helpers -------------------------------------------------

    def _compute_unique(self):
        uniq = [self.knots[0]]
        mult = [1]
        for k in self.knots[1:]:
            if abs(k - uniq[-1]) <= KNOT_NEAR_EPS:
                mult[-1] += 1
            else:
                uniq.append(k)
                mult.append(1)
        self.unique_knots = np.asarray(uniq, dtype=np.float64)
        self.multiplicities = np.asarray(mult, dtype=INDEX_TYPE)

    def get_knot(self, i):
        """Knot with a possibly out-of-range index; ghosts are generated by
        looking at the other end of the vector (periodic reflection,
        reference BSplines.py:245-260)."""
        n = len(self.knots)
        if i < 0:
            ii = n - int(self.multiplicities[-1]) + i
            return self.knots[0] - (self.knots[-1] - self.knots[ii])
        elif i >= n:
            ii = i - n + int(self.multiplicities[0])
            return self.knots[-1] + (self.knots[ii] - self.knots[0])
        return self.knots[i]

    def _compute_ghost_knots(self):
        lo, hi = -self.n_ghost, len(self.knots) + self.n_ghost
        return np.asarray([self.get_knot(i) for i in range(lo, hi)],
                          dtype=np.float64)

    def normalize(self):
        """Rescale the knot vector to (0, 1) in place."""
        L = self.knots[-1] - self.knots[0]
        k0 = self.knots[0]
        self.knots = (self.knots - k0) / L
        self.unique_knots = (self.unique_knots - self.unique_knots[0]) / L
        self.ghost_knots = self._compute_ghost_knots()
        return self

    # -- queries ---------------------------------------------------------------

    @property
    def is_periodic(self):
        return int(self.multiplicities[0]) < self.p + 1

    def is_discontinuous(self):
        """True if any interior knot has multiplicity > p
        (reference: BSplines.py:225-233)."""
        return bool(np.any(self.multiplicities[1:-1] > self.p))

    def greville(self, i=None):
        """Greville abscissa(e).  ``i`` may be an index, an array of indices,
        or None for all ``ncp`` points."""
        if i is None:
            i = np.arange(self.ncp)
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        # mean of knots i+1 .. i+p via the precomputed ghost-extended
        # vector (ghost_knots[k + n_ghost] == get_knot(k)); one sliding
        # window gather instead of a per-point Python loop
        idx = i[:, None] + np.arange(1, self.p + 1)[None, :] + self.n_ghost
        out = self.ghost_knots[idx].mean(axis=1)
        return out if out.shape != (1,) else out.reshape(())

    def knot_span(self, u):
        """Index (into the full knot vector) of the knot span containing
        ``u``, clamped away from degenerate end spans
        (reference: BSplines.py:285-308).  Vectorized over ``u``."""
        u = np.atleast_1d(np.asarray(u, dtype=np.float64))
        nspans = len(self.knots) - 1
        span = np.searchsorted(self.knots, u) - 1
        lo = int(self.multiplicities[0]) - 1
        hi = nspans - (int(self.multiplicities[-1]) - 1) - 1
        return np.clip(span, lo, hi).astype(np.int64)

    def element_spans(self):
        """Knot-span index of the left end of each (non-degenerate) element.

        Element ``k`` occupies [unique_knots[k], unique_knots[k+1]); its span
        index in the full vector is ``sum(multiplicities[:k+1]) - 1``.
        """
        return (np.cumsum(self.multiplicities[:-1]) - 1).astype(np.int64)

    def element_nodes(self):
        """[nel, p+1] global indices of basis functions supported on each
        element, wrapping modulo ncp for periodic splines
        (reference: BSplines.py:310-319)."""
        spans = self.element_spans()
        nodes = spans[:, None] - self.p + np.arange(self.p + 1)[None, :]
        return np.mod(nodes, self.ncp).astype(INDEX_TYPE)

    def element_sizes(self):
        """[nel] parametric length of each element."""
        return np.diff(self.unique_knots)

    def side_indices(self, side, n_layers=1):
        """1D control-point indices of ``n_layers`` layers at ``side``
        (0 = start, 1 = end)."""
        if side == 0:
            return np.arange(n_layers, dtype=INDEX_TYPE)
        return (self.ncp - 1 - np.arange(n_layers)).astype(INDEX_TYPE)


# -- tensor-product index conventions (reference: BSplines.py:353-370) --------
# i is the fastest-varying index, j next, k outermost.

def ij2dof(i, j, M):
    return j * M + i


def ijk2dof(i, j, k, M, N):
    return k * (M * N) + j * M + i


def dof2ij(dof, M):
    return dof % M, dof // M


def dof2ijk(dof, M, N):
    ij = dof % (M * N)
    return ij % M, ij // M, dof // (M * N)
