"""Per-Bezier-element basis tabulation: the TPU-native extraction format.

The reference represents every spline basis as a sparse extraction matrix M
mapping IGA DoFs to nodal DoFs of a C0/C-1 finite-element space on an
"extraction mesh", and assembles FE matrices with FEniCS before projecting
with PETSc MatPtAP (tIGAr/common.py:130-503, 1176-1204).  On TPU, the
structured Bezier-element grid *is* the data layout: we tabulate every
supported basis function (value, parametric gradient, parametric Hessian) at
every quadrature point of every element once, as dense batched arrays, and
assembly becomes batched tensor contractions + segment-sum scatter.  The FE
space, the extraction matrix, and the PtAP triple product all disappear.

A ``Tabulation`` is equivalent information to one block-row of tIGAr's M:
``N[e, q, a]`` is the value of global basis function ``conn[e, a]`` at
quadrature point ``q`` of element ``e``.

Host-side numpy copy of the volume path of tigar_tpu/ops/tabulation.py
for the PyTorch port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import INDEX_TYPE
from .basis import bspline_basis_ders
from .quadrature import gauss_rule


@dataclasses.dataclass
class Tabulation:
    """Batched per-element basis tabulation for one scalar field.

    Attributes
    ----------
    conn : [nel, nen] int32   global basis-function index per element-local slot
    N    : [nel, nq, nen]     basis values at quadrature points
    dN   : [nel, nq, nen, d]  parametric gradients (order >= 1)
    d2N  : [nel, nq, nen, d, d] parametric Hessians (order >= 2), else None
    qp   : [nel, nq, d]       parametric coordinates of quadrature points
    qw   : [nel, nq]          parametric quadrature weights (incl. element size)
    ncp  : total number of basis functions in the field
    dim  : parametric dimension
    normal : outward reference normal for boundary tabulations: [d] for
           one side, or [nel, d] per-element (whole-boundary batches);
           else None
    mask : [nel, nen] float 0/1 padding mask for ragged bases (T-splines,
           multi-patch with mixed degrees); None means all-active.
    """

    conn: np.ndarray
    N: np.ndarray
    dN: Optional[np.ndarray]
    d2N: Optional[np.ndarray]
    qp: np.ndarray
    qw: np.ndarray
    ncp: int
    dim: int
    normal: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None

    @property
    def nel(self):
        return self.conn.shape[0]

    @property
    def nen(self):
        return self.conn.shape[1]

    @property
    def nq(self):
        return self.qw.shape[1]

    def with_offset(self, offset):
        """Shift connectivity by a global DoF offset (multi-field layouts)."""
        return dataclasses.replace(self, conn=(self.conn + offset).astype(INDEX_TYPE))


def _dir_tabulation(kv, npts, nders, rule=None):
    """Tabulate one knot vector on all its elements.

    Returns (nodes [nel, p+1], ders [nel, nq, nders+1, p+1],
             qp [nel, nq], qw [nel, nq]).
    """
    if rule is None:
        g, w = gauss_rule(npts)
    else:
        g, w = np.asarray(rule[0]), np.asarray(rule[1])
        npts = len(g)
    spans = kv.element_spans()
    nodes = kv.element_nodes()
    lefts = kv.unique_knots[:-1]
    h = kv.element_sizes()
    # map rule points from (-1,1) into each element
    qp = lefts[:, None] + (g[None, :] + 1.0) * 0.5 * h[:, None]  # [nel, nq]
    qw = 0.5 * h[:, None] * w[None, :]
    nel = kv.nel
    u_flat = qp.reshape(-1)
    span_flat = np.repeat(spans, npts)
    ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p, u_flat,
                              span_flat, nders)
    ders = ders.reshape(nel, npts, nders + 1, kv.p + 1)
    return nodes, ders, qp, qw


def _combine_tensor(dir_data, ncps, nders):
    """Combine per-direction tabulations into a flattened tensor-product
    Tabulation.  ``dir_data`` is a list of (nodes_d [nel_d, m_d],
    ders_d [nel_d, nq_d, nders+1, m_d], qp_d [nel_d, nq_d], qw_d [nel_d, nq_d])
    and ``ncps`` the per-direction control-point counts.

    Conventions: direction 0 is the fastest-varying index for elements,
    local shape functions, quadrature points, and global DoFs
    (reference ij2dof/ijk2dof, BSplines.py:353-370).
    """
    dim = len(dir_data)
    nel_d = [d[0].shape[0] for d in dir_data]
    m_d = [d[0].shape[1] for d in dir_data]
    nq_d = [d[2].shape[1] for d in dir_data]
    nel = int(np.prod(nel_d))
    nen = int(np.prod(m_d))
    nq = int(np.prod(nq_d))

    # dof strides, direction 0 fastest
    strides = np.cumprod([1] + list(ncps[:-1])).astype(np.int64)

    # ---- connectivity: conn[e, a] with e and a in dir-0-fastest order
    conn = np.zeros((nel, nen), dtype=np.int64)
    qp = np.zeros((nel, nq, dim))
    qw = np.ones((nel, nq))
    # basis value products for derivative multi-orders up to nders
    # build N, dN, d2N by accumulating per-direction factors
    N = np.ones((nel, nq, nen))
    dN = np.ones((nel, nq, nen, dim)) if nders >= 1 else None
    d2N = np.ones((nel, nq, nen, dim, dim)) if nders >= 2 else None

    # index helpers: decompose flattened ids into per-direction ids
    e_idx = np.unravel_index(np.arange(nel), nel_d[::-1])[::-1]  # dir0 fastest
    a_idx = np.unravel_index(np.arange(nen), m_d[::-1])[::-1]
    q_idx = np.unravel_index(np.arange(nq), nq_d[::-1])[::-1]

    for d in range(dim):
        nodes_d, ders_d, qp_d, qw_d = dir_data[d]
        ed = e_idx[d]          # [nel]
        ad = a_idx[d]          # [nen]
        qd = q_idx[d]          # [nq]
        conn += nodes_d[ed][:, ad] * strides[d]
        qp[:, :, d] = qp_d[ed][:, qd]
        qw *= qw_d[ed][:, qd]
        v0 = ders_d[ed][:, qd, 0, :][:, :, ad]      # [nel, nq, nen] values
        N *= v0
        if nders >= 1:
            v1 = ders_d[ed][:, qd, 1, :][:, :, ad]
            for dd in range(dim):
                dN[:, :, :, dd] *= (v1 if dd == d else v0)
        if nders >= 2:
            v2 = ders_d[ed][:, qd, 2, :][:, :, ad]
            for d1 in range(dim):
                for d2 in range(dim):
                    if d1 == d and d2 == d:
                        f = v2
                    elif d1 == d or d2 == d:
                        f = v1
                    else:
                        f = v0
                    d2N[:, :, :, d1, d2] *= f

    ncp = int(np.prod(ncps))
    return Tabulation(conn=conn.astype(INDEX_TYPE), N=N, dN=dN, d2N=d2N,
                      qp=qp, qw=qw, ncp=ncp, dim=dim)


def tabulate_tensor_bspline(kvs, npts_per_dir, nders, rule=None):
    """Volume tabulation of a tensor-product B-spline basis.

    kvs : list of KnotVector (length = parametric dimension)
    npts_per_dir : int or list of ints, Gauss points per direction
    nders : 0, 1 or 2 (derivative order to tabulate)
    rule : optional explicit (points, weights) on (-1,1) replacing the Gauss
           rule in every direction (e.g. closed uniform points for
           visualization sampling)
    """
    dim = len(kvs)
    if np.isscalar(npts_per_dir):
        npts_per_dir = [int(npts_per_dir)] * dim
    dir_data = [_dir_tabulation(kvs[d], npts_per_dir[d], nders, rule=rule)
                for d in range(dim)]
    return _combine_tensor(dir_data, [kv.ncp for kv in kvs], nders)
