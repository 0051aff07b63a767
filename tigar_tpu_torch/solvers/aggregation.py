"""Smoothed-aggregation (SA) preconditioning (port of
tigar_tpu/solvers/aggregation.py: ``grid_aggregates``,
``control_point_aggregates``, ``TwoLevelSA``, ``_lam_max_dinv_a``,
``_tentative_qr``, ``_csr_to_ell``, ``_mlsa_apply`` and ``MultilevelSA``).

``TwoLevelSA`` is the classic two-level cycle over control-point
aggregates: weighted-Jacobi sweeps of the BC'd operator, a dense smoothed
prolongation P [ndof, m] and a dense coarse inverse, all built on the host
exactly as the JAX package builds them.  On the card its sweeps run
through kernel K11 on an ELL copy of the operator (an ``EllOperator`` in
its Jacobi, first-sweep and residual modes); the dense products stay
``torch.matmul``.  On the CPU it runs the JAX package's coo scatter SpMV
(``twolevel_apply_ref``, the plain version).

The hierarchy is built on the host (numpy/scipy), as the JAX package does:
geometric grid aggregation of the DoF positions (field-pure), near-kernel
tentative prolongations by per-aggregate QR, one weighted-Jacobi smoothing
pass of the prolongation normalised by lam_max(D^-1 A), Galerkin coarse
operators, recursively, down to a dense coarsest inverse.  Each level's
operator, prolongation and its transpose go to the device in padded-row
(ELL) form, and where they reach the card each gets kernel K11's sliced
layout beside them (ops/sparse.EllOperator); the V/W-cycle applies them
through K11 with the weighted-Jacobi sweeps, the first sweep's
x0 = om_dinv b and the coarse correction's addition fused into it.  The
fine level may instead apply a BC'd fine operator (an f32
newton_sa.ElemTangent: kernel K10).  The coarsest dense product stays
``torch.matmul``, as the JAX package leaves it to XLA.  The cycle runs in
float32 and casts at its borders.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.sparse import EllOperator

F32 = torch.float32


def grid_aggregates(points, h):
    """Bucket points [n, d] into axis-aligned grid cells of size ``h``;
    returns integer labels [n] in [0, n_aggregates)."""
    pts = np.asarray(points, dtype=np.float64)
    cells = np.floor((pts - pts.min(axis=0, keepdims=True)) / float(h))
    cells = cells.astype(np.int64)
    _, labels = np.unique(cells, axis=0, return_inverse=True)
    return labels.reshape(-1)


def control_point_aggregates(spline, coarsen=3.0):
    """Aggregate a spline space's scalar control points by physical
    position: cell size = ``coarsen`` x the mean control-point spacing
    (d-th root of bounding-box volume per point).  Needs an equal-order
    space."""
    for f in spline.space.fields:
        if f is not spline.space.fields[0]:
            raise ValueError("control_point_aggregates requires an "
                             "equal-order space")
    bnet = np.asarray(spline.bnet, dtype=np.float64)
    pts = bnet[:, :-1] / bnet[:, -1:]
    ext = pts.max(axis=0) - pts.min(axis=0)
    ext = ext[ext > 0]
    h = float(coarsen) * float(np.prod(ext) / pts.shape[0]) ** (1.0 /
                                                                len(ext))
    return grid_aggregates(pts, h)


def _coo_amv(rows, cols, vals, x):
    """The coo SpMV of tigar_tpu's TwoLevelSA (scatter-add of
    vals * x[cols] into rows)."""
    return torch.zeros_like(x).index_add_(0, rows, vals * x[cols])


def twolevel_apply_ref(rows, cols, vals, om_dinv, P, Ac_inv, r, n_smooth):
    """Plain version of the two-level cycle (tigar_tpu's
    ``TwoLevelSA.apply32``) on float32 tensors: coo operator (rows, cols
    int64), sweeps x + om_dinv (r - A x), the first from x = 0."""
    x = om_dinv * r
    for _ in range(n_smooth - 1):
        x = x + om_dinv * (r - _coo_amv(rows, cols, vals, x))
    d = r - _coo_amv(rows, cols, vals, x)
    x = x + P @ (Ac_inv @ (d @ P))
    for _ in range(n_smooth):
        x = x + om_dinv * (r - _coo_amv(rows, cols, vals, x))
    return x


def twolevel_apply_ell(A, om_dinv, P, Ac_inv, r, n_smooth):
    """The two-level cycle with the operator in ELL form (``A``, an
    ``EllOperator``: kernel K11 on the card): the first sweep from x = 0
    with x0 = om_dinv r formed inside it ("jacobi0"), the fused Jacobi
    sweeps and the residual."""
    x, done = _first_sweep(A, om_dinv, r, n_smooth)
    for _ in range(n_smooth - done):
        x = A(x, r, om_dinv, "jacobi")
    d = A(x, r, mode="residual")
    x = x + P @ (Ac_inv @ (d @ P))
    for _ in range(n_smooth):
        x = A(x, r, om_dinv, "jacobi")
    return x


def _first_sweep(A, om_dinv, b, n_smooth):
    """(x, sweeps done): the pre-smoothing's start from x = 0, x0 =
    om_dinv b, and with two or more sweeps its first sweep, fused into one
    K11 launch ("jacobi0")."""
    if n_smooth >= 2:
        return A(None, b, om_dinv, "jacobi0"), 2
    return om_dinv * b, 1


class TwoLevelSA:
    """Symmetric two-level smoothed-aggregation preconditioner (see module
    docstring).  Build with ``from_coo`` / ``from_spline``; callable as
    M(r) inside any Krylov loop (float32 inside, casts at the borders).
    The coo operator (``_rows``, ``_cols``, ``_vals``) serves the plain
    cycle, its ELL copy (``_ell_cols``, ``_ell_vals``, and ``_ell_op``
    with K11's layout) the card's."""

    def __init__(self, rows, cols, vals, dinv, P, Ac_inv, omega, n_smooth,
                 ndof):
        import scipy.sparse as sp
        self._rows = rows
        self._cols = cols
        self._vals = vals
        self._dinv = dinv
        self._P = P
        self._Ac_inv = Ac_inv
        self._omega = float(omega)
        self._n_smooth = int(n_smooth)
        self._ndof = int(ndof)
        self._om_dinv = (self._omega * dinv).to(F32)
        self._rows_l = rows.long()
        self._cols_l = cols.long()
        # the ELL copy of the deduplicated coo operator (host conversion)
        A = sp.csr_matrix((vals.double().cpu().numpy(),
                           (rows.cpu().numpy(), cols.cpu().numpy())),
                          shape=(self._ndof, self._ndof))
        e_cols, e_vals = _csr_to_ell(A)
        self._ell_cols = torch.as_tensor(e_cols, device=vals.device)
        self._ell_vals = torch.as_tensor(e_vals, dtype=F32,
                                         device=vals.device)
        self._ell_op = EllOperator(self._ell_cols, self._ell_vals,
                                   self._ndof, key="twolevel A")

    @property
    def n_coarse(self):
        return self._Ac_inv.shape[0]

    def apply32(self, r):
        """The cycle on a float32 residual: K11 on the card, the coo plain
        version on the CPU."""
        if r.is_cuda:
            return twolevel_apply_ell(self._ell_op, self._om_dinv, self._P,
                                      self._Ac_inv, r, self._n_smooth)
        return self.apply32_ref(r)

    def apply32_ref(self, r):
        return twolevel_apply_ref(self._rows_l, self._cols_l, self._vals,
                                  self._om_dinv, self._P, self._Ac_inv, r,
                                  self._n_smooth)

    def __call__(self, r):
        return self.apply32(r.to(F32)).to(r.dtype)

    @classmethod
    def from_coo(cls, rows, cols, vals, ndof, labels_dof, mask,
                 omega_P=0.66, jacobi_omega=0.7, n_smooth=2,
                 device="cuda"):
        """Build from host coo arrays of the BC'd operator (the JAX
        package's host numpy, copied): labels_dof [ndof] aggregate id per
        DoF (-1 = constrained), mask [ndof] 1 free / 0 constrained,
        omega_P the prolongation-smoothing weight (0 = plain aggregation);
        the weights are fractions of 2 / lam_max(D^-1 A).  The arrays go
        to ``device``."""
        device = resolve_device(device)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        # padded connectivities carry out-of-range sentinel entries
        ok = ((rows >= 0) & (rows < ndof) & (cols >= 0) & (cols < ndof))
        rows, cols, vals = rows[ok], cols[ok], vals[ok]
        labels = np.asarray(labels_dof)
        m_h = np.asarray(mask, dtype=np.float64)

        D = np.zeros(ndof)
        on_diag = rows == cols
        np.add.at(D, rows[on_diag], vals[on_diag])
        D = np.where(D != 0.0, D, 1.0)

        # spectral radius of D^-1 A by power iteration from a seeded start
        rng = np.random.default_rng(0)
        x = rng.normal(size=ndof)
        lam_max = 1.0
        for _ in range(50):
            y = np.zeros(ndof)
            np.add.at(y, rows, vals * x[cols])
            y /= D
            lam_max = float(np.linalg.norm(y))
            if lam_max == 0.0:
                lam_max = 1.0
                break
            x = y / lam_max
        om_eff = float(jacobi_omega) * 2.0 / lam_max
        omP_eff = float(omega_P) * 2.0 / lam_max

        used = np.unique(labels[labels >= 0])
        m = used.size
        if m == 0:
            raise ValueError("no free DoFs to aggregate")
        remap = -np.ones(int(labels.max()) + 1, dtype=np.int64)
        remap[used] = np.arange(m)
        lbl = np.where(labels >= 0, remap[np.maximum(labels, 0)], -1)

        # tentative + smoothed prolongation, dense [ndof, m]
        if ndof * m > 2.0e8:
            raise ValueError(
                f"SA coarse space too large to densify ({ndof} x {m}); "
                "raise `coarsen`")
        P = np.zeros((ndof, m))
        free = lbl >= 0
        P[np.nonzero(free)[0], lbl[free]] = 1.0
        if omega_P:
            keep = (lbl[cols] >= 0) & (m_h[rows] > 0)
            r_k, c_k, v_k = rows[keep], cols[keep], vals[keep]
            np.subtract.at(P, (r_k, lbl[c_k]), omP_eff * v_k / D[r_k])

        # Galerkin coarse operator A_c = P^T A P (chunked over nnz)
        AP = np.zeros((ndof, m))
        step = max(1, int(2e7 // max(m, 1)))
        for s in range(0, rows.size, step):
            sl = slice(s, s + step)
            np.add.at(AP, rows[sl], vals[sl, None] * P[cols[sl]])
        Ac = P.T @ AP
        dAc = np.diagonal(Ac).copy()
        bad = dAc <= 0.0
        if np.any(bad):
            Ac[bad, :] = 0.0
            Ac[:, bad] = 0.0
            Ac[bad, bad] = 1.0
        Ac_inv = np.linalg.inv(Ac)

        # omega dinv: the damped-Jacobi weight at free DoFs, exactly 1 at
        # constrained (unit-diagonal) ones
        dinv = m_h / D + (1.0 - m_h) / om_eff

        def dev(a, dtype=F32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return cls(dev(rows, torch.int64), dev(cols, torch.int64),
                   dev(vals), dev(dinv), dev(P), dev(Ac_inv), omega=om_eff,
                   n_smooth=n_smooth, ndof=ndof)

    @classmethod
    def from_spline(cls, spline, form, U=None, params=None, coarsen=3.0,
                    omega_P=0.66, jacobi_omega=0.7, n_smooth=2,
                    labels=None, apply_bcs=True):
        """Assemble the BC'd sparse tangent of ``form`` at ``U`` and build
        the two-level SA preconditioner over control-point aggregates on
        the spline's device.  Returns (preconditioner, coalesced sparse
        COO matrix)."""
        M_sp = spline.assemble_sparse(form, U=U, params=params,
                                      apply_bcs=apply_bcs)
        idx = M_sp.indices().cpu().numpy()
        vals = M_sp.values().double().cpu().numpy()
        if labels is None:
            labels = control_point_aggregates(spline, coarsen=coarsen)
        ncp = spline.space.fields[0].ncp
        nf = spline.space.nfields
        nagg = int(labels.max()) + 1
        lbl_dof = np.concatenate([labels + f * nagg for f in range(nf)])
        if lbl_dof.shape[0] != spline.ndof or spline.ndof != nf * ncp:
            raise ValueError("TwoLevelSA.from_spline needs an equal-order "
                             "space")
        m_h = (spline.mask.double().cpu().numpy() if apply_bcs
               else np.ones(spline.ndof))
        lbl_dof = np.where(m_h > 0, lbl_dof, -1)
        pre = cls.from_coo(idx[0], idx[1], vals, spline.ndof, lbl_dof, m_h,
                           omega_P=omega_P, jacobi_omega=jacobi_omega,
                           n_smooth=n_smooth, device=spline.device)
        return pre, M_sp


def _lam_max_dinv_a(A_csr, D, n_iter=50, seed=0):
    """Spectral radius of D^-1 A by host power iteration from a seeded
    normal start (the smoother and the prolongation smoothing weights are
    fractions of 2 / lam_max)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=A_csr.shape[0])
    lam = 1.0
    for _ in range(n_iter):
        y = (A_csr @ x) / D
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            return 1.0
        x = y / lam
    return lam


def _tentative_qr(lbl, B, n):
    """Near-kernel tentative prolongation: per aggregate, QR of the
    near-kernel block B [n, k] restricted to the aggregate's free rows; Q
    gives the aggregate's columns of T, R its rows of the coarse
    near-kernel.  Rank-deficient blocks drop their dependent columns.
    Returns (T csr [n, nc], Bc [nc, k], agg_of_col [nc])."""
    import scipy.sparse as sp

    fr = np.nonzero(lbl >= 0)[0]
    order = np.argsort(lbl[fr], kind="stable")
    fr = fr[order]
    lbls = lbl[fr]
    m = int(lbls.max()) + 1
    starts = np.searchsorted(lbls, np.arange(m + 1))
    T_rows, T_cols, T_vals = [], [], []
    Bc_rows, agg_of_col = [], []
    nc = 0
    for a in range(m):
        rows_a = fr[starts[a]:starts[a + 1]]
        if rows_a.size == 0:
            continue
        Q, R = np.linalg.qr(B[rows_a])
        diag = np.abs(np.diag(R))
        keep = diag > 1e-10 * max(float(diag.max()), 1e-300)
        kk = int(keep.sum())
        if kk == 0:
            keep[0] = True
            kk = 1
        T_rows.append(rows_a.repeat(kk))
        T_cols.append(np.tile(nc + np.arange(kk), rows_a.size))
        T_vals.append(Q[:, keep].reshape(-1))
        Bc_rows.append(R[keep, :])
        agg_of_col.extend([a] * kk)
        nc += kk
    T = sp.csr_matrix((np.concatenate(T_vals),
                       (np.concatenate(T_rows), np.concatenate(T_cols))),
                      shape=(n, nc))
    return T, np.vstack(Bc_rows), np.asarray(agg_of_col)


def _csr_to_ell(Acsr):
    """Padded-row (ELL) arrays of a scipy CSR matrix: cols [n, K] int32,
    vals [n, K]; padding slots index column 0 with value 0."""
    Acsr = Acsr.tocsr()
    Acsr.sort_indices()
    n = Acsr.shape[0]
    row_nnz = np.diff(Acsr.indptr)
    kmax = max(int(row_nnz.max()), 1)
    cols = np.zeros((n, kmax), dtype=np.int32)
    vals = np.zeros((n, kmax))
    rr = np.repeat(np.arange(n), row_nnz)
    kk = np.arange(Acsr.indptr[-1]) - np.repeat(Acsr.indptr[:-1], row_nnz)
    cols[rr, kk] = Acsr.indices
    vals[rr, kk] = Acsr.data
    return cols, vals


class SALevel(NamedTuple):
    """One level's device state, all padded-row ELL: the operator, the
    damped Jacobi weights omega_eff D^-1, the smoothed prolongation and
    its transpose."""
    A_cols: torch.Tensor
    A_vals: torch.Tensor
    om_dinv: torch.Tensor
    P_cols: torch.Tensor
    P_vals: torch.Tensor
    Pt_cols: torch.Tensor
    Pt_vals: torch.Tensor


def level_ops(levels, n_coarse, fine=False):
    """Per level (A, P, Pt) as ``EllOperator``s (K11's sliced layout, built
    and checked once, where the arrays lie on the card), tallied apart by
    op and level; ``n_coarse`` the size below the last level.  With
    ``fine`` a BC'd fine operator applies level 0, whose A is then None."""
    sizes = [int(lv.om_dinv.shape[0]) for lv in levels] + [int(n_coarse)]
    return tuple(
        (None if fine and l == 0 else
         EllOperator(lv.A_cols, lv.A_vals, sizes[l], key=f"A{l}"),
         EllOperator(lv.P_cols, lv.P_vals, sizes[l + 1], key=f"P{l}"),
         EllOperator(lv.Pt_cols, lv.Pt_vals, sizes[l], key=f"Pt{l}"))
        for l, lv in enumerate(levels))


def _mlsa_apply(levels, cinv, fine, r, ns, gamma, ops):
    """One V (gamma 1) or W (gamma 2) cycle from a zero guess: n_smooth
    weighted-Jacobi sweeps before and after each coarse correction, the
    coarsest level by its dense inverse.  ``fine`` = (op, mask) replaces
    the level-0 ELL operator by the BC'd action of ``op``; ``ops`` are the
    levels' ``level_ops``.  Below a BC'd fine operator the first sweep
    from x = 0 and the coarse correction's addition run inside K11
    ("jacobi0", "add")."""
    nlev = len(levels)

    def sweep(l, x, b):
        lv = levels[l]
        if l == 0 and fine is not None:
            fop, fmask = fine
            return x + lv.om_dinv * (b - fop.apply(x, mask=fmask))
        return ops[l][0](x, b, lv.om_dinv, "jacobi")

    def residual(l, x, b):
        if l == 0 and fine is not None:
            fop, fmask = fine
            return b - fop.apply(x, mask=fmask)
        return ops[l][0](x, b, mode="residual")

    def cycle(l, b):
        if l == nlev:
            return torch.matmul(cinv, b)
        lv = levels[l]
        A, P, Pt = ops[l]
        if l == 0 and fine is not None:
            x, done = lv.om_dinv * b, 1
        else:
            x, done = _first_sweep(A, lv.om_dinv, b, ns)
        for _ in range(ns - done):
            x = sweep(l, x, b)
        # coarse-grid correction, gamma visits below the top (the
        # coarsest dense solve is exact, so one visit suffices there)
        for _ in range(gamma if l + 1 < nlev else 1):
            dc = Pt(residual(l, x, b))
            x = P(cycle(l + 1, dc), x, mode="add")
        for _ in range(ns):
            x = sweep(l, x, b)
        return x

    return cycle(0, r)


class MultilevelSA:
    """Recursive smoothed-aggregation V/W-cycle preconditioner (see module
    docstring).  Build with ``from_coo``; callable as M(r) inside any
    Krylov loop (float32 inside, casts at the borders)."""

    def __init__(self, levels, coarse_inv, ndof, n_smooth, cycle="V",
                 fine_op=None, fine_mask=None):
        self._levels = tuple(SALevel(*lv) for lv in levels)
        self._ops = level_ops(self._levels, coarse_inv.shape[0],
                              fine=fine_op is not None)
        self._coarse_inv = coarse_inv
        self._ndof = int(ndof)
        self._n_smooth = int(n_smooth)
        self._cycle = str(cycle).upper()
        if self._cycle not in ("V", "W"):
            raise ValueError("cycle must be 'V' or 'W'")
        self._fine = None if fine_op is None else (fine_op, fine_mask)

    @property
    def n_levels(self):
        return len(self._levels) + 1

    @property
    def level_sizes(self):
        return tuple(int(lv.om_dinv.shape[0]) for lv in self._levels) + (
            int(self._coarse_inv.shape[0]),)

    def __call__(self, r):
        gamma = 2 if self._cycle == "W" else 1
        out = _mlsa_apply(self._levels, self._coarse_inv, self._fine,
                          r.to(F32), self._n_smooth, gamma, self._ops)
        return out.to(r.dtype)

    @classmethod
    def from_coo(cls, rows, cols, vals, ndof, points_dof, mask,
                 coarsen=3.0, omega_P=0.66, jacobi_omega=0.7, n_smooth=2,
                 coarse_size=800, max_levels=12, labels0=None,
                 field_of=None, near_kernel="linear", cycle="V",
                 fine_op=None, fine_mask=None, device="cuda"):
        """Build from host coo arrays of the BC'd fine operator (see
        tigar_tpu's ``MultilevelSA.from_coo`` for the parameters); the
        levels go to ``device``.  Out-of-range (padded) entries are
        dropped."""
        import scipy.sparse as sp

        device = resolve_device(device)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        ok = ((rows >= 0) & (rows < ndof) & (cols >= 0) & (cols < ndof))
        rows, cols, vals = rows[ok], cols[ok], vals[ok]
        m_h = np.asarray(mask, dtype=np.float64)
        pts = np.asarray(points_dof, dtype=np.float64)
        if pts.shape[0] != ndof:
            raise ValueError("points_dof must have one row per DoF")
        fld = (np.zeros(ndof, dtype=np.int64) if field_of is None
               else np.asarray(field_of, dtype=np.int64))

        # near-kernel block: constants, the active (centred, scaled)
        # coordinates for "linear", their products for "quadratic"
        if near_kernel not in ("constant", "linear", "quadratic"):
            raise ValueError("near_kernel must be 'constant', 'linear' "
                             "or 'quadratic'")
        ext0 = pts.max(axis=0) - pts.min(axis=0)
        active = np.nonzero(ext0 > 1e-12 * max(float(ext0.max()), 1.0)
                            )[0] if near_kernel != "constant" else []
        ctr = 0.5 * (pts.max(axis=0) + pts.min(axis=0))
        scl = np.where(ext0 > 0, ext0, 1.0)
        xs = [(pts[:, d] - ctr[d]) / scl[d] for d in active]
        bcols = [np.ones(ndof)] + xs
        if near_kernel == "quadratic":
            bcols += [xs[i] * xs[j] for i in range(len(xs))
                      for j in range(i, len(xs))]
        B = np.column_stack(bcols)

        def dev(a, dtype=F32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        A = sp.csr_matrix((vals, (rows, cols)), shape=(ndof, ndof))
        A.sum_duplicates()
        levels = []
        level = 0
        free = m_h > 0
        while A.shape[0] > int(coarse_size) and level < int(max_levels):
            n = A.shape[0]
            D = A.diagonal()
            D = np.where(D != 0.0, D, 1.0)
            lam_max = _lam_max_dinv_a(A, D)
            om_eff = float(jacobi_omega) * 2.0 / lam_max
            omP_eff = float(omega_P) * 2.0 / lam_max

            if level == 0 and labels0 is not None:
                lbl = np.asarray(labels0).copy()
            else:
                ext = pts.max(axis=0) - pts.min(axis=0)
                ext_pos = ext[ext > 0]
                if ext_pos.size == 0:
                    break
                h = float(coarsen) * float(
                    np.prod(ext_pos) / max(n // max(len(np.unique(fld)),
                                                    1), 1)
                    ) ** (1.0 / ext_pos.size)
                cell = grid_aggregates(pts, h)
                # field-pure aggregation: key = (cell, field)
                lbl = cell + (int(cell.max()) + 1) * fld
            lbl = np.where(free, lbl, -1)
            used = np.unique(lbl[lbl >= 0])
            m = used.size
            if m == 0 or m >= 0.8 * n:
                break        # aggregation stopped coarsening; go dense
            remap = -np.ones(int(lbl.max()) + 1, dtype=np.int64)
            remap[used] = np.arange(m)
            lbl = np.where(lbl >= 0, remap[np.maximum(lbl, 0)], -1)

            T, Bc, agg_of_col = _tentative_qr(lbl, B, n)
            nc = T.shape[1]
            if nc >= 0.8 * n:
                break        # enrichment stopped coarsening; go dense
            Dinv = sp.diags(1.0 / D)
            P = (T - omP_eff * (Dinv @ (A @ T))).tocsr()
            Ac = (P.T @ A @ P).tocsr()
            Ac.sum_duplicates()

            # aggregate centroids and fields carry the geometry down
            fr = np.nonzero(lbl >= 0)[0]
            m_agg = int(lbl[fr].max()) + 1
            cen = np.zeros((m_agg, pts.shape[1]))
            cnt = np.zeros(m_agg)
            np.add.at(cen, lbl[fr], pts[fr])
            np.add.at(cnt, lbl[fr], 1.0)
            cen /= np.maximum(cnt, 1.0)[:, None]
            f_agg = np.zeros(m_agg, dtype=np.int64)
            f_agg[lbl[fr]] = fld[fr]

            # dinv: the damped-Jacobi weight at free DoFs, exactly 1 at
            # constrained (unit-diagonal) ones
            dinv = m_h / D + (1.0 - m_h) / om_eff if level == 0 \
                else 1.0 / D
            A_cols, A_vals = _csr_to_ell(A)
            P_cols, P_vals = _csr_to_ell(P)
            Pt_cols, Pt_vals = _csr_to_ell(P.T.tocsr())
            levels.append((
                dev(A_cols, torch.int32), dev(A_vals), dev(om_eff * dinv),
                dev(P_cols, torch.int32), dev(P_vals),
                dev(Pt_cols, torch.int32), dev(Pt_vals)))
            A = Ac
            pts = cen[agg_of_col]
            fld = f_agg[agg_of_col]
            B = Bc
            m_h = np.ones(nc)
            free = m_h > 0
            level += 1

        Ad = A.toarray()
        dAd = np.diagonal(Ad).copy()
        bad = dAd == 0.0
        if np.any(bad):
            Ad[bad, bad] = 1.0
        coarse_inv = dev(np.linalg.inv(Ad))
        if not levels:
            raise ValueError(
                f"operator already below coarse_size={coarse_size}; use "
                "a dense solve")
        return cls(levels, coarse_inv, ndof, n_smooth, cycle=cycle,
                   fine_op=fine_op, fine_mask=fine_mask)

    @classmethod
    def from_spline(cls, spline, form, U=None, params=None, coarsen=3.0,
                    omega_P=0.66, jacobi_omega=0.7, n_smooth=2,
                    coarse_size=800, max_levels=12, apply_bcs=True,
                    near_kernel="linear", cycle="V"):
        """Assemble the BC'd sparse tangent of ``form`` at ``U`` and build
        the multilevel SA preconditioner on the spline's device; DoF
        positions come from the dehomogenized control net, replicated per
        field.  Returns (preconditioner, coalesced sparse COO matrix)."""
        for f in spline.space.fields:
            if f is not spline.space.fields[0]:
                raise ValueError("MultilevelSA.from_spline requires an "
                                 "equal-order space")
        M_sp = spline.assemble_sparse(form, U=U, params=params,
                                      apply_bcs=apply_bcs)
        idx = M_sp.indices().cpu().numpy()
        vals = M_sp.values().double().cpu().numpy()
        bnet = np.asarray(spline.bnet, dtype=np.float64)
        pts = bnet[:, :-1] / bnet[:, -1:]
        nf = spline.space.nfields
        pts_dof = np.tile(pts, (nf, 1))
        m_h = (spline.mask.double().cpu().numpy() if apply_bcs
               else np.ones(spline.ndof))
        ncp = spline.space.fields[0].ncp
        field_of = np.repeat(np.arange(nf), ncp)
        pre = cls.from_coo(idx[0], idx[1], vals, spline.ndof, pts_dof, m_h,
                           coarsen=coarsen, omega_P=omega_P,
                           jacobi_omega=jacobi_omega, n_smooth=n_smooth,
                           coarse_size=coarse_size, max_levels=max_levels,
                           field_of=field_of, near_kernel=near_kernel,
                           cycle=cycle, device=spline.device)
        return pre, M_sp
