"""Multilevel smoothed-aggregation (SA) preconditioning (port of
``grid_aggregates``, ``_lam_max_dinv_a``, ``_tentative_qr``,
``_csr_to_ell``, ``_mlsa_apply`` and ``MultilevelSA`` of
tigar_tpu/solvers/aggregation.py).

The hierarchy is built on the host (numpy/scipy), as the JAX package does:
geometric grid aggregation of the DoF positions (field-pure), near-kernel
tentative prolongations by per-aggregate QR, one weighted-Jacobi smoothing
pass of the prolongation normalised by lam_max(D^-1 A), Galerkin coarse
operators, recursively, down to a dense coarsest inverse.  Each level's
operator, prolongation and its transpose go to the device in padded-row
(ELL) form; the V/W-cycle applies them through kernel K11
(ops/sparse.ell_spmv), with the weighted-Jacobi sweeps fused into it.  The
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
from ..ops.sparse import ell_spmv

F32 = torch.float32


def grid_aggregates(points, h):
    """Bucket points [n, d] into axis-aligned grid cells of size ``h``;
    returns integer labels [n] in [0, n_aggregates)."""
    pts = np.asarray(points, dtype=np.float64)
    cells = np.floor((pts - pts.min(axis=0, keepdims=True)) / float(h))
    cells = cells.astype(np.int64)
    _, labels = np.unique(cells, axis=0, return_inverse=True)
    return labels.reshape(-1)


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


def _mlsa_apply(levels, cinv, fine, r, ns, gamma):
    """One V (gamma 1) or W (gamma 2) cycle from a zero guess: n_smooth
    weighted-Jacobi sweeps before and after each coarse correction, the
    coarsest level by its dense inverse.  ``fine`` = (op, mask) replaces
    the level-0 ELL operator by the BC'd action of ``op``."""
    nlev = len(levels)

    def sweep(l, x, b):
        lv = levels[l]
        if l == 0 and fine is not None:
            fop, fmask = fine
            return x + lv.om_dinv * (b - fop.apply(x, mask=fmask))
        return ell_spmv(lv.A_cols, lv.A_vals, x, b, lv.om_dinv, "jacobi")

    def residual(l, x, b):
        lv = levels[l]
        if l == 0 and fine is not None:
            fop, fmask = fine
            return b - fop.apply(x, mask=fmask)
        return ell_spmv(lv.A_cols, lv.A_vals, x, b, mode="residual")

    def cycle(l, b):
        if l == nlev:
            return torch.matmul(cinv, b)
        lv = levels[l]
        x = lv.om_dinv * b
        for _ in range(ns - 1):
            x = sweep(l, x, b)
        # coarse-grid correction, gamma visits below the top (the
        # coarsest dense solve is exact, so one visit suffices there)
        for _ in range(gamma if l + 1 < nlev else 1):
            dc = ell_spmv(lv.Pt_cols, lv.Pt_vals, residual(l, x, b))
            x = x + ell_spmv(lv.P_cols, lv.P_vals, cycle(l + 1, dc))
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
                          r.to(F32), self._n_smooth, gamma)
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
