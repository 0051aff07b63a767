"""Geometric h-multigrid with exact knot-insertion transfers (port of
tigar_tpu/solvers/multigrid.py).

Nested spline spaces under knot insertion give an exact prolongation
V_coarse -> V_fine (Boehm's algorithm, ops/refine.py; collocation for
periodic vectors), applied per direction: by the stencil multigrid of
solvers/newton_stencil.py, and here by ``Multigrid``, a V-cycle with
weighted-Jacobi or Chebyshev smoothing over given level operators and a
dense coarse inverse.  ``identity_poisson_multigrid`` builds it over the
sum-factorized identity-geometry operators (ops/sumfac.py, kernel K4 on
the card): the solver of the matrix-free 3D Poisson path.

The transfers are separable tensordots and the coarse solve one matrix
product, left to torch as the JAX package leaves them to XLA.  The
form-based constructor (``Multigrid(splines, form)``) and multipatch
transfers wait for the generic form path and the multipatch spaces.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.basis import bspline_basis_ders
from ..ops.knots import KnotVector
from ..ops.quadrature import gauss_rule, npoints_for_degree
from ..ops.refine import insert_knot
from ..ops.sumfac import make_sumfac_identity_operator
from ..config import KNOT_NEAR_EPS, DEFAULT_REAL_TYPE, resolve_device

# V(2,2) weighted-Jacobi smoothing, as the JAX package's default; the
# Chebyshev smoother's power iterations and range [0.25, 1.1] x lmax
N_SMOOTH, OMEGA = 2, 0.7
CHEB_POWER_ITERS, CHEB_LOWER, CHEB_UPPER = 12, 0.25, 1.1


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


def _dense_basis_1d(kv, pts):
    """[npts, ncp] dense evaluation of all basis functions of one knot
    vector at host points (wrapping modulo ncp for periodic vectors)."""
    pts = np.asarray(pts, dtype=np.float64)
    spans = kv.knot_span(pts)
    ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p, pts, spans,
                              0)
    nodes = np.mod(spans[:, None] - kv.p + np.arange(kv.p + 1)[None, :],
                   kv.ncp)
    B = np.zeros((len(pts), kv.ncp))
    np.add.at(B, (np.arange(len(pts))[:, None], nodes), ders[:, 0, :])
    return B


def _periodic_insertion_matrix(kv_coarse, kv_fine):
    """[ncp_f, ncp_c] periodic refinement matrix by collocation: sample
    both bases at the fine Gauss grid and solve B_f P = B_c (exact for
    nested periodic knots).  Raises if the coarse space is not contained
    in the fine one."""
    g, _ = gauss_rule(kv_fine.p + 1)
    lefts = kv_fine.unique_knots[:-1]
    h = kv_fine.element_sizes()
    pts = (lefts[:, None] + (g[None, :] + 1.0) * 0.5 * h[:, None]).ravel()
    Bf = _dense_basis_1d(kv_fine, pts)
    Bc = _dense_basis_1d(kv_coarse, pts)
    P, *_ = np.linalg.lstsq(Bf, Bc, rcond=None)
    if np.max(np.abs(Bf @ P - Bc)) > 1e-9:
        raise ValueError("coarse periodic knot vector is not nested in "
                         "the fine one")
    P[np.abs(P) < 1e-12] = 0.0
    return P


def insertion_matrix_1d(kv_coarse: KnotVector, kv_fine: KnotVector):
    """[ncp_f, ncp_c] refinement matrix: fine coefficients representing the
    same function as given coarse coefficients (exact for nested knots).
    Built by running Boehm knot insertion (ops/refine.py) on identity
    coefficient columns; periodic pairs go through exact collocation
    (Boehm insertion needs the open end-clamps)."""
    if kv_coarse.p != kv_fine.p:
        raise ValueError("multigrid levels must share the spline degree")
    if kv_coarse.is_periodic != kv_fine.is_periodic:
        raise ValueError("cannot mix periodic and open multigrid levels")
    if kv_coarse.is_periodic:
        return _periodic_insertion_matrix(kv_coarse, kv_fine)
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


def _tensor_apply(mats, vec, shape_in, shape_out):
    """Apply per-direction matrices to a flattened tensor-product
    coefficient vector (direction 0 fastest -> axis dim-1-d holds
    direction d after a C-order reshape)."""
    dim = len(mats)
    grid = vec.reshape(tuple(reversed(shape_in)))
    for d, P in enumerate(mats):
        axis = dim - 1 - d
        grid = torch.movedim(torch.tensordot(P, grid, dims=([1], [axis])),
                             0, axis)
    return grid.reshape(int(np.prod(shape_out)))


class _FieldTransfer:
    """Separable prolongation/restriction for one tensor-product field."""

    def __init__(self, basis_coarse, basis_fine, dtype, device):
        self.mats = [torch.as_tensor(insertion_matrix_1d(kc, kf),
                                     dtype=dtype, device=device)
                     for kc, kf in zip(basis_coarse.kvs, basis_fine.kvs)]
        self.shape_c = tuple(kv.ncp for kv in basis_coarse.kvs)
        self.shape_f = tuple(kv.ncp for kv in basis_fine.kvs)

    def prolong(self, xc):
        return _tensor_apply(self.mats, xc, self.shape_c, self.shape_f)

    def restrict(self, xf):
        return _tensor_apply([P.T for P in self.mats], xf, self.shape_f,
                             self.shape_c)


def make_field_transfer(basis_coarse, basis_fine, dtype, device):
    """Transfer between two nested tensor-product field bases (multipatch
    fields wait for the multipatch spaces)."""
    if not (hasattr(basis_coarse, "kvs") and hasattr(basis_fine, "kvs")):
        raise NotImplementedError(
            "multigrid transfers require tensor-product fields")
    return _FieldTransfer(basis_coarse, basis_fine, dtype, device)


class Multigrid:
    """V-cycle preconditioner over nested scalar levels [fine, ..., coarse].

    Use as the ``M`` argument of solvers.linear.cg_fixed_iters.  Each
    non-coarse level runs N_SMOOTH weighted-Jacobi sweeps (OMEGA) before
    and after the coarse correction, or one Chebyshev polynomial of degree
    N_SMOOTH + 1 after ``enable_chebyshev``; the coarsest level applies a
    dense inverse computed at setup.  The V-cycle is a fixed SPD linear
    operator (zero initial guess, symmetric pre/post smoothing).  Build it
    with ``from_level_data``.
    """

    def __init__(self, actions, dinvs, masks, transfers, coarse_inv):
        self._actions = list(actions)
        self.levels = [{"dinv": di, "mask": mk}
                       for di, mk in zip(dinvs, masks)]
        self.transfers = transfers
        self._coarse_inv = coarse_inv
        self._cheb_bounds = None

    @classmethod
    def from_level_data(cls, level_bases, actions, diags, masks,
                        coarse_dense, dtype=None, device="cuda"):
        """Operator-level constructor.

        level_bases  : per level, the scalar TensorBSplineBasis; nested
                       fine->coarse
        actions      : per level, W -> A_l @ W (already BC'd, unit diagonal
                       at constrained DoFs), e.g. sum-factorized identity
                       operators (ops/sumfac.make_sumfac_identity_operator)
        diags        : per level, the operator diagonal (BC'd)
        masks        : per level, the BC mask vector
        coarse_dense : dense BC'd matrix of the coarsest level

        ``dtype`` (default: that of ``diags[0]``) is the V-cycle's
        precision; the coarse inverse is taken in float64 on ``device`` and
        then cast.
        """
        device = resolve_device(device)
        if any(a is None for a in actions):
            raise ValueError("from_level_data requires an action per level")
        if dtype is None:
            dtype = torch.as_tensor(diags[0]).dtype

        def t(x):
            return torch.as_tensor(x, device=device).to(dtype)

        dinvs, mks = [], []
        for dg, mk in zip(diags, masks):
            dg = t(dg)
            dinvs.append(torch.where(dg != 0.0, 1.0 / dg,
                                     torch.ones_like(dg)))
            mks.append(t(mk))
        transfers = [make_field_transfer(bc, bf, dtype, device)
                     for bf, bc in zip(level_bases[:-1], level_bases[1:])]
        A_c = torch.as_tensor(coarse_dense, dtype=torch.float64,
                              device=device)
        coarse_inv = torch.linalg.inv(A_c).to(dtype)
        return cls(actions, dinvs, mks, transfers, coarse_inv)

    # -- smoothers ------------------------------------------------------------

    def enable_chebyshev(self):
        """Switch smoothing from weighted Jacobi to Chebyshev polynomial
        smoothing on D^-1 A.  Each level's largest D^-1 A eigenvalue is
        estimated now by power iteration from a numpy-seeded start vector;
        the smoothing range is [CHEB_LOWER, CHEB_UPPER] x lmax."""
        bounds = []
        for level in range(len(self.levels) - 1):
            dinv = self.levels[level]["dinv"]
            rng = np.random.default_rng(level)
            v = torch.as_tensor(rng.normal(size=dinv.shape[0]),
                                device=dinv.device).to(dinv.dtype)
            lmax = 1.0
            for _ in range(CHEB_POWER_ITERS):
                w = dinv * self._actions[level](v)
                lmax = float(torch.linalg.norm(w))
                v = w / lmax
            bounds.append((CHEB_LOWER * lmax, CHEB_UPPER * lmax))
        self._cheb_bounds = bounds
        return self

    def _smooth(self, level, b, x=None):
        """Apply the smoother from initial guess ``x`` (None = zero);
        linear in (b, x), identical pre/post -> the V-cycle stays SPD."""
        dinv = self.levels[level]["dinv"]
        action = self._actions[level]
        if self._cheb_bounds is not None:
            lmin, lmax = self._cheb_bounds[level]
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho = 1.0 / sigma
            if x is None:
                r = b
                x = torch.zeros_like(b)
            else:
                r = b - action(x)
            d = (dinv * r) / theta
            for _ in range(N_SMOOTH + 1):
                x = x + d
                r = r - action(d)
                rho_new = 1.0 / (2.0 * sigma - rho)
                d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * r)
                rho = rho_new
            return x
        om_dinv = OMEGA * dinv
        if x is None:
            x = om_dinv * b
            sweeps = N_SMOOTH - 1
        else:
            sweeps = N_SMOOTH
        for _ in range(sweeps):
            x = x + om_dinv * (b - action(x))
        return x

    def _vcycle(self, level, b):
        if level == len(self.levels) - 1:
            return self._coarse_inv @ b
        lev = self.levels[level]
        x = self._smooth(level, b)
        r = b - self._actions[level](x)
        rc = self.levels[level + 1]["mask"] * \
            self.transfers[level].restrict(r)
        ec = self._vcycle(level + 1, rc)
        x = x + lev["mask"] * self.transfers[level].prolong(ec)
        return self._smooth(level, b, x)

    def __call__(self, r):
        """One V-cycle from a zero initial guess."""
        return self._vcycle(0, r)


# -- identity-geometry (explicit B-spline) level data ------------------------
#
# On identity geometry the ck*K + cm*M operator is separable:
#   K = sum_d M_{D-1} x ... x K_d x ... x M_0,   M = M_{D-1} x ... x M_0
# so the Jacobi diagonal and the small coarse dense matrix come from 1D
# stiffness/mass matrices without any 3D assembly (host numpy).


def matrices_1d(kv, npts):
    """Host-side 1D stiffness and mass matrices of one knot vector
    (consistent with the sum-factorized quadrature)."""
    g, w = gauss_rule(npts)
    spans = kv.element_spans()
    lefts = kv.unique_knots[:-1]
    h = kv.element_sizes()
    qp = (lefts[:, None] + (g[None, :] + 1.0) * 0.5 * h[:, None]).reshape(-1)
    qw = (0.5 * h[:, None] * w[None, :]).reshape(-1)
    ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p, qp,
                              np.repeat(spans, npts), 1)
    nodes = (np.repeat(spans, npts)[:, None] - kv.p
             + np.arange(kv.p + 1)[None, :])
    nodes = np.mod(nodes, kv.ncp)
    K = np.zeros((kv.ncp, kv.ncp))
    M = np.zeros((kv.ncp, kv.ncp))
    N, dN = ders[:, 0, :], ders[:, 1, :]
    for q in range(len(qp)):
        idx = nodes[q]
        K[np.ix_(idx, idx)] += qw[q] * np.outer(dN[q], dN[q])
        M[np.ix_(idx, idx)] += qw[q] * np.outer(N[q], N[q])
    return K, M


def identity_level_data(basis, quad_degree, mask, ck=1.0, cm=0.0,
                        dense=False):
    """(diag, dense_or_None) of the BC'd ck*K + cm*M operator on identity
    geometry for a scalar tensor-product basis (numpy): the Jacobi diagonal
    and, for the coarsest level, the dense matrix with zeroRowsColumns BC
    semantics (unit diagonal at constrained DoFs)."""
    npts = npoints_for_degree(quad_degree)
    mats = [matrices_1d(kv, npts) for kv in basis.kvs]
    dim = basis.dim
    mask = np.asarray(mask)

    # separable diagonal: diag(A x B) = diag(A) x diag(B); dir-0-fastest
    # flattening = C-order ravel of the (n_{D-1}, ..., n_0) grid
    def kron_diag(vecs):
        out = vecs[dim - 1]
        for d in range(dim - 2, -1, -1):
            out = np.multiply.outer(out, vecs[d])
        return out.reshape(-1)

    dK = [np.diag(K) for K, _ in mats]
    dM = [np.diag(M) for _, M in mats]
    diag = cm * kron_diag(dM) if cm else np.zeros(basis.ncp)
    for d in range(dim):
        vecs = [dK[i] if i == d else dM[i] for i in range(dim)]
        diag = diag + ck * kron_diag(vecs)
    diag = mask * diag + (1.0 - mask)

    A = None
    if dense:
        def kron_all(ms):
            out = ms[dim - 1]
            for d in range(dim - 2, -1, -1):
                out = np.kron(out, ms[d])
            return out

        A = cm * kron_all([M for _, M in mats]) if cm else \
            np.zeros((basis.ncp, basis.ncp))
        for d in range(dim):
            ms = [mats[i][0] if i == d else mats[i][1] for i in range(dim)]
            A = A + ck * kron_all(ms)
        A = mask[:, None] * A * mask[None, :] + np.diag(1.0 - mask)
    return diag, A


def identity_poisson_multigrid(bases, quad_degree, masks, ck=1.0, cm=0.0,
                               dtype=DEFAULT_REAL_TYPE, device="cuda"):
    """Multigrid preconditioner for the sum-factorized ck*K + cm*M
    operator on identity geometry: levels are scalar tensor-product bases
    with nested knots [fine, ..., coarse], each with its own BC mask.
    Level actions are make_sumfac_identity_operator (kernel K4 on the
    card); diagonals and the coarse dense matrix come from 1D matrices."""
    actions, diags = [], []
    for i, (b, m) in enumerate(zip(bases, masks)):
        actions.append(make_sumfac_identity_operator(
            b, quad_degree, mask=np.asarray(m), ck=ck, cm=cm, dtype=dtype,
            device=device))
        dg, A = identity_level_data(b, quad_degree, np.asarray(m), ck=ck,
                                    cm=cm, dense=(i == len(bases) - 1))
        diags.append(dg)
    return Multigrid.from_level_data(bases, actions, diags, masks, A,
                                     dtype=dtype, device=device)
