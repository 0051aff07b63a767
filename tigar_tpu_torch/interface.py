"""Interface forms on non-matching multi-patch interfaces (port of
tigar_tpu/interface.py: the merged-breakpoint interface quadrature, the
rational jet rows, the jet and geometry containers, ``InterfaceForm`` with
its residual and dense tangent block, and the consistent coupling
``EnergyNitscheCoupling`` with its flux machinery).

An ``InterfaceForm`` holds a pointwise energy density over the jets of the
coupled fields on both sides of a patch interface and the interface
geometry,

    E(U) = sum_q wq * density(u_a(q), u_b(q), qp(q), params),

tabulated on host numpy at a Gauss rule between the merged breakpoints of
both sides, then kept as tensors on the spline's device.  The residual is
dE/dU and ``tangent_block`` the exact Hessian over the interface support,
as dense [m, m] block.

``EnergyNitscheCoupling`` derives a variationally consistent symmetric
Nitsche coupling from a domain energy density W(ctx, u, params): the
flux of each side is the boundary pairing of the first variation of
int W sqrt(det g) dxi, with A = dWhat/du_h and B = dWhat/du_g by
``torch.func.grad`` and the divergence of A by ``torch.func.jvp`` through
the Taylor shift of the order-3 jets (see tigar_tpu/interface.py).

Kernels (B11 of the JAX package's kernel set): on CUDA tensors the residual
and the tangent block run hand kernels for the densities that have one
(K6 and K7 for ``coupling.ShellInterfaceCoupling``, K8 and K9 for
``EnergyNitscheCoupling`` on ``models.shell.svk_shell_energy`` with
w_order=2); a form whose density has no kernel raises
``NotImplementedError`` on the card.  CPU tensors run the plain versions,
``torch.func`` ``grad`` of the energy and ``hessian`` of the per-point
density under ``vmap``, as the JAX package's ``_iform_residual`` and
``_iform_tangent_block`` do.

Not ported yet: the tangent action ``_iform_tangent``.
"""

from __future__ import annotations

from itertools import product as _iproduct
from math import comb
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .config import INDEX_TYPE, TORCH_INDEX_TYPE
from .forms import Jet, QP
from .ops import cuda_ext
from .ops.basis import eval_basis
from .ops.quadrature import gauss_rule, npoints_for_degree
from .ops.smallmat import det_small, inv_small


# -- interface quadrature (merged breakpoints of both sides) -------------------


def merged_breakpoints(kv_a, kv_b=None, flip=False, tol=1e-12):
    """Union of the unique knots of one (or two) normalized knot vectors
    along a shared interface direction; ``flip`` maps side B's coordinate
    u -> 1 - u into side A's parameterization."""
    pts = [np.asarray(kv_a.unique_knots)]
    if kv_b is not None:
        ub = np.asarray(kv_b.unique_knots)
        pts.append(np.sort(1.0 - ub) if flip else ub)
    u = np.sort(np.concatenate(pts))
    keep = np.concatenate([[True], np.diff(u) > tol])
    return u[keep]


def interface_quadrature(patch, direction, side, npts, patch_b=None,
                         free_b=None, flips=None, extra_a=(), extra_b=()):
    """Tensor Gauss rule over the free directions of one patch side, on
    cells between the merged breakpoints of both sides (and of the extra
    bases ``extra_a``/``extra_b``).

    Returns (xi [nq, dim] parametric points with the fixed coordinate set
    to the side value, w_param [nq] parametric weights, t_free [nq, dim-1]
    free-direction coordinates in knot order)."""
    free = [d for d in range(patch.dim) if d != direction]
    gp, gw = gauss_rule(npts)
    pts_d, wts_d = [], []
    for i, d in enumerate(free):
        pts_a = [np.asarray(patch.kvs[d].unique_knots)]
        pts_a += [np.asarray(e.kvs[d].unique_knots) for e in extra_a]
        if patch_b is not None:
            fl = bool(flips[i]) if flips is not None else False
            for pb_ in (patch_b, *extra_b):
                ub = np.asarray(pb_.kvs[free_b[i]].unique_knots)
                pts_a.append(np.sort(1.0 - ub) if fl else ub)
        u = np.sort(np.concatenate(pts_a))
        uniq = u[np.concatenate([[True], np.diff(u) > 1e-12])]
        a, b = uniq[:-1], uniq[1:]
        pts = (a[:, None] + 0.5 * (gp[None, :] + 1.0)
               * (b - a)[:, None]).reshape(-1)
        wts = (0.5 * (b - a)[:, None] * gw[None, :]).reshape(-1)
        pts_d.append(pts)
        wts_d.append(wts)
    grids = np.meshgrid(*pts_d, indexing="ij")
    wgrids = np.meshgrid(*wts_d, indexing="ij")
    t_free = np.stack([g.reshape(-1) for g in grids], axis=-1)
    w_param = np.prod([w.reshape(-1) for w in wgrids], axis=0)
    nq = t_free.shape[0]
    xi = np.zeros((nq, patch.dim))
    xi[:, direction] = float(side)
    for i, d in enumerate(free):
        xi[:, d] = t_free[:, i]
    return xi, w_param, t_free


# -- arbitrary-order rationalized point-evaluation rows ------------------------


def _alphas_upto(dim, order):
    """All multi-indices alpha in N^dim with |alpha| <= order, sorted by
    total order."""
    al = [a for a in _iproduct(range(order + 1), repeat=dim)
          if sum(a) <= order]
    return sorted(al, key=sum)


class RationalJetRows(NamedTuple):
    """Host-side (numpy) point-evaluation data of a rational tensor-product
    patch basis at points xi [nq, dim], to derivative order ``nders``
    (exact quotient rule at every order).

    conn : [nq, nen]  patch-local control-point indices
    R    : list by order k of [nq, nen, dim^k] rationalized derivative rows
    X    : list by order k of [nq, nsd, dim^k] geometry derivative tensors
    W    : list by order k of [nq, dim^k] weight-function derivatives
    """
    conn: Any
    R: Any
    X: Any
    W: Any


def rational_jet_rows(patch, bnet_patch, xi, nders):
    """Build ``RationalJetRows`` for one patch at parametric points xi."""
    dim = patch.dim
    nsd = bnet_patch.shape[1] - 1
    xi = np.asarray(xi, dtype=np.float64)
    nq = xi.shape[0]
    nodes_d, ders_d = [], []
    for d, kv in enumerate(patch.kvs):
        nd, ders = eval_basis(kv, xi[:, d], nders)
        nodes_d.append(nd)
        ders_d.append(ders)                       # [nq, nders+1, p+1]

    conn = nodes_d[0]
    stride = patch.kvs[0].ncp
    for d in range(1, dim):
        conn = (conn[:, :, None] + stride * nodes_d[d][:, None, :]
                ).reshape(nq, -1)
        stride *= patch.kvs[d].ncp

    def tp_vals(alpha):
        vals = ders_d[0][:, alpha[0], :]
        for d in range(1, dim):
            vals = (vals[:, :, None]
                    * ders_d[d][:, alpha[d], :][:, None, :]).reshape(nq, -1)
        return vals

    w_cp = np.asarray(bnet_patch)[:, -1]
    wq = w_cp[conn]                               # [nq, nen]
    P_cp = np.asarray(bnet_patch)[:, :nsd] / w_cp[:, None]
    Pq = P_cp[conn]                               # [nq, nen, nsd]

    alphas = _alphas_upto(dim, nders)
    Nd = {a: tp_vals(a) for a in alphas}
    zero = (0,) * dim
    if np.all(w_cp == 1.0):
        # plain (non-rational) basis: skip the quotient recursion, whose
        # weight-derivative sums would leak roundoff into the rows
        Wd = {a: (np.ones(nq) if sum(a) == 0 else np.zeros(nq))
              for a in alphas}
        Rd = dict(Nd)
    else:
        Wd = {a: np.einsum("qa,qa->q", Nd[a], wq) for a in alphas}
        Rd = {}
        for a in alphas:
            acc = Nd[a] * wq
            for b in _iproduct(*(range(ai + 1) for ai in a)):
                if b == a:
                    continue
                coef = 1.0
                for d in range(dim):
                    coef *= comb(a[d], b[d])
                diff = tuple(a[d] - b[d] for d in range(dim))
                acc = acc - coef * Rd[b] * Wd[diff][:, None]
            Rd[a] = acc / Wd[zero][:, None]

    def pack(table, extra_shape):
        out = []
        for k in range(nders + 1):
            t = np.zeros((nq,) + extra_shape + (dim,) * k)
            for idx in _iproduct(range(dim), repeat=k):
                a = tuple(idx.count(d) for d in range(dim))
                t[(slice(None),) + (slice(None),) * len(extra_shape) + idx] \
                    = table[a]
            out.append(t)
        return out

    R = pack(Rd, (conn.shape[1],))
    W = pack(Wd, ())
    Xd = {a: np.einsum("qa,qac->qc", Rd[a], Pq) for a in alphas}
    X = pack(Xd, (nsd,))
    return RationalJetRows(conn=conn, R=R, X=X, W=W)


def surface_measure_from_DF(DF, free):
    """Physical measure density of the interface from the geometry Jacobian
    DF [nq, nsd, dim] restricted to the free (tangential) directions."""
    T = DF[:, :, free]                            # [nq, nsd, k]
    k = T.shape[2]
    if k == 1:
        return np.linalg.norm(T[:, :, 0], axis=-1)
    if k == 2 and T.shape[1] == 3:
        return np.linalg.norm(np.cross(T[:, :, 0], T[:, :, 1]), axis=-1)
    g = np.einsum("qci,qcj->qij", T, T)
    return np.sqrt(np.maximum(np.linalg.det(g), 0.0))


# -- jet / geometry containers -------------------------------------------------


def _map_leaves(obj, fn):
    """Apply ``fn`` to every tensor leaf of nested NamedTuples/dicts."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_map_leaves(v, fn) for v in obj])
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return obj


class Jet3(NamedTuple):
    """Up-to-third-order jet of the coupled fields on one interface side
    (parametric derivatives; axes after the field axis are parametric
    directions).  ``h``/``t3`` are None when not tabulated."""
    val: Any                   # [nf]
    g: Any                     # [nf, dim]
    h: Optional[Any] = None    # [nf, dim, dim]
    t3: Optional[Any] = None   # [nf, dim, dim, dim]


class SideQP(NamedTuple):
    """Per-quadrature-point geometry of one interface side (leaves carry a
    leading nq axis; densities index trailing axes only)."""
    xi: Any                    # [dim] parametric point
    x: Any                     # [nsd] physical point
    DF: Any                    # [nsd, dim]
    d2F: Optional[Any]         # [nsd, dim, dim] or None
    d3F: Optional[Any]         # [nsd, dim, dim, dim] or None
    w0: Any                    # [] weight value
    w1: Any                    # [dim]
    w2: Optional[Any]          # [dim, dim] or None
    w3: Optional[Any]          # [dim, dim, dim] or None
    pinv: Any                  # [dim, nsd] Moore-Penrose inverse of DF
    nu_flat: Any               # [dim] outward flat conormal (sigma * e_dir)


class InterfaceQP(NamedTuple):
    """Per-quadrature-point interface context handed to densities: both
    sides' SideQP, side A's unit physical conormal ``nu`` [nsd] oriented
    A -> B, and ``surfJ``, the physical measure per parametric measure."""
    a: SideQP
    b: SideQP
    nu: Any
    surfJ: Any


def phys_grad(u: Jet3, side: SideQP):
    """Physical (surface) gradient rows of the side fields: [..., nf, nsd]."""
    return u.g @ side.pinv


def _contract_last(t, delta):
    """t [..., X, d] . delta [..., d] over the last axis, the leading
    (batch) axes of delta broadcast against t's."""
    dl = delta.reshape(delta.shape[:-1] + (1,) * (t.dim() - delta.dim())
                       + delta.shape[-1:])
    return (t * dl).sum(-1)


def _taylor_shift(jets, delta, m):
    """m-th derivative tensor of the Taylor polynomial with raw derivative
    tensors ``jets`` (list by order; trailing axes parametric) at the
    parametric offset ``delta``: sum_k (1/k!) jets[m+k] . delta^k."""
    out = None
    fact = 1.0
    for k in range(len(jets) - m):
        t = jets[m + k]
        if t is None:
            break
        if k:
            # divided before the contraction, while t still has its k
            # parametric axes (see models.shell._svk_contract)
            t = t / fact
        for _ in range(k):
            t = _contract_last(t, delta)
        out = t if out is None else out + t
        fact *= (k + 1)
    return out


def _jets_list(*js):
    out = []
    for j in js:
        if j is None:
            break
        out.append(j)
    return out


def _side_ctx_at(s: SideQP, delta):
    """QP context of one side at parametric offset ``delta`` from the
    tabulated point (exact for the polynomial geometry within the cell);
    aux is None, so a shell energy recomputes its reference geometry."""
    Xj = _jets_list(s.x, s.DF, s.d2F, s.d3F)
    Wj = _jets_list(s.w0, s.w1, s.w2, s.w3)
    x = _taylor_shift(Xj, delta, 0)
    DF = _taylor_shift(Xj, delta, 1)
    d2F = _taylor_shift(Xj, delta, 2) if len(Xj) >= 3 else None
    w0 = _taylor_shift(Wj, delta, 0)
    w1 = _taylor_shift(Wj, delta, 1)
    w2 = _taylor_shift(Wj, delta, 2) if len(Wj) >= 3 else None
    g = DF.transpose(-1, -2) @ DF
    ginv = inv_small(g)
    sqrtJ = torch.sqrt(det_small(g))
    pinv = ginv @ DF.transpose(-1, -2)
    return QP(xi=s.xi + delta, x=x, w=w0, wg=w1, wh=w2, DF=DF, d2F=d2F,
              g=g, ginv=ginv, sqrtJ=sqrtJ, pinv=pinv, aux=None)


def _jet2_at(u: Jet3, delta):
    js = _jets_list(u.val, u.g, u.h, u.t3)
    val = _taylor_shift(js, delta, 0)
    g = _taylor_shift(js, delta, 1)
    h = _taylor_shift(js, delta, 2) if len(js) >= 3 else None
    return Jet(val, g, h)


def _side_flux_pairing(s: SideQP, u3: Jet3, J0, J1, W_density, w_order,
                       params):
    """One side's boundary pairing of the first variation of
    int W sqrt(det g) dxi against the physical jump (J0 value jump [nf],
    J1 physical-gradient jump [nf, nsd]), per unit parametric interface
    measure:

        P = A^{i nu d} (J1_i . DF[:, d]) + (B^{i nu} - d_g A^{i g nu}) J0_i

    with A = dWhat/du_h and B = dWhat/du_g (What = W sqrt(det g)) at the
    Taylor-shifted point and d_g A by forward mode through the shift; the
    orientation sigma is folded into s.nu_flat."""
    nu = s.nu_flat
    dim = nu.shape[-1]
    zero = torch.zeros_like(nu)

    def AB(delta):
        ctx = _side_ctx_at(s, delta)
        u = _jet2_at(u3, delta)

        def What(uh, ug):
            return (W_density(ctx, Jet(u.val, ug, uh), params)
                    * ctx.sqrtJ).sum()

        if w_order >= 2:
            return torch.func.grad(What, argnums=(0, 1))(u.h, u.g)
        return None, torch.func.grad(lambda ug: What(u.h, ug))(u.g)

    A0, B0 = AB(zero)
    T = (B0 * nu[..., None, :]).sum(-1)                  # [..., nf]
    pair = (T * J0).sum(-1)
    if w_order >= 2:
        eye = torch.eye(dim, dtype=nu.dtype, device=nu.device)
        divA = 0.0
        for g in range(dim):
            dA = torch.func.jvp(lambda d: AB(d)[0], (zero,),
                                (zero + eye[g],))[1]     # [..., nf, dim, dim]
            divA = divA + (dA[..., g] * nu[..., None, :]).sum(-1)
        pair = pair - (divA * J0).sum(-1)
        Anu = (A0 * nu[..., None, :, None]).sum(-2)      # [..., nf, dim]
        # J1 . DF[:, d]: parametric derivative of the smooth jump field
        pair = pair + (Anu * (J1 @ s.DF)).sum((-2, -1))
    return pair


class SideData(NamedTuple):
    """One side's tabulated interface data.  ``conn`` carries GLOBAL DoF
    indices (field offset + patch offset folded in); ragged per-field
    supports are padded to a common ``nen`` with zero rows."""
    conn: Any          # [nq, nf, nen] global DoF indices
    R0: Any            # [nq, nf, nen]
    R1: Any            # [nq, nf, nen, dim]
    R2: Optional[Any]  # [nq, nf, nen, dim, dim]
    R3: Optional[Any]  # [nq, nf, nen, dim, dim, dim]
    qp: SideQP         # leaves [nq, ...]


def _einsum_rows(R, uloc, spec):
    return None if R is None else torch.einsum(spec, R, uloc)


class InterfaceForm:
    """Interface form over a non-matching two-patch interface of a
    MultiPatchBSplineBasis space (see the module docstring).

    Parameters
    ----------
    spline    : ExtractedSpline over a MultiPatchBSplineBasis control mesh
    patch_a, side_a : patch index and (direction, side) of side A
    patch_b, side_b : likewise for side B
    density   : density(u_a: Jet3, u_b: Jet3, qp: InterfaceQP, params)
                -> energy per unit physical interface measure, written on
                trailing axes (it runs on the whole [nq] batch and per point)
    params    : parameter dict (default {})
    nders     : tabulated jet order (0..3)
    fields    : field indices to couple (default: all)
    flips     : per-free-direction bools reversing B's direction
    """

    def __init__(self, spline, patch_a, side_a, patch_b, side_b, density,
                 params=None, nders=1, fields=None, quad_degree=None,
                 flips=None, geom_tol=1e-8):
        from .models.multipatch import MultiPatchBSplineBasis

        space = spline.space
        geom_basis = space.control_mesh.scalar_basis()
        if not isinstance(geom_basis, MultiPatchBSplineBasis):
            raise NotImplementedError("interface forms require a "
                                      "MultiPatchBSplineBasis control mesh")
        self.density = density
        self.ndof = int(spline.ndof)
        self.params = {} if params is None else dict(params)
        self.fields = list(range(space.nfields)) if fields is None \
            else list(fields)
        fbases = [space.fields[f] for f in self.fields]
        for fb in fbases:
            if not isinstance(fb, MultiPatchBSplineBasis):
                raise NotImplementedError(
                    "every coupled field must be a MultiPatchBSplineBasis")
            if fb.n_patches != geom_basis.n_patches:
                raise ValueError("coupled field patch count differs from "
                                 "the control mesh")
        dir_a, sd_a = side_a
        dir_b, sd_b = side_b
        pa = geom_basis.patches[patch_a]
        pb = geom_basis.patches[patch_b]
        if flips is None:
            flips = (False,) * (pa.dim - 1)

        npts = npoints_for_degree(quad_degree if quad_degree is not None
                                  else spline.quad_degree)
        free_a = [d for d in range(pa.dim) if d != dir_a]
        free_b = [d for d in range(pb.dim) if d != dir_b]
        xtr_a = [fb.patches[patch_a] for fb in fbases
                 if fb is not geom_basis]
        xtr_b = [fb.patches[patch_b] for fb in fbases
                 if fb is not geom_basis]
        xi_a, w_param, t_free = interface_quadrature(
            pa, dir_a, sd_a, npts, patch_b=pb, free_b=free_b, flips=flips,
            extra_a=xtr_a, extra_b=xtr_b)
        nq = xi_a.shape[0]
        xi_b = np.zeros((nq, pb.dim))
        xi_b[:, dir_b] = float(sd_b)
        for i, d in enumerate(free_b):
            xi_b[:, d] = 1.0 - t_free[:, i] if flips[i] else t_free[:, i]

        bnet = np.asarray(spline.bnet)
        off_a = geom_basis.doffsets[patch_a]
        off_b = geom_basis.doffsets[patch_b]
        dtype, device = spline.dtype, spline.device

        def t(a, dt=dtype):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dt, device=device)

        def build_side(patch, bnet_patch, xi, direction, sd, patch_idx):
            rows = rational_jet_rows(patch, bnet_patch, xi, max(nders, 1))
            DF = rows.X[1]
            g = np.einsum("qci,qcj->qij", DF, DF)
            pinv = np.einsum("qij,qcj->qic", np.linalg.inv(g), DF)
            nu_flat = np.zeros((nq, patch.dim))
            nu_flat[:, direction] = 1.0 if sd == 1 else -1.0
            qp = SideQP(
                xi=t(xi), x=t(rows.X[0]), DF=t(DF),
                d2F=t(rows.X[2]) if nders >= 2 else None,
                d3F=t(rows.X[3]) if nders >= 3 else None,
                w0=t(rows.W[0]), w1=t(rows.W[1]),
                w2=t(rows.W[2]) if nders >= 2 else None,
                w3=t(rows.W[3]) if nders >= 3 else None,
                pinv=t(pinv), nu_flat=t(nu_flat))
            nd_eff = max(nders, 1)

            def field_rows(fb):
                if fb is geom_basis:
                    return rows.conn, rows.R[:nd_eff + 1]
                pf = fb.patches[patch_idx]
                rf = rational_jet_rows(pf, np.ones((pf.ncp, 2)), xi, nd_eff)
                return rf.conn, rf.R

            f_conn, f_R = [], []
            for f, fb in zip(self.fields, fbases):
                cn, Rf = field_rows(fb)
                goff = int(space.offsets[f]) + int(fb.doffsets[patch_idx])
                f_conn.append(cn + goff)
                f_R.append(Rf)
            nen = max(c.shape[1] for c in f_conn)

            def padc(c):
                if c.shape[1] == nen:
                    return c
                return np.concatenate(
                    [c, np.repeat(c[:, :1], nen - c.shape[1], axis=1)],
                    axis=1)

            def padr(r):
                if r.shape[1] == nen:
                    return r
                wd = [(0, 0)] * r.ndim
                wd[1] = (0, nen - r.shape[1])
                return np.pad(r, wd)

            conn = np.stack([padc(c) for c in f_conn], axis=1)
            Rk = [np.stack([padr(Rf[k]) for Rf in f_R], axis=1)
                  for k in range(nd_eff + 1)]
            sd_data = SideData(
                conn=t(conn.astype(INDEX_TYPE), TORCH_INDEX_TYPE),
                R0=t(Rk[0]), R1=t(Rk[1]),
                R2=t(Rk[2]) if nders >= 2 else None,
                R3=t(Rk[3]) if nders >= 3 else None,
                qp=qp)
            return sd_data, rows

        self.side_a, rows_a = build_side(
            pa, bnet[off_a:off_a + pa.ncp], xi_a, dir_a, sd_a, patch_a)
        self.side_b, rows_b = build_side(
            pb, bnet[off_b:off_b + pb.ncp], xi_b, dir_b, sd_b, patch_b)

        gap = float(np.max(np.linalg.norm(rows_a.X[0] - rows_b.X[0],
                                          axis=-1)))
        if gap > geom_tol:
            raise ValueError(
                "interface sides do not coincide geometrically (max gap "
                f"{gap:.3e}); check patch/side indices and flips")

        surfJ = surface_measure_from_DF(rows_a.X[1], free_a)
        wq = w_param * surfJ
        DFa = rows_a.X[1]
        pinva = np.einsum("qij,qcj->qic",
                          np.linalg.inv(np.einsum("qci,qcj->qij", DFa, DFa)),
                          DFa)
        nu = pinva[:, dir_a, :] * (1.0 if sd_a == 1 else -1.0)
        nu = nu / np.linalg.norm(nu, axis=-1, keepdims=True)

        self.nu = t(nu)
        self.wq = t(wq)
        self.w_param = t(w_param)
        self.surfJ = t(surfJ)
        self._nders = int(nders)
        self._support = None
        self._pos = None

    # -- casts -----------------------------------------------------------------

    @property
    def dtype(self):
        return self.wq.dtype

    @property
    def device(self):
        return self.wq.device

    def astype(self, dtype):
        """Copy with every floating tensor cast to ``dtype`` (indices,
        params and the support maps shared)."""
        def cast(x):
            return x.to(dtype) if x.is_floating_point() else x
        obj = self.__class__.__new__(self.__class__)
        obj.__dict__.update(self.__dict__)
        for name in ("side_a", "side_b", "nu", "wq", "w_param", "surfJ"):
            setattr(obj, name, _map_leaves(getattr(self, name), cast))
        return obj

    # -- evaluation --------------------------------------------------------------

    @property
    def area(self):
        """Physical measure of the interface (diagnostic)."""
        return float(torch.sum(self.wq))

    def _jets(self, U, sd: SideData) -> Jet3:
        return self._jets_local(U[sd.conn.long()], sd)

    def _jets_local(self, uloc, sd: SideData) -> Jet3:
        """Jets from local coefficients uloc [..., nf, nen] (whole batch,
        or one point under vmap with per-point side data)."""
        val = torch.einsum("...fa,...fa->...f", sd.R0, uloc)
        g = torch.einsum("...fad,...fa->...fd", sd.R1, uloc)
        h = _einsum_rows(sd.R2, uloc, "...fade,...fa->...fde")
        t3 = _einsum_rows(sd.R3, uloc, "...faijk,...fa->...fijk")
        return Jet3(val, g, h, t3)

    def _qp(self) -> InterfaceQP:
        return InterfaceQP(a=self.side_a.qp, b=self.side_b.qp,
                           nu=self.nu, surfJ=self.surfJ)

    def energy(self, U, params=None):
        p = self.params if params is None else params
        ua = self._jets(U, self.side_a)
        ub = self._jets(U, self.side_b)
        return torch.sum(self.wq * self.density(ua, ub, self._qp(), p))

    def jump_norm(self, U):
        """L2 norm of the interface value jump (diagnostic)."""
        ua = self._jets(U, self.side_a)
        ub = self._jets(U, self.side_b)
        j = ua.val - ub.val
        return torch.sqrt(torch.sum(self.wq * torch.sum(j * j, dim=-1)))

    def residual(self, U):
        """dE/dU [ndof]: the form's kernel on CUDA, the plain version on
        the CPU."""
        return _iform_residual(self, U)

    # -- dense interface tangent block ------------------------------------------

    @property
    def support(self):
        """Sorted global DoF indices the form couples (numpy)."""
        if self._support is None:
            self._support = np.unique(np.concatenate(
                [sd.conn.cpu().numpy().ravel()
                 for sd in (self.side_a, self.side_b)]))
        return self._support

    def support_positions(self):
        """(idx, pos_a, pos_b): sorted support indices plus, per side, the
        position of every (quad point, field, local function) column
        within idx [nq, nf, nen]; int32 tensors on the form's device."""
        idx = self.support
        if self._pos is None:
            self._pos = tuple(
                torch.as_tensor(np.searchsorted(
                    idx, sd.conn.cpu().numpy()).astype(INDEX_TYPE),
                    device=self.device)
                for sd in (self.side_a, self.side_b))
        return (torch.as_tensor(idx.astype(INDEX_TYPE), device=self.device),
                *self._pos)

    def tangent_block(self, U, params=None):
        """(idx, K): the exact interface tangent as a dense [m, m] block
        over the support, K[i, j] = d residual[idx[i]] / dU[idx[j]]."""
        idxj, pos_a, pos_b = self.support_positions()
        p = self.params if params is None else params
        K = _iform_tangent_block(self, U[idxj.long()], pos_a, pos_b, p)
        return self.support, K

    # -- kernels (overridden by forms whose density has one) --------------------

    def _no_kernel(self):
        name = getattr(self.density, "__name__", repr(self.density))
        return NotImplementedError(
            f"no CUDA kernel evaluates the interface density {name}; "
            "run this form on CPU tensors")

    def residual_cuda(self, U, params):
        raise self._no_kernel()

    def tangent_block_cuda(self, u_sub, pos_a, pos_b, params):
        raise self._no_kernel()


def _iform_tangent_block(form, u_sub, pos_a, pos_b, params):
    """Dense [m, m] interface tangent block at u_sub = U[idx]: the form's
    kernel on CUDA, else ``iform_tangent_block_ref``."""
    if u_sub.is_cuda:
        return form.tangent_block_cuda(u_sub, pos_a, pos_b, params)
    return iform_tangent_block_ref(form, u_sub, pos_a, pos_b, params)


def iform_tangent_block_ref(form, u_sub, pos_a, pos_b, params):
    """Plain version: per-point jet-Hessian of wq * density over the local
    coefficients of both sides (torch.func hessian under vmap), scattered
    at (cols, cols)."""
    m = u_sub.shape[0]
    na = pos_a.shape[1] * pos_a.shape[2]
    shp_a, shp_b = tuple(pos_a.shape[1:]), tuple(pos_b.shape[1:])
    cols = torch.cat([pos_a.reshape(pos_a.shape[0], -1),
                      pos_b.reshape(pos_b.shape[0], -1)], dim=1).long()
    z0 = u_sub[cols]                                  # [nq, na + nb]

    # vmap takes tensor leaves only: the side data and the context go in
    # as dicts of their present leaves and are rebuilt per point (the
    # integer connectivity stays outside)
    def leaves(nt):
        return {k: (leaves(v) if isinstance(v, tuple) else v)
                for k, v in nt._asdict().items()
                if v is not None and k != "conn"}

    def rebuild(cls, d):
        return cls(**{k: d.get(k) for k in cls._fields})

    def point(z, sa, sb, q, wq):
        sa, sb = rebuild(SideData, sa), rebuild(SideData, sb)
        q = InterfaceQP(a=rebuild(SideQP, q["a"]), b=rebuild(SideQP, q["b"]),
                        nu=q["nu"], surfJ=q["surfJ"])

        def f(zz):
            ua = form._jets_local(zz[:na].reshape(shp_a), sa)
            ub = form._jets_local(zz[na:].reshape(shp_b), sb)
            return wq * form.density(ua, ub, q, params)
        return torch.func.hessian(f)(z)

    E = torch.func.vmap(point)(
        z0, leaves(form.side_a._replace(qp=None)),
        leaves(form.side_b._replace(qp=None)), leaves(form._qp()), form.wq)
    K = torch.zeros((m, m), dtype=u_sub.dtype, device=u_sub.device)
    rows = cols[:, :, None].expand(E.shape)
    cc = cols[:, None, :].expand(E.shape)
    return K.index_put_((rows.reshape(-1), cc.reshape(-1)), E.reshape(-1),
                        accumulate=True)


def _iform_residual(form, U):
    """dE/dU: the form's kernel on CUDA, else ``iform_residual_ref``."""
    if U.is_cuda:
        return form.residual_cuda(U, form.params)
    return iform_residual_ref(form, U)


def iform_residual_ref(form, U):
    """Plain version: torch.func.grad of the form's energy."""
    return torch.func.grad(form.energy)(U)


# -- automatic consistent (Nitsche) coupling from a domain energy density -------


class NitscheDensity:
    """The symmetric-Nitsche interface density of an energy density
    ``energy_density`` (tigar_tpu.interface.EnergyNitscheCoupling's
    closure as an object, so that kernels and ``convert`` can read what it
    couples):

        -(w_a P_a - w_b P_b) / surfJ + 1/2 (beta_d |J0|^2 + beta_r |J1|^2)

    with P_s the side flux pairings (``_side_flux_pairing``)."""

    def __init__(self, energy_density, w_order=2, weights=(0.5, 0.5)):
        self.energy_density = energy_density
        self.w_order = int(w_order)
        self.weights = (float(weights[0]), float(weights[1]))
        name = getattr(energy_density, "__name__", repr(energy_density))
        self.__name__ = f"nitsche({name}, w_order={self.w_order})"

    def __call__(self, ua, ub, qp, p):
        # per-point scalars carry a trailing axis while they meet Python
        # floats (see models.shell._svk_contract)
        wa, wb = self.weights
        J0 = ua.val - ub.val
        J1 = phys_grad(ua, qp.a) - phys_grad(ub, qp.b)
        pair = 0.0
        for w, side, u in ((wa, qp.a, ua), (-wb, qp.b, ub)):
            if w != 0.0:
                pair = pair + w * _side_flux_pairing(
                    side, u, J0, J1, self.energy_density, self.w_order,
                    p["w"])[..., None]
        stab = 0.5 * (p["beta_d"] * (J0 * J0).sum(-1, keepdim=True)
                      + p["beta_r"] * (J1 * J1).sum((-2, -1))[..., None])
        # the flux pairing is per parametric measure; the density contract
        # is per physical measure
        return (-pair / qp.surfJ[..., None] + stab)[..., 0]


class EnergyNitscheCoupling(InterfaceForm):
    """Variationally consistent symmetric-Nitsche coupling of a
    non-matching two-patch interface, derived from the pointwise domain
    energy density ``W(ctx, u, params)`` of the bulk problem (see
    tigar_tpu.interface.EnergyNitscheCoupling).

    Parameters
    ----------
    energy_density : W(ctx: QP, u: Jet, params) -> physical energy
                     density; ``models.shell.svk_shell_energy`` (with
                     w_order=2) has the CUDA kernels K8/K9
    beta_d, beta_r : value- and gradient-jump stabilization
    w_order   : highest derivative order W uses (1 or 2); jets are
                tabulated to w_order + 1
    weights   : (w_a, w_b) flux averaging weights
    params    : W's parameters (a dict of floats)
    """

    def __init__(self, spline, patch_a, side_a, patch_b, side_b,
                 energy_density, beta_d, beta_r=0.0, w_order=2,
                 weights=(0.5, 0.5), params=None, fields=None,
                 quad_degree=None, flips=None, geom_tol=1e-8):
        w_order = int(w_order)
        if w_order not in (1, 2):
            raise ValueError("w_order must be 1 or 2")
        all_params = {"beta_d": float(beta_d), "beta_r": float(beta_r),
                      "w": {} if params is None else dict(params)}
        super().__init__(spline, patch_a, side_a, patch_b, side_b,
                         NitscheDensity(energy_density, w_order, weights),
                         params=all_params, nders=w_order + 1,
                         fields=fields, quad_degree=quad_degree,
                         flips=flips, geom_tol=geom_tol)

    def grad_jump_norm(self, U):
        """L2 norm of the physical-gradient jump (rotation-jump diagnostic
        of bending problems)."""
        ua = self._jets(U, self.side_a)
        ub = self._jets(U, self.side_b)
        qp = self._qp()
        J1 = phys_grad(ua, qp.a) - phys_grad(ub, qp.b)
        return torch.sqrt(torch.sum(self.wq * (J1 * J1).sum((-2, -1))))

    # -- kernels K8 / K9 --------------------------------------------------------

    def _kernel_args(self, x, params):
        """Check what K8/K9 take: the SVK shell energy at w_order=2, 3
        fields of 9 biquadratic functions per side in 3D; returns
        (side_a, side_b, consts)."""
        from .models.shell import svk_shell_energy
        d = self.density
        if not (isinstance(d, NitscheDensity)
                and d.energy_density is svk_shell_energy
                and d.w_order == 2):
            raise self._no_kernel()
        if not (x.is_cuda and self.wq.is_cuda):
            raise ValueError("the Nitsche interface kernels need CUDA "
                             "tensors")
        if x.dtype != self.dtype or x.dtype not in (torch.float32,
                                                    torch.float64):
            raise TypeError(f"state {x.dtype} vs interface form "
                            f"{self.dtype}")
        nq = self.wq.shape[0]

        def side(sd):
            qp = sd.qp
            t = (sd.conn, sd.R0, sd.R1, sd.R2, sd.R3, qp.DF, qp.d2F,
                 qp.d3F, qp.pinv, qp.nu_flat)
            shapes = ((nq, 3, 9), (nq, 3, 9), (nq, 3, 9, 2),
                      (nq, 3, 9, 2, 2), (nq, 3, 9, 2, 2, 2), (nq, 3, 2),
                      (nq, 3, 2, 2), (nq, 3, 2, 2, 2), (nq, 2, 3), (nq, 2))
            if any(a is None or tuple(a.shape) != s
                   for a, s in zip(t, shapes)):
                raise ValueError("the Nitsche interface kernels take 3 "
                                 "fields of 9 biquadratic functions per "
                                 "side in 3D, jets to order 3")
            return [a.contiguous() for a in t]

        w = params["w"]
        E, nu, h = float(w["E"]), float(w["nu"]), float(w["h"])
        consts = [float(params["beta_d"]), float(params["beta_r"]),
                  d.weights[0], d.weights[1],
                  E * nu / (1.0 - nu ** 2), E / (1.0 + nu), h,
                  h ** 3 / 12.0]
        return side(self.side_a), side(self.side_b), consts

    def residual_cuda(self, U, params):
        """Kernel K8: one block per interface quadrature point."""
        sa, sb, consts = self._kernel_args(U, params)
        if U.shape != (self.ndof,):
            raise ValueError(f"U shape {tuple(U.shape)} != ({self.ndof},)")
        r = cuda_ext.load().nitsche_iface_residual(
            sa, sb, self.wq.contiguous(), self.surfJ.contiguous(),
            U.contiguous(), consts)
        cuda_ext.count("nitsche_iface_residual")
        return r

    def tangent_block_cuda(self, u_sub, pos_a, pos_b, params):
        """Kernel K9: one thread per interface quadrature point and local
        coefficient (its columns of the point's block); launches tallied
        by (type, points)."""
        sa, sb, consts = self._kernel_args(u_sub, params)
        if u_sub.shape != (len(self.support),):
            raise ValueError(f"u_sub shape {tuple(u_sub.shape)}, support "
                             f"{len(self.support)}")
        nq = self.wq.numel()
        for name, pos in (("pos_a", pos_a), ("pos_b", pos_b)):
            if tuple(pos.shape) != (nq, 3, 9):
                raise ValueError(f"{name} shape {tuple(pos.shape)}, expected "
                                 f"({nq}, 3, 9): another interface's "
                                 f"positions?")
        K = cuda_ext.load().nitsche_iface_tangent(
            sa, sb, pos_a.contiguous(), pos_b.contiguous(),
            self.wq.contiguous(), self.surfJ.contiguous(),
            u_sub.contiguous(), consts)
        cuda_ext.count("nitsche_iface_tangent",
                       (cuda_ext.short_dtype(u_sub.dtype), nq))
        return K
