"""Sum-factorized matrix-free operators for scalar tensor-product spaces
(port of tigar_tpu/ops/sumfac.py).

    W -> ck * K @ W + cm * M @ W

K is the stiffness (grad-grad) operator with the metric factor
G = qw * sqrtJ * g^{-1}, M the mass operator weighted by qw * sqrtJ.  On
identity (explicit B-spline) geometry G is qw times the identity and qw is
the product of per-direction 1D weights, so nothing per point is stored.

Element k of direction d supports the functions (starts_d[k] + a) mod
ncp_d, a = 0..p_d.  That one rule covers maximal-continuity open knots
(stride-1 windows), reduced continuity (interior multiplicity > 1) and
periodic knots (windows that wrap), so the JAX package's separate sliding
and gather formulations and its periodic pad/fold are one formulation here.

Kernel K4 (csrc/sumfac_apply.cu) carries ``sumfac_apply`` on CUDA tensors:
one thread per element gathers the window, runs the per-direction
contraction chains for the value and the gradient, weights them, runs the
transposed chains and scatter-adds.  ``sumfac_apply_ref`` is its plain
PyTorch version (per-direction window contractions ``_fwd_win`` /
``_bwd_win``); CPU tensors run it.  The right-hand side
(``sumfac_linear_form``) and the error norm (``sumfac_l2_error``) run once
per solve and use the plain chains on either device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import cuda_ext
from .basis import bspline_basis_ders
from .quadrature import gauss_rule, npoints_for_degree
from ..config import DEFAULT_REAL_TYPE, resolve_device


def _dir_tables(kv, npts):
    """Per-direction 1D tables (numpy): values B [nel1, nq1, p+1],
    derivatives D [nel1, nq1, p+1], window starts s [nel1] (negative for
    periodic vectors: element k supports functions (k-p..k) mod ncp),
    weights qw [nel1, nq1] and points qp [nel1, nq1]."""
    g, w = gauss_rule(npts)
    spans = kv.element_spans()
    lefts = kv.unique_knots[:-1]
    h = kv.element_sizes()
    qp = lefts[:, None] + (g[None, :] + 1.0) * 0.5 * h[:, None]
    qw = 0.5 * h[:, None] * w[None, :]
    ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p,
                              qp.reshape(-1), np.repeat(spans, npts), 1)
    ders = ders.reshape(kv.nel, npts, 2, kv.p + 1)
    starts = (spans - kv.p).astype(np.int32)
    return ders[:, :, 0, :], ders[:, :, 1, :], starts, qw, qp


@dataclass
class SumfacData:
    """Tables of a sum-factorized operator, all on one device.

    B, D, w, qp : per direction d (direction 0 first): values and
                  derivatives [nel_d, nq, p_d+1], 1D weights and points
                  [nel_d, nq] (dtype of the operator)
    starts      : per direction, int32 [nel_d] window starts
    G, Gm       : None on identity geometry; else the metric factor
                  [nel, nq**dim, dim, dim] and the mass weight
                  [nel, nq**dim], element-major (elements and points each
                  in C order over (direction dim-1, ..., direction 0))
    """
    ncp_d: tuple
    nel_d: tuple
    nq: int
    degrees: tuple
    B: list
    D: list
    starts: list
    w: list
    qp: list
    G: Optional[torch.Tensor] = None
    Gm: Optional[torch.Tensor] = None

    @property
    def dim(self):
        return len(self.ncp_d)

    @property
    def ndof(self):
        return int(np.prod(self.ncp_d))

    def windows(self):
        """Per direction, int64 [nel_d, p_d+1] wrapped DoF indices."""
        return [(s.long()[:, None]
                 + torch.arange(p + 1, device=s.device)[None, :]) % n
                for s, p, n in zip(self.starts, self.degrees, self.ncp_d)]


def build_sumfac_data(basis, geom, quad_degree, device="cuda",
                      dtype=DEFAULT_REAL_TYPE):
    """Sum-factorization tables of a scalar TensorBSplineBasis on geometry
    ``geom`` (the QP of an ExtractedSpline's volume assembler, built with
    the SAME quadrature degree), or ``geom=None`` for identity geometry."""
    device = resolve_device(device)
    npts = npoints_for_degree(quad_degree)
    tabs = [_dir_tables(kv, npts) for kv in basis.kvs]

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    data = SumfacData(
        ncp_d=tuple(kv.ncp for kv in basis.kvs),
        nel_d=tuple(kv.nel for kv in basis.kvs),
        nq=npts, degrees=tuple(kv.p for kv in basis.kvs),
        B=[t(x[0]) for x in tabs], D=[t(x[1]) for x in tabs],
        starts=[t(x[2], torch.int32) for x in tabs],
        w=[t(x[3]) for x in tabs], qp=[t(x[4]) for x in tabs])
    if geom is not None:
        dim = data.dim
        nel, nq = int(np.prod(data.nel_d)), npts ** dim
        Gk = _identity_weight(data, interleaved=False).reshape(nel, nq) \
            * geom.sqrtJ.reshape(nel, nq).to(device, dtype)
        ginv = geom.ginv.reshape(nel, nq, dim, dim).to(device, dtype)
        data.G = (ginv * Gk[..., None, None]).contiguous()
        data.Gm = Gk.contiguous()
    return data


def _identity_weight(data, interleaved=True):
    """Product of the 1D weights as a broadcast tensor: axes
    (e_{D-1}, q_{D-1}, ..., e_0, q_0) when ``interleaved``, else
    (e_{D-1}, ..., e_0, q_{D-1}, ..., q_0)."""
    dim = data.dim
    out = None
    for d in range(dim):
        shape = [1] * (2 * dim)
        if interleaved:
            pos_e, pos_q = 2 * (dim - 1 - d), 2 * (dim - 1 - d) + 1
        else:
            pos_e, pos_q = dim - 1 - d, 2 * dim - 1 - d
        shape[pos_e], shape[pos_q] = data.w[d].shape
        wd = data.w[d].reshape(shape)
        out = wd if out is None else out * wd
    return out


def _interleave(x, dim, trailing=0):
    """[e_{D-1}, ..., e_0, q_{D-1}, ..., q_0, *trailing] ->
    (e_{D-1}, q_{D-1}, ..., e_0, q_0, *trailing) (a view)."""
    perm = []
    for k in range(dim):
        perm += [k, dim + k]
    return x.permute(perm + list(range(2 * dim, 2 * dim + trailing)))


def _fwd_win(x, T, idx, axis_from_last):
    """Window contraction: the DoF axis ``axis_from_last`` positions before
    the end becomes an (element, quad-point) axis pair, by p+1 shifted
    (wrapped) reads multiplied by the table column."""
    nel, nq, pp = T.shape
    ax = x.ndim - 1 - axis_from_last
    xm = x.movedim(ax, -1)
    out = 0.0
    for a in range(pp):
        out = out + xm.index_select(-1, idx[:, a])[..., None] * T[:, :, a]
    return out.movedim((-2, -1), (ax, ax + 1))


def _bwd_win(w, T, idx, n, axis_from_last):
    """Transpose of _fwd_win: the (e, q) axis pair collapses back onto a
    DoF axis of length ``n`` by q-contraction and shifted (wrapped) adds."""
    nel, nq, pp = T.shape
    ax = w.ndim - 2 - axis_from_last
    wm = w.movedim((ax, ax + 1), (-2, -1))
    out = wm.new_zeros(wm.shape[:-2] + (n,))
    for a in range(pp):
        out.index_add_(-1, idx[:, a], (wm * T[:, :, a]).sum(-1))
    return out.movedim(-1, ax)


def _chain(Ug, tables, idx):
    """Quadrature-point field (e_{D-1}, q_{D-1}, ..., e_0, q_0) of the
    coefficient grid Ug (axes dim-1..0) through per-direction tables."""
    for d, T in enumerate(tables):
        Ug = _fwd_win(Ug, T, idx[d], 2 * d)
    return Ug


def _chain_t(w, tables, idx, ncp_d):
    """Transpose of _chain: back onto the coefficient grid."""
    for d in reversed(range(len(tables))):
        w = _bwd_win(w, tables[d], idx[d], ncp_d[d], 2 * d)
    return w


def sumfac_apply(data, W, ck, cm, mask=None):
    """r = ck K W_in + cm M W_in with W_in = mask * W; with a ``mask`` the
    result follows zeroRowsColumns semantics with a unit diagonal:
    mask * r + (1 - mask) W.  CUDA tensors run kernel K4; CPU tensors run
    ``sumfac_apply_ref``."""
    if W.is_cuda:
        return sumfac_apply_cuda(data, W, ck, cm, mask)
    return sumfac_apply_ref(data, W, ck, cm, mask)


def sumfac_apply_ref(data, W, ck, cm, mask=None):
    """Plain PyTorch version of kernel K4 (the contraction chains of the
    JAX package, one per field, on the wrapped element windows)."""
    dim = data.dim
    idx = data.windows()
    W_in = W if mask is None else mask * W
    Ug = W_in.reshape(data.ncp_d[::-1])

    def tabs(deriv):          # D in direction ``deriv``, B elsewhere
        return [data.D[d] if d == deriv else data.B[d] for d in range(dim)]

    grads = [_chain(Ug, tabs(c), idx) for c in range(dim)]
    val = _chain(Ug, tabs(None), idx)
    if data.G is None:
        Gm = _identity_weight(data)
        ws = [Gm * g for g in grads]
    else:
        G = _interleave(data.G.reshape(data.nel_d[::-1] + (data.nq,) * dim
                                       + (dim, dim)), dim, 2)
        Gm = _interleave(data.Gm.reshape(data.nel_d[::-1]
                                         + (data.nq,) * dim), dim)
        ws = [sum(G[..., d, c] * grads[d] for d in range(dim))
              for c in range(dim)]
    r = cm * _chain_t(Gm * val, tabs(None), idx, data.ncp_d)
    for c in range(dim):
        r = r + ck * _chain_t(ws[c], tabs(c), idx, data.ncp_d)
    r = r.reshape(-1)
    if mask is not None:
        r = mask * r + (1.0 - mask) * W
    return r


def sumfac_apply_cuda(data, W, ck, cm, mask=None):
    """Kernel K4: one thread per element; the window, the three-stage
    contraction chains and the transposed chains in registers; atomic
    scatter-add, then the BC epilogue (2D/3D, p <= 3, nq in {p+1, p+2},
    float32 or float64).  Its launches are tallied by grid and type
    (``cuda_ext.counts_by``)."""
    dim = data.dim
    if not W.is_cuda or W.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K4 takes a CUDA float32/float64 W, got "
                        f"{W.dtype} on {W.device}")
    if dim not in (2, 3) or len(set(data.degrees)) != 1 \
            or not 1 <= data.degrees[0] <= 3 \
            or data.nq - data.degrees[0] - 1 not in (0, 1):
        raise ValueError(f"K4 takes dim 2/3, one degree p <= 3 and nq in "
                         f"(p+1, p+2); got degrees {data.degrees}, "
                         f"nq {data.nq}")
    if tuple(W.shape) != (data.ndof,) or not W.is_contiguous():
        raise ValueError(f"W must be contiguous [{data.ndof}], got "
                         f"{tuple(W.shape)}")
    if mask is not None and (mask.dtype != W.dtype or not mask.is_cuda or
                             tuple(mask.shape) != (data.ndof,)
                             or not mask.is_contiguous()):
        raise ValueError("mask must be a contiguous CUDA tensor like W")
    ext = cuda_ext.load()
    r = ext.sumfac_apply(W, data.B, data.D, data.starts,
                         data.w if data.G is None else [], data.G, data.Gm,
                         mask, list(data.ncp_d), float(ck), float(cm))
    cuda_ext.count("sumfac_apply", f"{'x'.join(map(str, data.nel_d))} "
                                   f"{cuda_ext.short_dtype(W.dtype)}")
    return r


def make_sumfac_operator(spline, ck=1.0, cm=0.0):
    """Matrix-free W -> ck K W + cm M W on the spline's geometry (scalar
    tensor-product space), with the spline's BC mask (zeroRowsColumns)."""
    if spline.space.nfields != 1:
        raise ValueError("sum factorization supports scalar spaces")
    data = build_sumfac_data(spline.space.fields[0], spline.geometry,
                             spline.quad_degree, spline.device, spline.dtype)
    mask = spline.mask
    return lambda W: sumfac_apply(data, W, ck, cm, mask)


def make_sumfac_identity_operator(basis, quad_degree, mask=None, ck=1.0,
                                  cm=0.0, dtype=DEFAULT_REAL_TYPE,
                                  device="cuda"):
    """Sum-factorized ck K + cm M on identity geometry, without an
    ExtractedSpline: nothing per element or per point is stored.  ``mask``
    is an optional BC mask (numpy or tensor)."""
    data = build_sumfac_data(basis, None, quad_degree, device, dtype)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=dtype, device=data.B[0].device)
    return lambda W: sumfac_apply(data, W, ck, cm, mask)


def _quad_coords(data):
    """Coordinates at the quadrature points (identity geometry) as
    broadcast tensors per direction, interleaved layout."""
    dim = data.dim
    coords = []
    for d in range(dim):
        shape = [1] * (2 * dim)
        pos = 2 * (dim - 1 - d)
        shape[pos], shape[pos + 1] = data.qp[d].shape
        coords.append(data.qp[d].reshape(shape))
    return coords


def sumfac_linear_form(basis, quad_degree, fn, dtype=DEFAULT_REAL_TYPE,
                       device="cuda"):
    """b_i = integral fn(x) N_i dx on identity geometry without any dense
    tabulation: fn on the quadrature grid, weighted, through the
    transposed value chain.  ``fn`` maps per-direction coordinate tensors
    (broadcastable) to values."""
    data = build_sumfac_data(basis, None, quad_degree, device, dtype)
    Gm = _identity_weight(data)
    F = torch.as_tensor(fn(*_quad_coords(data)), dtype=dtype,
                        device=Gm.device)
    return _chain_t(Gm * F, data.B, data.windows(), data.ncp_d).reshape(-1)


def sumfac_l2_error(basis, quad_degree, U, exact_fn):
    """L2 norm of (u_h - exact) on identity geometry (a 0-dim tensor on
    U's device, in U's dtype)."""
    data = build_sumfac_data(basis, None, quad_degree, U.device, U.dtype)
    val = _chain(U.reshape(data.ncp_d[::-1]), data.B, data.windows())
    e = val - exact_fn(*_quad_coords(data))
    return torch.sqrt(torch.sum(_identity_weight(data) * e * e))
