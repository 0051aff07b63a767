"""Sum-factorized evaluation and assembly of arbitrary forms (port of
tigar_tpu/ops/sumfac_forms.py).

The jets (value, parametric gradient, Hessian) of every field at every
quadrature point come from per-direction 1D tables, with no dense
[nel, nq, nen] tabulation: multi-field spaces with per-field degrees (RT
compatible splines), derivative order 2 (shells), reduced-continuity open
knots (uniform interior multiplicity: strided slide windows), periodic
knots (gather windows that wrap) and rational geometry, itself evaluated
by the same jets.  A residual is E^T g, with E the (linear) jet map and g
the pointwise gradient of the density with respect to the test jets;
tangent actions are written out from linearity: the jets of W, the
forward derivative of g at the jets of U in their direction, E^T.

Quadrature-grid layout, as the JAX package: every per-point array (ctx
leaves, scale, jets) lives on the interleaved grid (e_{D-1}, q_{D-1}, ...,
e_0, q_0) flattened to one leading axis of NQ = nel * nq points; DoF
vectors keep the dir-0-fastest convention.

Kernels.  On CUDA tensors the jet map runs kernel K15 and its transpose
kernel K16 (csrc/sumfac_jets.cu), through ``torch.autograd.Function``s
whose backwards are each other; CPU tensors run the plain versions
``field_jets_plain`` (the JAX package's windowed slices and einsums) and
``scatter_jets_plain`` (``torch.func.vjp`` of it: the exact transpose).
Equal-order fields share one plan and go through one launch as a batch of
coefficient columns; the jets are written in the layout the densities
read (val [NQ(, m)], g [NQ(, m), D], h [NQ(, m), D, D]).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_REAL_TYPE, resolve_device
from ..forms import Jet, tree_grad, tree_jvp
from . import cuda_ext
from .assembly import _vmap_density
from .basis import bspline_basis_ders
from .quadrature import gauss_rule, npoints_for_degree

# quadrature points per torch.func batch of the pointwise densities (the
# element chunks of ops/assembly.py times 8 points)
POINT_CHUNK = 65536


# -- per-direction tables ------------------------------------------------------


class DirTables:
    """1D basis tables of one parametric direction (host numpy).

    T      : [nel1, nq1, nders+1, p+1] values/derivatives of the p+1
             supported functions on each element at each quad point
    qw, qp : [nel1, nq1]
    mode   : "slide" (open knots, uniform window stride) or "gather"
    start0, stride : window start = start0 + stride * e   (slide mode)
    idx    : [nel1, p+1] int32 window indices (gather mode; wraps for
             periodic knots), else None
    """

    def __init__(self, kv, npts, nders):
        g, w = gauss_rule(npts)
        spans = kv.element_spans()
        lefts = kv.unique_knots[:-1]
        h = kv.element_sizes()
        qp = lefts[:, None] + (g[None, :] + 1.0) * 0.5 * h[:, None]
        qw = 0.5 * h[:, None] * w[None, :]
        ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p,
                                  qp.reshape(-1), np.repeat(spans, npts),
                                  nders)
        self.T = ders.reshape(kv.nel, npts, nders + 1, kv.p + 1)
        self.qw = qw
        self.qp = qp
        self.nel = kv.nel
        self.nq = npts
        self.ncp = kv.ncp
        self.pp = kv.p + 1
        starts = (spans - kv.p).astype(np.int64)
        strides = np.diff(starts)
        uniform = len(starts) == 1 or np.all(strides == strides[0])
        if not kv.is_periodic and uniform and starts[0] >= 0:
            self.mode = "slide"
            self.start0 = int(starts[0])
            self.stride = int(strides[0]) if len(starts) > 1 else 1
            self.idx = None
        else:
            self.mode = "gather"
            self.start0 = 0
            self.stride = 1
            idx = starts[:, None] + np.arange(kv.p + 1)[None, :]
            self.idx = np.mod(idx, kv.ncp).astype(np.int32)


class FieldPlan:
    """Metadata and tables of one scalar tensor-product field."""

    def __init__(self, basis, npts, nders):
        self.dim = basis.dim
        self.nders = int(nders)
        self.tables = [DirTables(kv, npts, nders) for kv in basis.kvs]
        self.ncp_d = tuple(kv.ncp for kv in basis.kvs)
        self.nel_d = tuple(kv.nel for kv in basis.kvs)
        self.nq_d = (npts,) * self.dim
        self.ncp = int(np.prod(self.ncp_d))

    def meta(self):
        """Per-direction (mode, start0, stride, nel, pp)."""
        return tuple((t.mode, t.start0, t.stride, t.nel, t.pp)
                     for t in self.tables)


# -- the plain jet chains (the JAX package's formulation) ----------------------


def _fwd_dir(x, T_d, der, meta_d, axis_from_last):
    """Contract the DoF axis ``axis_from_last`` (counted from the end) with
    the ``der``-th derivative table of one direction (slide windows),
    producing an adjacent (element, quad) axis pair in its place."""
    _, s0, m, nel, pp = meta_d
    T = T_d[:, :, der, :]
    ax = x.dim() - 1 - axis_from_last
    xm = torch.movedim(x, ax, -1)
    out = 0.0
    for a in range(pp):
        lo = s0 + a
        sl = xm[..., lo:lo + m * (nel - 1) + 1:m]
        out = out + sl[..., None] * T[:, :, a]
    return torch.movedim(out, (-2, -1), (ax, ax + 1))


def _fwd_dir_gather(x, T_d, idx, der, axis_from_last):
    T = T_d[:, :, der, :]
    ax = x.dim() - 1 - axis_from_last
    xm = torch.movedim(x, ax, -1)
    out = torch.einsum("...ea,eqa->...eq", xm[..., idx], T)
    return torch.movedim(out, (-2, -1), (ax, ax + 1))


def _eval_chains(W_grid, tabs, idxs, metas, ders_per_dir):
    """One chain: contract direction d with derivative order
    ders_per_dir[d], direction 0 first; the interleaved grid array."""
    x = W_grid
    for d in range(len(metas)):
        # after d contractions the target axis sits 2 d from the end
        if metas[d][0] == "slide":
            x = _fwd_dir(x, tabs[d], ders_per_dir[d], metas[d], 2 * d)
        else:
            x = _fwd_dir_gather(x, tabs[d], idxs[d], ders_per_dir[d], 2 * d)
    return x


def field_jets_plain(W, tabs, idxs, metas, ncp_d, nders):
    """Plain version of K15: jets of one scalar field, W [ncp] -> (val
    [NQ], g [NQ, D], h [NQ, D, D] or None), or of a batch of coefficient
    columns W [m, ncp] -> ([NQ, m], [NQ, m, D], [NQ, m, D, D]).  Linear in
    W; ``idxs`` holds int64 tensors for gather directions."""
    dim = len(metas)
    lead = tuple(W.shape[:-1])
    Wg = W.reshape(lead + tuple(ncp_d[::-1]))

    def chain(ders):
        x = _eval_chains(Wg, tabs, idxs, metas, ders).reshape(lead + (-1,))
        return torch.movedim(x, 0, -1) if lead else x

    val = chain((0,) * dim)
    gs = []
    for d in range(dim):
        o = [0] * dim
        o[d] = 1
        gs.append(chain(tuple(o)))
    g = torch.stack(gs, dim=-1)
    h = None
    if nders >= 2:
        cols = {}
        for c in range(dim):
            for d_ in range(c, dim):
                o = [0] * dim
                o[c] += 1
                o[d_] += 1
                cols[(c, d_)] = chain(tuple(o))
        h = torch.stack([torch.stack([cols[(min(c, d_), max(c, d_))]
                                      for d_ in range(dim)], dim=-1)
                         for c in range(dim)], dim=-2)
    return val, g, h


# -- column layouts: which plan evaluates which coefficients -------------------


class JetGroup(NamedTuple):
    """``ncols`` coefficient columns of one plan inside a flat vector:
    column c of coefficient i at ``base + c col_stride + i cp_stride``;
    their jets are columns col0 .. col0 + ncols - 1 of the output."""
    plan: "DevicePlan"
    base: int
    ncols: int
    col_stride: int
    cp_stride: int
    col0: int


class DevicePlan:
    """A FieldPlan's tables on a device: ``tabs`` (per direction
    [nel, nq, nders+1, pp]), ``idxs`` (int64 gather windows or None) and,
    built on first use by K15/K16, int32 windows and the inverse lists
    (per coefficient, the (element, slot) pairs e pp + a that cover it)
    of the gather directions."""

    def __init__(self, plan, device, dtype):
        self.metas = plan.meta()
        self.ncp_d = plan.ncp_d
        self.nders = plan.nders
        self.tabs = tuple(torch.as_tensor(t.T, dtype=dtype, device=device)
                          for t in plan.tables)
        self.idxs = tuple(None if t.idx is None else torch.as_tensor(
            t.idx.astype(np.int64), device=device) for t in plan.tables)
        self._kernel = None

    @classmethod
    def from_tensors(cls, tabs, idxs, metas, ncp_d, nders):
        obj = cls.__new__(cls)
        obj.metas, obj.ncp_d, obj.nders = tuple(metas), tuple(ncp_d), nders
        obj.tabs, obj.idxs = tuple(tabs), tuple(idxs)
        obj._kernel = None
        return obj

    @property
    def dim(self):
        return len(self.metas)

    @property
    def ncp(self):
        return int(np.prod(self.ncp_d))

    @property
    def nq_total(self):
        n = 1
        for t in self.tabs:
            n *= t.shape[0] * t.shape[1]
        return n

    def cast(self, dtype):
        return DevicePlan.from_tensors([t.to(dtype) for t in self.tabs],
                                       self.idxs, self.metas, self.ncp_d,
                                       self.nders)

    def jets_plain(self, W):
        return field_jets_plain(W, self.tabs, self.idxs, self.metas,
                                self.ncp_d, self.nders)

    def kernel_args(self):
        """(tables, windows for K15, inverse lists for K16, starts,
        strides): contiguous tensors on the plan's device."""
        if self._kernel is None:
            dev = self.tabs[0].device
            empty = torch.zeros(0, dtype=torch.int32, device=dev)
            win, inv = [], []
            for (mode, _, _, nel, pp), idx, ncp in zip(
                    self.metas, self.idxs, self.ncp_d):
                if mode == "slide":
                    win.append(empty)
                    inv.append(empty)
                    continue
                idx_np = idx.cpu().numpy().astype(np.int64)
                flat = idx_np.reshape(-1)          # e pp + a -> coefficient
                order = np.argsort(flat, kind="stable")
                ptr = np.zeros(ncp + 1, dtype=np.int64)
                np.add.at(ptr, flat + 1, 1)
                inv_np = np.concatenate([np.cumsum(ptr), order])
                win.append(torch.as_tensor(idx_np.astype(np.int32),
                                           device=dev))
                inv.append(torch.as_tensor(inv_np.astype(np.int32),
                                           device=dev))
            self._kernel = ([t.contiguous() for t in self.tabs], win, inv,
                            [m[1] for m in self.metas],
                            [m[2] for m in self.metas])
        return self._kernel


class JetLayout:
    """The jet map of one flat coefficient vector of ``n`` entries: its
    ``groups`` (JetGroup, in column order) fill M columns of jets at the
    plans' shared NQ points (derivative order ``nders``)."""

    def __init__(self, groups, n):
        self.groups = tuple(groups)
        self.n = int(n)
        self.M = sum(g.ncols for g in self.groups)
        p0 = self.groups[0].plan
        self.dim, self.nders, self.nq_total = p0.dim, p0.nders, p0.nq_total
        for g in self.groups:
            if g.plan.nq_total != self.nq_total or g.plan.dim != self.dim:
                raise ValueError("all fields must share the quadrature grid")

    def cast(self, dtype):
        memo = {}

        def plan(p):
            if id(p) not in memo:
                memo[id(p)] = p.cast(dtype)
            return memo[id(p)]

        return JetLayout([g._replace(plan=plan(g.plan)) for g in self.groups],
                         self.n)


def _columns(W, g):
    """[ncols, ncp]: one group's coefficient columns gathered (plain)."""
    ncp = g.plan.ncp
    idx = (g.base + torch.arange(g.ncols, device=W.device)[:, None]
           * g.col_stride + torch.arange(ncp, device=W.device)[None, :]
           * g.cp_stride)
    return W[idx]


def jets_plain(W, layout):
    """Plain version of the whole jet map: (val [NQ, M], g [NQ, M, D],
    h [NQ, M, D, D] or None) of the flat vector W."""
    parts = [g.plan.jets_plain(_columns(W, g)) for g in layout.groups]
    val = torch.cat([p[0] for p in parts], dim=1)
    gr = torch.cat([p[1] for p in parts], dim=1)
    h = None if parts[0][2] is None else torch.cat([p[2] for p in parts],
                                                   dim=1)
    return val, gr, h


def scatter_jets_plain(cot, layout):
    """Plain version of K16: the transpose of ``jets_plain`` (torch.func.vjp
    of it), cot = (val, g, h or None) in its layout -> [n]."""
    zero = torch.zeros(layout.n, dtype=cot[0].dtype, device=cot[0].device)

    def f(W):
        val, g, h = jets_plain(W, layout)
        return (val, g) if h is None else (val, g, h)

    _, pull = torch.func.vjp(f, zero)
    cots = tuple(c for c in cot if c is not None)
    return pull(cots)[0]


# -- K15 / K16 -----------------------------------------------------------------


def _check_cuda(x, name, dtype, shape):
    if not x.is_cuda or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous CUDA {dtype} tensor "
                         f"of shape {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _check_layout(layout, dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K15/K16 take float32 or float64, got {dtype}")
    if layout.dim not in (2, 3) or layout.nders not in (1, 2):
        raise ValueError(f"K15/K16 take 2D/3D plans of derivative order 1 "
                         f"or 2, got dim {layout.dim}, nders "
                         f"{layout.nders}")
    for g in layout.groups:
        if any(not 1 <= m[4] <= 4 for m in g.plan.metas):
            raise ValueError("K15/K16 take degrees up to 3 a direction")
        if g.plan.tabs[0].dtype != dtype or not g.plan.tabs[0].is_cuda:
            raise ValueError(f"the plan's tables must be CUDA {dtype}")


def jets_cuda(W, layout):
    """Kernel K15: one launch per group into one set of outputs."""
    _check_layout(layout, W.dtype)
    _check_cuda(W, "W", W.dtype, (layout.n,))
    NQ, M, D = layout.nq_total, layout.M, layout.dim
    val = torch.empty((NQ, M), dtype=W.dtype, device=W.device)
    g = torch.empty((NQ, M, D), dtype=W.dtype, device=W.device)
    h = (torch.empty((NQ, M, D, D), dtype=W.dtype, device=W.device)
         if layout.nders >= 2 else None)
    ext = cuda_ext.load()
    for grp in layout.groups:
        tabs, win, _, starts, strides = grp.plan.kernel_args()
        ext.sumfac_jets(W, tabs, win, starts, strides,
                        list(grp.plan.ncp_d), layout.nders, grp.base,
                        grp.ncols, grp.col_stride, grp.cp_stride, val, g, h,
                        grp.col0)
        cuda_ext.count("sumfac_jets")
    return val, g, h


def scatter_jets_cuda(cot, layout):
    """Kernel K16: one call per group, two launches (each element's
    window slots, its cotangents read straight from device memory and
    contracted a direction at a time in registers, then each
    coefficient's sum of the slots that cover it); every coefficient of
    the layout's columns written once (the rest of the vector stays
    zero)."""
    val, g, h = cot
    dtype = val.dtype
    _check_layout(layout, dtype)
    NQ, M, D = layout.nq_total, layout.M, layout.dim
    _check_cuda(val, "cval", dtype, (NQ, M))
    _check_cuda(g, "cg", dtype, (NQ, M, D))
    if layout.nders >= 2:
        _check_cuda(h, "ch", dtype, (NQ, M, D, D))
    out = torch.zeros(layout.n, dtype=dtype, device=val.device)
    ext = cuda_ext.load()
    for grp in layout.groups:
        tabs, _, inv, starts, strides = grp.plan.kernel_args()
        ext.sumfac_scatter_jets(val, g, h if layout.nders >= 2 else None,
                                tabs, inv, starts, strides,
                                list(grp.plan.ncp_d), layout.nders,
                                grp.col0, grp.ncols, grp.col_stride,
                                grp.cp_stride, out, grp.base)
        cuda_ext.count("sumfac_scatter_jets")
    return out


class _Jets(torch.autograd.Function):
    """K15 with K16 as its backward (the maps are each other's
    transposes)."""

    @staticmethod
    def forward(W, layout):
        val, g, h = jets_cuda(W, layout)
        return (val, g) if h is None else (val, g, h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.layout = inputs[1]

    @staticmethod
    def backward(ctx, *cots):
        return _ScatterJets.apply(ctx.layout, *cots), None


class _ScatterJets(torch.autograd.Function):
    """K16 with K15 as its backward."""

    @staticmethod
    def forward(layout, val, g, h=None):
        return scatter_jets_cuda((val.contiguous(), g.contiguous(),
                                  None if h is None else h.contiguous()),
                                 layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.layout = inputs[0]

    @staticmethod
    def backward(ctx, cot):
        return (None,) + tuple(_Jets.apply(cot.contiguous(), ctx.layout))


def layout_jets(W, layout):
    """(val [NQ, M], g [NQ, M, D], h or None) of the flat vector W: K15 on
    CUDA tensors (differentiable, K16 backward), the plain version on CPU
    tensors."""
    if W.is_cuda:
        out = _Jets.apply(W.contiguous(), layout)
        return out[0], out[1], (out[2] if len(out) > 2 else None)
    return jets_plain(W, layout)


def layout_scatter(cot, layout):
    """The transpose of ``layout_jets``: K16 on CUDA tensors, the plain
    version on CPU tensors."""
    val, g, h = cot
    if val.is_cuda:
        args = (val, g) if layout.nders < 2 else (val, g, h)
        return _ScatterJets.apply(layout, *args)
    return scatter_jets_plain(cot, layout)


# -- the assembler -------------------------------------------------------------


def _tree_slice(tree, sl):
    return torch.utils._pytree.tree_map(
        lambda x: x[sl] if isinstance(x, torch.Tensor) else x, tree)


def _tree_cat(parts):
    leaves0, spec = torch.utils._pytree.tree_flatten(parts[0])
    flat = [torch.utils._pytree.tree_flatten(p)[0] for p in parts]
    out = [torch.cat([f[i] for f in flat], dim=0)
           if isinstance(leaves0[i], torch.Tensor) else leaves0[i]
           for i in range(len(leaves0))]
    return torch.utils._pytree.tree_unflatten(out, spec)


class SumfacAssembler:
    """Drop-in analog of DomainAssembler for tensor-product spaces, with
    all basis evaluation sum-factorized.

    Parameters
    ----------
    plans   : list of FieldPlan or DevicePlan (one per field; shared
              element grid; consecutive fields that share one plan object
              share its tables and one launch)
    offsets : [nfields+1] global DoF offsets
    ctx     : QP, leaves [NQ, ...] in the interleaved grid layout
    scale   : [NQ] quadrature weight * volume Jacobian
    """

    def __init__(self, plans, offsets, ndof, ctx, scale, device=None,
                 dtype=None):
        self.nfields = len(plans)
        self.offsets = tuple(int(o) for o in offsets)
        self.ndof = int(ndof)
        self.ctx = ctx
        self.scale = torch.as_tensor(scale, dtype=dtype, device=device)
        dtype, device = self.scale.dtype, self.scale.device
        memo = {}
        for p in plans:
            if id(p) not in memo:
                memo[id(p)] = (p if isinstance(p, DevicePlan)
                               else DevicePlan(p, device, dtype))
        self.layout = self._layout([memo[id(p)] for p in plans])

    def _layout(self, dev_plans):
        """Consecutive fields of one plan form one group of columns."""
        groups = []
        for f, p in enumerate(dev_plans):
            last = groups[-1] if groups else None
            if last is not None and last.plan is p and \
                    last.col0 + last.ncols == f:
                groups[-1] = last._replace(ncols=last.ncols + 1)
            else:
                groups.append(JetGroup(p, self.offsets[f], 1, p.ncp, 1, f))
        return JetLayout(groups, self.ndof)

    def _per_field(self, attr):
        return tuple(getattr(g.plan, attr) for g in self.layout.groups
                     for _ in range(g.ncols))

    @property
    def tabs(self):
        return self._per_field("tabs")

    @property
    def idxs(self):
        return self._per_field("idxs")

    @property
    def metas(self):
        return self._per_field("metas")

    @property
    def ncp_ds(self):
        return self._per_field("ncp_d")

    @property
    def nders(self):
        return self._per_field("nders")

    @property
    def nq_total(self):
        return self.scale.shape[0]

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def device(self):
        return self.scale.device

    def to(self, dtype):
        """Copy with every floating tensor (ctx, scale, tables) cast to
        ``dtype``; index tensors are shared."""
        obj = SumfacAssembler.__new__(SumfacAssembler)
        obj.__dict__.update(self.__dict__)
        obj.ctx = self.ctx.map(
            lambda x: x.to(dtype) if x.is_floating_point() else x)
        obj.scale = self.scale.to(dtype)
        obj.layout = self.layout.cast(dtype)
        return obj

    # -- jet evaluation (linear map E) ------------------------------------------

    def jets(self, U):
        """Jets of the global DoF vector at all quadrature points:
        Jet(val [NQ(,m)], g [NQ(,m),d], h [NQ(,m),d,d])."""
        val, g, h = layout_jets(U, self.layout)
        if self.nfields == 1:
            NQ, D = val.shape[0], g.shape[-1]
            return Jet(val.reshape(NQ), g.reshape(NQ, D),
                       None if h is None else h.reshape(NQ, D, D))
        return Jet(val, g, h)

    def jets_tree(self, U):
        if isinstance(U, dict):
            return {k: self.jets(v) for k, v in U.items()}
        return self.jets(U)

    def _zero_jets(self, n=None):
        """Zero test jets at ``n`` points (all by default)."""
        dtype, device = self.dtype, self.device
        n = self.nq_total if n is None else n
        dim = self.layout.dim
        lead = (n,) if self.nfields == 1 else (n, self.nfields)
        h = (torch.zeros(lead + (dim, dim), dtype=dtype, device=device)
             if self.layout.nders >= 2 else None)
        return Jet(torch.zeros(lead, dtype=dtype, device=device),
                   torch.zeros(lead + (dim,), dtype=dtype, device=device), h)

    def scatter_jets(self, cot):
        """E^T: the adjoint of ``jets``, pointwise jet cotangents back to a
        global DoF vector (K16 on the card, the vjp of the plain chains
        on the CPU)."""
        NQ, M, D = self.nq_total, self.nfields, self.layout.dim
        h = None if cot.h is None else cot.h.reshape(NQ, M, D, D)
        return layout_scatter((cot.val.reshape(NQ, M),
                               cot.g.reshape(NQ, M, D), h), self.layout)

    # -- pointwise maps in point chunks ---------------------------------------

    def _chunks(self):
        NQ = self.nq_total
        return [slice(s, min(s + POINT_CHUNK, NQ))
                for s in range(0, NQ, POINT_CHUNK)]

    def _test_gradient(self, dens, uj, sl):
        """Pointwise gradient of sum(density * scale) with respect to the
        test jets at zero, on the points ``sl``; ``uj`` the unknown's jets
        there (None for a linear form)."""
        ctx, scale = _tree_slice(self.ctx, sl), self.scale[sl]
        zero = self._zero_jets(scale.shape[0])

        def total(v):
            d = dens(ctx, v) if uj is None else dens(ctx, uj, v)
            return torch.sum(d * scale)

        return tree_grad(total, zero)

    # -- assembly ---------------------------------------------------------------

    def functional(self, density, U=None, params=None):
        dens = _vmap_density(density, params)
        uj = None if U is None else self.jets_tree(U)
        total = 0.0
        for sl in self._chunks():
            ctx = _tree_slice(self.ctx, sl)
            d = dens(ctx) if uj is None else dens(ctx, _tree_slice(uj, sl))
            total = total + torch.sum(d * self.scale[sl])
        return total

    def residual_vector(self, density, U=None, params=None):
        """r_i = res(u; N_i) for density(ctx, u, v[, params]) linear in v
        (or L(N_i) for density(ctx, v) with U=None)."""
        dens = _vmap_density(density, params)
        uj = None if U is None else self.jets_tree(U)
        cot = _tree_cat([self._test_gradient(
            dens, None if uj is None else _tree_slice(uj, sl), sl)
            for sl in self._chunks()])
        return self.scatter_jets(cot)

    linear_vector = residual_vector

    def tangent_action(self, density, U, W, params=None):
        """(dR/dU)(U) @ W, matrix-free: the jets of W, the forward
        derivative of the pointwise test gradient at the jets of U in
        their direction, and the transpose (for a dict U the unknown is
        U["u"])."""
        dens = _vmap_density(density, params)
        uj = self.jets_tree(U)
        wj = self.jets(W)
        parts = []
        for sl in self._chunks():
            uj_c = _tree_slice(uj, sl)
            if isinstance(U, dict):
                def g_of(a, uj_c=uj_c, sl=sl):
                    ud = dict(uj_c)
                    ud["u"] = a
                    return self._test_gradient(dens, ud, sl)
                x = uj_c["u"]
            else:
                def g_of(a, sl=sl):
                    return self._test_gradient(dens, a, sl)
                x = uj_c
            parts.append(tree_jvp(g_of, x, _tree_slice(wj, sl))[1])
        return self.scatter_jets(_tree_cat(parts))


# -- construction from a spline -------------------------------------------------


def _interleave_perm(dim):
    # grid (e_{D-1},...,e_0, q_{D-1},...,q_0) -> (e_{D-1}, q_{D-1}, ...)
    perm = []
    for d in range(dim):
        perm += [d, dim + d]
    return tuple(perm)


def _on_grid(plan, arr2d, d):
    """Broadcast a per-direction [nel_d, nq_d] array onto the interleaved
    grid, flattened (numpy)."""
    dim = plan.dim
    blocked = plan.nel_d[::-1] + plan.nq_d[::-1]
    full = tuple(blocked[i] for i in _interleave_perm(dim))
    pos = 2 * (dim - 1 - d)
    shape = [1] * (2 * dim)
    shape[pos], shape[pos + 1] = arr2d.shape
    return np.broadcast_to(arr2d.reshape(shape), full).reshape(-1)


def sumfac_geometry(control_basis, bnet, quad_degree, nders=2,
                    device="cuda", dtype=DEFAULT_REAL_TYPE):
    """Geometry QP at all quadrature points, the control net's jets
    evaluated by the sum-factorized map (its nsd+1 components one batch of
    columns: one K15 launch on the card); leaves [NQ, ...] in the
    interleaved grid layout.  Returns (ctx, qw [NQ], plan)."""
    from .geometry import _geom_point

    device = resolve_device(device)
    npts = npoints_for_degree(quad_degree)
    plan = FieldPlan(control_basis, npts, nders)
    dplan = DevicePlan(plan, device, dtype)
    B = torch.as_tensor(np.asarray(bnet, dtype=np.float64), dtype=dtype,
                        device=device).contiguous()
    m = B.shape[1]
    layout = JetLayout([JetGroup(dplan, 0, m, 1, m, 0)], B.numel())
    H, Hg, Hh = layout_jets(B.reshape(-1), layout)
    xi = torch.as_tensor(np.stack([_on_grid(plan, plan.tables[d].qp, d)
                                   for d in range(plan.dim)], axis=-1),
                         dtype=dtype, device=device)
    ctx = _geom_point(xi, H, Hg, Hh)
    qw = _on_grid(plan, plan.tables[0].qw, 0)
    for d in range(1, plan.dim):
        qw = qw * _on_grid(plan, plan.tables[d].qw, d)
    return ctx, torch.as_tensor(qw, dtype=dtype, device=device), plan


def make_sumfac_assembler(spline):
    """A SumfacAssembler over an ExtractedSpline's space (every field a
    TensorBSplineBasis on the shared element grid), on the spline's device
    and in its dtype; replaces the generic tabulated DomainAssembler for
    volume terms."""
    from ..models.bspline import TensorBSplineBasis

    space = spline.space
    npts = spline.npts
    for f in range(space.nfields):
        if not isinstance(space.fields[f], TensorBSplineBasis):
            raise ValueError(
                "sum factorization requires tensor-product B-spline fields; "
                f"field {f} is {type(space.fields[f]).__name__} "
                "(multi-patch/T-spline spaces use the generic tabulated "
                "assembler)")
    if not isinstance(spline.control_basis, TensorBSplineBasis):
        raise ValueError("sum factorization requires a tensor-product "
                         "control basis")
    memo = {}
    plans = []
    for f in range(space.nfields):
        b = space.fields[f]
        if id(b) not in memo:
            memo[id(b)] = FieldPlan(b, npts, spline.nders)
        plans.append(memo[id(b)])
    ctx, qw, _ = sumfac_geometry(spline.control_basis, spline.bnet,
                                 spline.quad_degree,
                                 nders=max(2, spline.geom_nders),
                                 device=spline.device, dtype=spline.dtype)
    nel0 = plans[0].nel_d
    for p in plans:
        if p.nel_d != nel0:
            raise ValueError("all fields must share the element grid")
    return SumfacAssembler(plans, space.offsets, space.ndof, ctx,
                           qw * ctx.sqrtJ)
