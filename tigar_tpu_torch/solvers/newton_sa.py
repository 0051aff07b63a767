"""Space-agnostic mixed-precision Newton: element-batch tangents and
multilevel smoothed-aggregation preconditioning (port of ``CooTangent``,
``ElemTangent``, ``_masked_act`` -- here the operators' ``apply(x, mask)``
-- and ``SANewton`` of tigar_tpu/solvers/newton_sa.py).

The driver (step, polish_step, solve: f32 production steps, f64 polish
steps with flexible CG, overshoot rollback, the floor exit) is
StencilNewton's.  What changes is the tangent and the preconditioner:

  - the tangent is the batch of masked element matrices E [nel, nloc,
    nloc] (kernel K2's element mode on the card), applied as
    y = scatter(conn, E x[conn]) with the BC mask fused (kernel K10);
  - the preconditioner is a MultilevelSA V-cycle built on the host from
    the current f32 tangent values (scipy), lazily at the first linear
    solve and again after every polish-phase tangent rebuild; between
    rebuilds it is frozen, its fine level the f32 tangent it was built
    from.  Problems at or below the SA coarse size get a dense f32
    inverse instead.

The JAX package's TPU workarounds are not ported: the host-CPU polish
residual, chunked tangent builds, the ``hessian=`` density and the
dtype-dispatched einsum (K10 is one kernel per type).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .aggregation import MultilevelSA
from .linear import cg_device_iters, fcg_device_iters, bicgstab_device_iters
from .newton_stencil import StencilNewton
from ..ops.sparse import elem_tangent_apply, elem_tangent_diagonal

F32 = torch.float32


class CooTangent:
    """Assembled tangent as a coo operator (rows, cols, vals: one entry
    per element-matrix entry; out-of-range padded entries carry value 0
    and are dropped).  Plain PyTorch only: no path of either package
    constructs it."""

    def __init__(self, rows, cols, vals, ndof):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.ndof = int(ndof)
        ok = (rows >= 0) & (rows < self.ndof) & (cols >= 0) & \
            (cols < self.ndof)
        self._r, self._c, self._ok = rows[ok], cols[ok], ok

    def __call__(self, x):
        y = self.vals[self._ok] * x[self._c]
        return torch.zeros(self.ndof, dtype=x.dtype,
                           device=x.device).index_add_(0, self._r, y)

    def apply(self, x, mask=None):
        """mask * A(mask * x) + (1 - mask) * x (A x without ``mask``)."""
        if mask is None:
            return self(x)
        return mask * self(mask * x) + (1.0 - mask) * x

    def diagonal(self):
        v = self.vals[self._ok]
        d = torch.where(self._r == self._c, v, torch.zeros_like(v))
        return torch.zeros(self.ndof, dtype=v.dtype,
                           device=v.device).index_add_(0, self._r, d)

    def astype(self, dtype):
        return CooTangent(self.rows, self.cols, self.vals.to(dtype),
                          self.ndof)


class ElemTangent:
    """Element-batch tangent y = scatter(conn, E x[conn]) (kernel K10 on
    the card).  ``vals`` (row-major (element, a, b) entries, the coo
    convention of SANewton's rows/cols) feeds the host SA builds."""

    def __init__(self, conn, E, ndof):
        self.conn = conn                     # [nel, nloc] int32
        self.E = E                           # [nel, nloc, nloc]
        self.ndof = int(ndof)

    def __call__(self, x):
        return elem_tangent_apply(self.conn, self.E, x)

    def apply(self, x, mask=None):
        """The BC'd action mask * A(mask * x) + (1 - mask) * x (the plain
        action without ``mask``), one fused kernel."""
        return elem_tangent_apply(self.conn, self.E, x, mask)

    @property
    def vals(self):
        return self.E.reshape(-1)

    def diagonal(self):
        return elem_tangent_diagonal(self.conn, self.E, self.ndof)

    def astype(self, dtype):
        return ElemTangent(self.conn, self.E.to(dtype), self.ndof)


class _DenseInverse:
    """Exact f32 inverse (host-f64 built) of a BC'd operator at or below
    the SA coarse size: a one-level preconditioner."""

    n_levels = 1

    def __init__(self, Minv):
        self.Minv = Minv

    def __call__(self, r):
        return torch.matmul(self.Minv, r.to(F32)).to(r.dtype)


class SANewton(StencilNewton):
    """StencilNewton's driver over an equal-order ExtractedSpline with no
    tensor-product requirement: element-batch tangents and a multilevel
    SA preconditioner (see the module docstring).

    Parameters beyond the shared StencilNewton ones
    -----------------------------------------------
    sa_kwargs : dict passed to MultilevelSA.from_coo (coarsen, n_smooth,
                near_kernel, coarse_size, cycle, ...)
    inner_tol : optional relative-residual exit of the inner Krylov
                solves (checked every 20 iterations)
    krylov    : "cg" (symmetric tangents; flexible CG in the polish) or
                "bicgstab" (nonsymmetric tangents)
    """

    def __init__(self, spline, adjoint_res, mg_splines=(), cg_iters=40,
                 polish_cg_iters=60, polish_tangent="f64",
                 build_quad_degree=None, rebuild_rel=1e-5, sa_kwargs=None,
                 inner_tol=None, krylov="cg"):
        if tuple(mg_splines):
            raise ValueError("SANewton builds its own multilevel "
                             "hierarchy by aggregation; mg_splines must "
                             "be empty")
        for f in spline.space.fields:
            if f is not spline.space.fields[0]:
                raise ValueError("SANewton requires an equal-order space "
                                 "(shared scalar basis across fields)")
        if krylov not in ("cg", "bicgstab"):
            raise ValueError(f"krylov must be 'cg' or 'bicgstab', "
                             f"got {krylov!r}")
        self.spline = spline
        self.adjoint = adjoint_res
        self.cg_iters = int(cg_iters)
        self.inner_tol = inner_tol
        self.asm64 = spline._assembler("dx")
        self.asm32 = self.asm64.astype(F32)
        self._build_quad_degree = build_quad_degree
        self.asm_b64 = (self.asm64 if build_quad_degree is None
                        else spline._assembler("dx",
                                               quad_degree=build_quad_degree))
        self.asm_b32 = self.asm_b64.astype(F32)
        self.mask64 = spline.mask
        self.mask32 = spline.mask.to(F32)
        self.nf = spline.space.nfields
        self.mg_splines = []
        self._polish_cg_iters = int(polish_cg_iters)
        self.polish_tangent = str(polish_tangent)
        self.rebuild_rel = float(rebuild_rel)
        self._st64 = None
        self._sa = None
        self._sa_kwargs = dict(sa_kwargs or {})
        self.krylov = krylov

        # state-independent sparsity: the flattened assembler connectivity
        conn = self.asm64.cat_conn                       # [nel, nloc] int32
        nel, nloc = conn.shape
        conn_h = conn.cpu().numpy().astype(np.int64)
        self._rows_h = np.broadcast_to(conn_h[:, :, None],
                                       (nel, nloc, nloc)).reshape(-1)
        self._cols_h = np.broadcast_to(conn_h[:, None, :],
                                       (nel, nloc, nloc)).reshape(-1)
        self._conn = conn.contiguous()
        # element-level BC mask: the mask gathered at the connectivity
        self._me64 = spline.mask[conn].contiguous()

        # DoF geometry for the aggregation, replicated per field: the
        # dehomogenized control net, or the Greville abscissae of the
        # field basis when DoFs are not control-point coefficients
        bnet = np.asarray(spline.bnet, dtype=np.float64)
        ncp = spline.space.fields[0].ncp
        if bnet.shape[0] == ncp:
            pts = bnet[:, :-1] / bnet[:, -1:]
        else:
            pts = np.asarray(spline.space.fields[0].greville_points(),
                             dtype=np.float64)
        self._pts_dof = np.tile(pts, (self.nf, 1))
        self._field_of = np.repeat(np.arange(self.nf), ncp)
        self._mask_h = spline.mask.cpu().numpy().astype(np.float64)

    # -- tangents -------------------------------------------------------------

    def _build(self, asm, U):
        """Masked element matrices E * me me^T at U (kernel K2's element
        mode on the card) as an ElemTangent."""
        me = self._me64.to(U.dtype)
        E = asm.element_matrices_adjoint(self.adjoint, U, me=me)
        return ElemTangent(self._conn, E, self.spline.ndof)

    # -- SA hierarchy management ----------------------------------------------

    def _ensure_sa(self, st32):
        """Lazily (re)build the preconditioner from the f32 tangent values
        on the host: MultilevelSA over the BC'd coo operator (masked values
        plus a unit diagonal on constrained DoFs), or a dense f32 inverse
        when the problem is at or below the SA coarse size."""
        if self._sa is None:
            ndof = self.spline.ndof
            vals_h = st32.vals.cpu().numpy().astype(np.float64)
            rows = np.concatenate([self._rows_h, np.arange(ndof)])
            cols = np.concatenate([self._cols_h, np.arange(ndof)])
            vals = np.concatenate([vals_h, 1.0 - self._mask_h])
            dev = self.mask32.device
            if ndof <= int(self._sa_kwargs.get("coarse_size", 800)):
                ok = (rows < ndof) & (cols < ndof)
                A = sp.csr_matrix((vals[ok], (rows[ok], cols[ok])),
                                  shape=(ndof, ndof)).toarray()
                self._sa = _DenseInverse(torch.as_tensor(
                    np.linalg.inv(A), dtype=F32, device=dev))
            else:
                self._sa = MultilevelSA.from_coo(
                    rows, cols, vals, ndof, self._pts_dof, self._mask_h,
                    field_of=self._field_of, fine_op=st32,
                    fine_mask=self.mask32, device=dev, **self._sa_kwargs)
        return self._sa

    def polish_step(self, U, rebuild=False):
        if rebuild:
            self._sa = None      # rebuilt from the new tangent values
        return super().polish_step(U, rebuild=rebuild)

    # -- linear solves --------------------------------------------------------

    def _inner_solve(self, st32, b32):
        sa = self._ensure_sa(st32)
        kry = (bicgstab_device_iters if self.krylov == "bicgstab"
               else cg_device_iters)
        x, _ = kry(lambda w: st32.apply(w, mask=self.mask32), b32,
                   self.cg_iters, M=sa, tol=self.inner_tol)
        return x

    def _mixed_solve(self, st64, st32, b64):
        """f64 flexible CG (or BiCGStab) preconditioned by the f32 SA
        cycle."""
        sa = self._ensure_sa(st32)
        kry = (bicgstab_device_iters if self.krylov == "bicgstab"
               else fcg_device_iters)
        x, _ = kry(lambda w: st64.apply(w, mask=self.mask64), b64,
                   self._polish_cg_iters, M=sa, tol=self.inner_tol)
        return x

    # -- structured-space-only APIs ---------------------------------------------

    def coarse_solver(self, **kwargs):
        raise NotImplementedError("nested iteration is not defined for "
                                  "aggregation hierarchies")

    def solve_nested(self, *a, **k):
        raise NotImplementedError("nested iteration is not defined for "
                                  "aggregation hierarchies")

    def prolong_solution(self, Uc):
        raise NotImplementedError("SANewton has no spline coarse levels")
