"""ExtractedSpline: the analysis object (port of
tigar_tpu/models/extracted.py: construction, the volume assemblers, the
generic form path with its linear solvers, the nonlinear (Newton) solve,
projections, geometry evaluation and the L2 error norm).

Construction tabulates the field bases and the control basis on the shared
Bezier-element grid (host numpy), evaluates the geometry at all quadrature
points on ``device`` in ``dtype``, and builds the volume assembler.
Dirichlet BCs are a mask (zeroRowsColumns semantics, with the ``diag``
knob).  Assemblers for other quadrature rules (``_assembler(domain,
quad_degree)``) are cached; ctx hooks (e.g. the shell reference frame) run
on every new assembler.

Forms are PyTorch densities evaluated at ONE quadrature point, as in the
JAX package:
    residual/bilinear: density(ctx, u, v[, params])   (linear in v)
    linear:            density(ctx, v[, params])
    functional:        density(ctx, u[, params])
with ctx a forms.QP and u/v forms.Jet trees; ``U`` may be a DoF vector or
a dict of vectors (the unknown under "u", auxiliary known fields beside
it).  A form is a density ("dx") or a dict {"dx": density or
term(density, quad_degree=..., where=...)}; the boundary measures ("ds",
("ds", dir, side), "dB") are not ported yet.

Linear solvers (``set_solver_options(linear_solver=...)``; by default
"direct" up to ``dense_threshold`` DoFs, else "cg"): "direct" (dense LU
in f64 on the device), "cg" / "bicgstab" (Jacobi-preconditioned, the f64
AD tangent action, residual read on the host every 25 iterations),
"sparse_cg" / "sparse_bicgstab" (the assembled tangent as a torch sparse
CSR matrix), "mg_cg" (CG of the AD tangent action, preconditioned by a
geometric V-cycle over ``[self] + mg_levels``, optionally in ``mg_dtype``)
and "sa_cg" (CG on the sparse matrix, preconditioned by smoothed
aggregation: TwoLevelSA, or MultilevelSA for sa_levels > 2).
``solve_nonlinear_variational_problem`` runs solvers/newton.newton_solve
with these linear solves (``max_iters``, ``relative_tolerance``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (DEFAULT_MAX_ITERS, DEFAULT_REAL_TYPE,
                      DEFAULT_RELATIVE_TOLERANCE, resolve_device)
from ..forms import tree_jvp
from ..ops.quadrature import npoints_for_degree
from ..ops.geometry import precompute_geometry
from ..ops.assembly import DomainAssembler, apply_bc_matrix, scatter_bcoo
from ..solvers.linear import (KRYLOV_STEPS, jacobi_preconditioner,
                              solve_dense, solve_krylov)
from ..solvers.newton import newton_solve

DEFAULT_DENSE_THRESHOLD = 4096

# the accelerator Krylov branch reads the residual every KRYLOV_CHECK
# iterations (tigar_tpu/models/extracted.py:756)
KRYLOV_CHECK = 25


class FormTerm:
    """One term of a form with per-term measure options: ``density``, a
    per-term ``quad_degree`` and an optional subdomain predicate ``where``
    fn(ctx) -> bool at quadrature points (the term is integrated only
    where it holds)."""

    __slots__ = ("density", "quad_degree", "where")

    def __init__(self, density, quad_degree=None, where=None):
        self.density = density
        self.quad_degree = None if quad_degree is None else int(quad_degree)
        self.where = where


def term(density, quad_degree=None, where=None):
    """Wrap a density with per-term measure options; use as a form-dict
    value: {"dx": term(f, quad_degree=8, where=p)}."""
    return FormTerm(density, quad_degree=quad_degree, where=where)


def _get_unknown(U):
    return U["u"] if isinstance(U, dict) else U


def _set_unknown(U, arr):
    if isinstance(U, dict):
        out = dict(U)
        out["u"] = arr
        return out
    return arr


def _cast_tree(tree, dtype):
    """``tree`` with every floating tensor leaf cast to ``dtype``."""
    return torch.utils._pytree.tree_map(
        lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
        and x.is_floating_point() else x, tree)


def _params_key(params):
    """Hashable key of a params tree's structure and VALUES: a later solve
    with other params rebuilds what was cached for the earlier ones."""
    if params is None:
        return None
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    return (str(spec), tuple(
        tuple(x.detach().double().cpu().reshape(-1).tolist())
        if isinstance(x, torch.Tensor) else x for x in leaves))


class ExtractedSpline:
    """Analysis object over a SplineSpace.

    Parameters
    ----------
    space       : SplineSpace
    quad_degree : polynomial degree integrated exactly per direction
    nders       : derivative order to tabulate (2 for hess/lap and shells)
    geom_nders  : derivative order for the geometry (defaults to nders)
    device, dtype : where and in which precision the assembler tensors live
                  (the card unless the caller asks for ``"cpu"``)
    """

    def __init__(self, space, quad_degree, nders=1, geom_nders=None,
                 device="cuda", dtype=DEFAULT_REAL_TYPE):
        self.device = resolve_device(device)
        self.space = space
        self.quad_degree = int(quad_degree)
        self.npts = npoints_for_degree(quad_degree)
        self.nders = int(nders)
        self.geom_nders = self.nders if geom_nders is None else int(geom_nders)
        self.dtype = dtype

        self.control_basis = space.control_mesh.scalar_basis()
        self.bnet = np.asarray(space.control_mesh.homogeneous_points(),
                               dtype=np.float64)
        self.nsd = space.nsd
        self.dim = self.control_basis.dim
        self.ndof = space.ndof

        self._tab_cache = {}
        self._assemblers = {}
        self._ctx_hooks = []   # fns(domain, asm) run on new assemblers
        self._where_cache = {}
        self.mask = torch.as_tensor(space.bc_mask(), dtype=dtype,
                                    device=self.device)

        # solver options (set_solver_options)
        self.max_iters = DEFAULT_MAX_ITERS
        self.relative_tolerance = DEFAULT_RELATIVE_TOLERANCE
        self.linear_solver = None       # None = direct if small, else cg
        self.linear_tol = 1e-12
        self.linear_max_iter = None
        self.dense_threshold = DEFAULT_DENSE_THRESHOLD
        self.mg_levels = None           # coarser splines for "mg_cg"
        self.mg_smooth = 2
        self.mg_omega = 0.7
        self.mg_dtype = None            # the V-cycle's precision
        self._mg_cache = {}
        self.sa_coarsen = 3.0
        self.sa_smooth = 2
        self.sa_omega_P = 0.66
        self.sa_levels = 2
        self.sa_coarse_size = 800
        self.sa_near_kernel = "linear"
        self.sa_cycle = "V"
        self._sa_cache = {}
        self._cast_cache = {}           # (id, dtype) -> cast assembler/mask
        # what the last linear solve reported: method, and for the Krylov
        # methods the iterations and the final |r| / |b|
        self.last_linear_solve = {}

        self._assembler("dx")

    # -- options --------------------------------------------------------------

    def set_solver_options(self, max_iters=None, relative_tolerance=None,
                           linear_solver=None, linear_tol=None,
                           linear_max_iter=None, dense_threshold=None,
                           mg_levels=None, mg_smooth=None, mg_omega=None,
                           mg_dtype=None, sa_coarsen=None, sa_smooth=None,
                           sa_omega_P=None, sa_levels=None,
                           sa_coarse_size=None, sa_near_kernel=None,
                           sa_cycle=None):
        """The options of tigar_tpu's ``set_solver_options``: Newton's
        ``max_iters`` and ``relative_tolerance``, the linear solver and its
        tolerance, the mg_cg hierarchy (``mg_levels``: coarser
        ExtractedSplines of the same problem with nested knots) and its
        smoothing and precision, and the SA options.  A new ``mg_levels``
        or ``mg_dtype`` drops the cached V-cycles, an SA option the cached
        SA preconditioners."""
        if max_iters is not None:
            self.max_iters = max_iters
        if relative_tolerance is not None:
            self.relative_tolerance = relative_tolerance
        if mg_levels is not None:
            self.mg_levels = list(mg_levels)
            self._mg_cache = {}
        if mg_smooth is not None:
            self.mg_smooth = int(mg_smooth)
        if mg_omega is not None:
            self.mg_omega = float(mg_omega)
        if mg_dtype is not None:
            self.mg_dtype = mg_dtype
            self._mg_cache = {}
        if linear_solver is not None:
            self.linear_solver = linear_solver
        if linear_tol is not None:
            self.linear_tol = linear_tol
        if linear_max_iter is not None:
            self.linear_max_iter = linear_max_iter
        if dense_threshold is not None:
            self.dense_threshold = dense_threshold
        sa = dict(sa_coarsen=(sa_coarsen, float), sa_smooth=(sa_smooth, int),
                  sa_omega_P=(sa_omega_P, float), sa_levels=(sa_levels, int),
                  sa_coarse_size=(sa_coarse_size, int),
                  sa_near_kernel=(sa_near_kernel, str),
                  sa_cycle=(sa_cycle, lambda c: str(c).upper()))
        for name, (val, conv) in sa.items():
            if val is not None:
                setattr(self, name, conv(val))
                self._sa_cache = {}

    # -- tabulation / assembler construction ----------------------------------

    @property
    def geometry(self):
        """QP at volume quadrature points, leaves [nel, nq, ...]."""
        return self._assembler("dx").ctx

    def _field_tab(self, basis, domain, nders=None, npts=None):
        nders = self.nders if nders is None else nders
        npts = self.npts if npts is None else npts
        if domain != "dx":
            raise NotImplementedError(
                f"measure {domain!r}: boundary assembly is not ported yet")
        key = (id(basis), domain, nders, npts)
        if key not in self._tab_cache:
            self._tab_cache[key] = basis.tabulate(npts, nders)
        return self._tab_cache[key]

    def _assembler(self, domain, quad_degree=None) -> DomainAssembler:
        npts = self.npts if quad_degree is None else \
            npoints_for_degree(quad_degree)
        akey = (domain, npts)
        if akey not in self._assemblers:
            self._assemblers[akey] = self._build_assembler(domain, npts)
        return self._assemblers[akey]

    def _build_assembler(self, domain, npts) -> DomainAssembler:
        ctrl_tab = self._field_tab(self.control_basis, domain,
                                   nders=self.geom_nders, npts=npts)
        geom = precompute_geometry(ctrl_tab, self.bnet, self.device,
                                   self.dtype)
        qw = torch.as_tensor(ctrl_tab.qw, dtype=self.dtype,
                             device=self.device)
        scale = qw * geom.sqrtJ
        tabs = [self._field_tab(f, domain, npts=npts)
                for f in self.space.fields]
        asm = DomainAssembler(tabs, self.space.offsets, self.ndof, geom,
                              scale)
        for hook in self._ctx_hooks:
            hook(domain, asm)
        return asm

    def _terms(self, form):
        """[(domain, FormTerm)] of a form: a bare density is a volume term;
        a dict maps "dx" to a density or a FormTerm."""
        if callable(form):
            return [("dx", FormTerm(form))]
        terms = []
        for key, val in form.items():
            if key != "dx":
                raise NotImplementedError(
                    f"measure {key!r}: only 'dx' terms are ported; the "
                    "boundary measures come with the boundary assemblers")
            terms.append((key, val if isinstance(val, FormTerm)
                          else FormTerm(val)))
        return terms

    def _masked_density(self, t: FormTerm):
        """Stable (cached) density with the subdomain predicate folded in
        (the SA cache is keyed by density identity)."""
        if t.where is None:
            return t.density
        wkey = (id(t.density), id(t.where))
        entry = self._where_cache.get(wkey)
        if entry is None:
            density, where = t.density, t.where

            def wrapped(ctx, *args):
                out = density(ctx, *args)
                ind = torch.as_tensor(where(ctx), device=out.device)
                return ind.to(out.dtype) * out

            entry = (wrapped, density, where)  # keep refs alive (id keys)
            self._where_cache[wkey] = entry
        return entry[0]

    def _form_key(self, form):
        """(hashable key, terms, [(assembler, density)])."""
        terms = self._terms(form)
        key = tuple((str(d), id(t.density), t.quad_degree,
                     None if t.where is None else id(t.where))
                    for d, t in terms)
        pairs = [(self._assembler(d, t.quad_degree), self._masked_density(t))
                 for d, t in terms]
        return key, terms, pairs

    def _zeros(self):
        return torch.zeros(self.ndof, dtype=self.dtype, device=self.device)

    # -- assembly -------------------------------------------------------------

    def assemble_functional(self, form, U=None, params=None):
        """Integral of a scalar density over the domain."""
        _, _, pairs = self._form_key(form)
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for asm, dens in pairs:
            total = total + asm.functional(dens, U, params)
        return total

    def assemble_vector(self, form, U=None, apply_bcs=True, params=None):
        """Assemble a linear form L(ctx, v) (U=None) or the residual
        res(ctx, u, v) at state U."""
        _, _, pairs = self._form_key(form)
        b = self._zeros()
        for asm, dens in pairs:
            if U is None:
                b = b + asm.linear_vector(dens, params=params)
            else:
                b = b + asm.residual_vector(dens, U, params=params)
        return b * self.mask if apply_bcs else b

    def _action(self, pairs, U, mask, apply_bcs, diag, params):
        """W -> dR/du(U) W (the JVP of the assembled residual), BC'd with
        unit-``diag`` rows at the constrained DoFs when ``apply_bcs``."""
        Uu = _get_unknown(U)

        def action(W):
            W_in = mask * W if apply_bcs else W
            out = torch.zeros_like(W)
            for asm, dens in pairs:
                def r_of(a, asm=asm, dens=dens):
                    return asm.residual_vector(dens, _set_unknown(U, a),
                                               params=params)
                out = out + tree_jvp(r_of, Uu, W_in)[1]
            if apply_bcs:
                out = mask * out + diag * (1.0 - mask) * W
            return out
        return action

    def _cast(self, key, obj, dtype):
        """``obj`` (an assembler or the mask) cast to ``dtype``, cached per
        (key, dtype): the mixed-precision paths reuse one copy."""
        ckey = (key, dtype)
        hit = self._cast_cache.get(ckey)
        if hit is None:
            hit = (obj.astype(dtype) if isinstance(obj, DomainAssembler)
                   else obj.to(dtype), obj)   # keep the source (id key)
            self._cast_cache[ckey] = hit
        return hit[0]

    def tangent_action(self, form, U, W, apply_bcs=True, diag=1.0,
                       params=None, dtype=None):
        """Action of the tangent dR/d(unknown) at U on W (matrix-free).
        ``dtype`` is the compute precision (e.g. float32 V-cycles inside a
        float64 CG: the ``mg_dtype`` option): the assemblers, U, W, the
        mask and params are cast on the way in and the result stays in
        that type."""
        _, _, pairs = self._form_key(form)
        mask = self.mask
        if dtype is not None and dtype != self.dtype:
            pairs = [(self._cast(id(asm), asm, dtype), dens)
                     for asm, dens in pairs]
            mask = self._cast("mask", mask, dtype)
            U, W, params = _cast_tree((U, W, params), dtype)
        return self._action(pairs, U, mask, apply_bcs, diag, params)(W)

    def matrix_operator(self, form, U=None, apply_bcs=True, diag=1.0,
                        params=None):
        """Matrix-free operator W -> A W (the tangent at U)."""
        if U is None:
            U = self._zeros()
        return lambda W: self.tangent_action(form, U, W, apply_bcs=apply_bcs,
                                             diag=diag, params=params)

    def _element_matrix_sum(self, pairs, U, params, scatter):
        out = None
        for asm, dens in pairs:
            part = scatter(asm, asm.element_matrices(dens, U, params=params))
            out = part if out is None else out + part
        return out

    def assemble_matrix(self, form, U=None, apply_bcs=True, diag=1.0,
                        params=None):
        """Dense tangent / bilinear matrix (zeroRowsColumns with ``diag``
        when ``apply_bcs``)."""
        if U is None:
            U = self._zeros()
        _, _, pairs = self._form_key(form)
        A = self._element_matrix_sum(pairs, U, params,
                                     lambda asm, A_e: asm.scatter_dense(A_e))
        return apply_bc_matrix(A, self.mask, diag=diag) if apply_bcs else A

    def assemble_sparse(self, form, U=None, apply_bcs=True, diag=1.0,
                        params=None):
        """Assembled sparse tangent / bilinear matrix as a coalesced torch
        sparse COO tensor; BCs by masking the element matrices and adding
        ``diag`` at the constrained diagonal."""
        if U is None:
            U = self._zeros()
        _, _, pairs = self._form_key(form)
        M = None
        for asm, density in pairs:
            A_e = asm.element_matrices(density, U, params=params)
            if apply_bcs:
                me = self.mask[asm._cat_conn_long]
                A_e = A_e * me[:, :, None] * me[:, None, :]
            part = scatter_bcoo(asm, A_e)
            M = part if M is None else (M + part).coalesce()
        if apply_bcs:
            idx = torch.arange(self.ndof, device=self.device)
            bc = torch.sparse_coo_tensor(torch.stack([idx, idx]),
                                         diag * (1.0 - self.mask),
                                         (self.ndof, self.ndof),
                                         check_invariants=False)
            M = (M + bc).coalesce()
        return M

    def assemble_diagonal(self, form, U=None, apply_bcs=True, diag=1.0,
                          params=None):
        """Diagonal of the tangent (Jacobi preconditioner)."""
        if U is None:
            U = self._zeros()
        _, _, pairs = self._form_key(form)
        d = self._element_matrix_sum(pairs, U, params,
                                     lambda asm, A_e: asm.scatter_diag(A_e))
        return self.mask * d + diag * (1.0 - self.mask) if apply_bcs else d

    def assemble_linear_system(self, lhs_form, rhs_form, apply_bcs=True,
                               params=None):
        """(A, b) for a bilinear lhs and a linear rhs."""
        A = self.assemble_matrix(lhs_form, apply_bcs=apply_bcs, params=params)
        b = self.assemble_vector(rhs_form, apply_bcs=apply_bcs, params=params)
        return A, b

    # -- linear solves --------------------------------------------------------

    def _linear_method(self):
        method = self.linear_solver
        if method is None:
            method = "direct" if self.ndof <= self.dense_threshold else "cg"
        return method

    def _sa_preconditioner(self, form, U, params, apply_bcs):
        """The SA preconditioner and sparse tangent of ``form``, cached per
        (form, apply_bcs) and params values (built at the first call's
        state, as the JAX package does)."""
        from ..solvers.aggregation import MultilevelSA, TwoLevelSA
        fkey, _, _ = self._form_key(form)
        pkey = _params_key(params)
        cached = self._sa_cache.get((fkey, apply_bcs))
        if cached is not None and cached[0] == pkey:
            return cached[1]
        if self.sa_levels > 2:
            built = MultilevelSA.from_spline(
                self, form, U=U, params=params, coarsen=self.sa_coarsen,
                omega_P=self.sa_omega_P, n_smooth=self.sa_smooth,
                apply_bcs=apply_bcs, coarse_size=self.sa_coarse_size,
                max_levels=self.sa_levels - 1,
                near_kernel=self.sa_near_kernel, cycle=self.sa_cycle)
        else:
            built = TwoLevelSA.from_spline(
                self, form, U=U, params=params, coarsen=self.sa_coarsen,
                omega_P=self.sa_omega_P, n_smooth=self.sa_smooth,
                apply_bcs=apply_bcs)
        self._sa_cache[(fkey, apply_bcs)] = (pkey, built)
        return built

    def _mg_preconditioner(self, form, params):
        """The V-cycle over ``[self] + mg_levels`` for ``form``, cached per
        form and params values (its level operators are the tangents at
        the zero state, exact for linear problems)."""
        from ..solvers.multigrid import Multigrid
        if not self.mg_levels:
            raise ValueError('linear_solver="mg_cg" requires '
                             "set_solver_options(mg_levels=[...])")
        fkey, _, _ = self._form_key(form)
        pkey = _params_key(params)
        cached = self._mg_cache.get(fkey)
        if cached is not None and cached[0] == pkey:
            return cached[1]
        mg = Multigrid([self] + self.mg_levels, form, params=params,
                       n_smooth=self.mg_smooth, omega=self.mg_omega,
                       dtype=self.mg_dtype)
        self._mg_cache[fkey] = (pkey, mg)
        return mg

    def _solve_linearized(self, form, U, rhs, params=None, apply_bcs=True):
        """Solve J(U) x = rhs with the configured linear solver; with
        ``apply_bcs`` the operator has unit diagonal rows at the
        constrained DoFs."""
        method = self._linear_method()
        info = {"method": method}
        self.last_linear_solve = info
        if method == "direct":
            A = self.assemble_matrix(form, U=U, params=params,
                                     apply_bcs=apply_bcs)
            return solve_dense(A, rhs)

        if method == "mg_cg":
            mg = self._mg_preconditioner(form, params)
            if self.mg_dtype is not None and self.mg_dtype != self.dtype:
                # the reduced-precision V-cycle inside the f64 CG
                mg_dt, out_dt = self.mg_dtype, self.dtype

                def M(r):
                    return mg(r.to(mg_dt)).to(out_dt)
            else:
                M = mg
            action = self.matrix_operator(form, U=U, apply_bcs=apply_bcs,
                                          params=params)
            return solve_krylov(action, rhs, method="cg",
                                tol=self.linear_tol,
                                maxiter=self.linear_max_iter, M=M, info=info)

        if method == "sa_cg":
            pre, M_sp = self._sa_preconditioner(form, U, params, apply_bcs)
            A = M_sp.to_sparse_csr()
            return solve_krylov(lambda W: torch.mv(A, W), rhs, method="cg",
                                tol=self.linear_tol,
                                maxiter=self.linear_max_iter, M=pre,
                                info=info)

        diag = self.assemble_diagonal(form, U=U, params=params,
                                      apply_bcs=apply_bcs)
        Mpre = jacobi_preconditioner(diag)

        if method.startswith("sparse_"):
            A = self.assemble_sparse(form, U=U, params=params,
                                     apply_bcs=apply_bcs).to_sparse_csr()
            return solve_krylov(lambda W: torch.mv(A, W), rhs,
                                method=method[len("sparse_"):],
                                tol=self.linear_tol,
                                maxiter=self.linear_max_iter, M=Mpre,
                                info=info)

        if method not in KRYLOV_STEPS:
            raise ValueError(f"unknown linear solver {method!r}")
        # the JAX package's accelerator branch: blocks of KRYLOV_CHECK
        # iterations of the AD tangent action, the residual read on the
        # host between blocks
        _, _, pairs = self._form_key(form)
        action = self._action(pairs, U, self.mask, apply_bcs, 1.0, params)
        init, step = KRYLOV_STEPS[method]
        st = init(action, Mpre, rhs, None)
        bnorm = float(torch.linalg.norm(rhs))
        n = self.linear_max_iter or max(200, min(5000, 2 * self.ndof))
        it = 0
        for _ in range((int(n) + KRYLOV_CHECK - 1) // KRYLOV_CHECK):
            for _ in range(KRYLOV_CHECK):
                st = step(action, Mpre, st)
            it += KRYLOV_CHECK
            rnorm = float(torch.linalg.norm(st[1]))
            if rnorm <= self.linear_tol * bnorm:
                break
        info.update(iters=it, rel=rnorm / bnorm if bnorm else rnorm)
        return st[0]

    def solve_linear_variational_problem(self, form, rhs_form=None, U0=None,
                                         apply_bcs=True, params=None):
        """Solve a linear problem: a bilinear ``form`` with a linear
        ``rhs_form`` (a == L), or a residual ``form`` linear in u
        (rhs_form=None), by one exact Newton step from U0."""
        if U0 is None:
            U0 = self._zeros()
        if rhs_form is not None:
            b = self.assemble_vector(rhs_form, apply_bcs=apply_bcs,
                                     params=params)
            return self._solve_linearized(form, U0, b, params=params,
                                          apply_bcs=apply_bcs)
        r = self.assemble_vector(form, U=U0, apply_bcs=apply_bcs,
                                 params=params)
        dU = self._solve_linearized(form, U0, r, params=params,
                                    apply_bcs=apply_bcs)
        return _get_unknown(U0) - dU

    # -- nonlinear solve --------------------------------------------------------

    def solve_nonlinear_variational_problem(self, form, U0=None,
                                            reference_error=None, log=False,
                                            params=None):
        """Newton solve of the residual ``form`` (solvers/newton.py) with
        the configured linear solver, ``max_iters`` and
        ``relative_tolerance``.  U0 may be a vector or a dict with the
        unknown under "u" (the other fields are held fixed); returns the
        unknown."""
        if U0 is None:
            U0 = self._zeros()
        Uaux = U0 if isinstance(U0, dict) else None

        def state(u_arr):
            return u_arr if Uaux is None else _set_unknown(Uaux, u_arr)

        def residual(u_arr):
            return self.assemble_vector(form, U=state(u_arr), params=params)

        def solve_lin(u_arr, r):
            return self._solve_linearized(form, state(u_arr), r,
                                          params=params)

        u0 = _get_unknown(U0).to(self.dtype)
        u, _ = newton_solve(residual, solve_lin, u0,
                            max_iters=self.max_iters,
                            rtol=self.relative_tolerance,
                            reference_error=reference_error, log=log)
        return u

    # -- projections ----------------------------------------------------------

    def project(self, fn, rationalize=True, lump_mass=False, apply_bcs=False):
        """L2 (or lumped) projection of a pointwise function ``fn(ctx)``
        (scalar or [nfields]) onto the spline space; returns homogeneous
        DoFs."""
        def L(ctx, v):
            vv = ctx.rationalize(v) if rationalize else v
            return torch.sum(torch.as_tensor(fn(ctx)) * vv.val)

        b = self.assemble_vector(L, apply_bcs=apply_bcs)
        if lump_mass:
            def Lones(ctx, v):
                vv = ctx.rationalize(v) if rationalize else v
                return torch.sum(torch.atleast_1d(vv.val))
            return b / self.assemble_vector(Lones, apply_bcs=apply_bcs)

        def a(ctx, u, v):
            uu = ctx.rationalize(u) if rationalize else u
            vv = ctx.rationalize(v) if rationalize else v
            return torch.sum(uu.val * vv.val)

        return self._solve_linearized(a, self._zeros(), b,
                                      apply_bcs=apply_bcs)

    # fitting a pointwise function into the spline space
    fit = project

    # -- point evaluation -----------------------------------------------------

    def evaluate(self, U, xi, rationalize=True, **kwargs):
        """Evaluate the solution at parametric points ``xi`` [n, dim] (host
        numpy): [n] for a scalar space, else [n, nfields].  With
        ``rationalize``, divides by the control weight function.  Extra
        kwargs go to the basis (``patch=`` for multi-patch)."""
        if isinstance(U, torch.Tensor):
            U = U.detach().cpu().numpy()
        U = np.asarray(U)
        xi = np.atleast_2d(np.asarray(xi, dtype=float))
        vals = [self.space.fields[f].evaluate(
                    U[self.space.field_slice(f)], xi, **kwargs)
                for f in range(self.space.nfields)]
        out = np.stack(vals, axis=-1)
        if rationalize:
            w = self.control_basis.evaluate(self.bnet[:, -1], xi, **kwargs)
            out = out / w[:, None]
        return out[:, 0] if self.space.nfields == 1 else out

    def evaluate_geometry(self, xi):
        """Physical location F(xi) of parametric points [n, dim] -> [n, nsd]
        (host numpy)."""
        xi = np.atleast_2d(np.asarray(xi, dtype=float))
        H = self.control_basis.evaluate(self.bnet, xi)
        return H[:, :-1] / H[:, -1:]

    # -- norms ----------------------------------------------------------------

    def errornorm(self, U, exact_fn, rationalize=True):
        """L2 norm of (u - exact) over the domain; ``exact_fn(ctx)`` gives
        the exact value at a quadrature point."""
        def density(ctx, u):
            uu = ctx.rationalize(u) if rationalize else u
            e = uu.val - exact_fn(ctx)
            return torch.sum(e * e)
        return torch.sqrt(self.assemble_functional(density, U=U))
