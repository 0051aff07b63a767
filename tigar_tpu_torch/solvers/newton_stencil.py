"""Mixed-precision stencil-multigrid Newton for tensor-product spaces
(port of tigar_tpu/solvers/newton_stencil.py: ``_masked_apply``,
``TensorProlong``, ``make_stencil_mgcg``, ``make_stencil_mgcg_mixed`` and
``StencilNewton``).

One production step: f32 adjoint-form residual (kernel K1), f32 tangent
stencil at the current state (K2), and a fixed-iteration CG
preconditioned by a geometric V-cycle whose stencil applies, residuals and
weighted-Jacobi sweeps are kernel K3.  The polish phase evaluates f64
residuals (K1 in double: native f64 on the card) and solves with f64
flexible CG (K3 in double) preconditioned by the f32 V-cycle.  The
precision model and the driver's control flow are those of the JAX
package; see its module docstring.

Prolongation/restriction (separable knot-insertion tensordots), the dense
coarse matvec, dot products and norms stay torch operations, as the JAX
package leaves them to XLA outside any hand kernel.  The Krylov loops are
plain Python loops over device work: no host synchronisation inside a
linear solve.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from .multigrid import insertion_matrix_1d
from ..ops.stencil import build_stencil, stencil_to_dense
from ..ops.assembly import apply_bc_matrix

F32 = torch.float32


def _masked_apply(st, mask, W):
    """BC'd level action: zeroRowsColumns semantics, unit diagonal."""
    return st.apply(W, mask=mask)


def _equal_order_basis(spline):
    basis = spline.space.fields[0]
    for f in spline.space.fields:
        if f is not basis:
            raise ValueError("StencilNewton requires an equal-order space")
    return basis


def _grid_prolong(Ps, x, nf, shape_c):
    """Per-field separable tensor application of per-direction matrices
    Ps (slowest direction first, each [n_out, n_in])."""
    grid = x.reshape((nf,) + tuple(shape_c))
    for d, P in enumerate(Ps):
        grid = torch.movedim(torch.tensordot(P, grid, dims=([1], [d + 1])),
                             0, d + 1)
    return grid.reshape(-1)


class TensorProlong:
    """Separable knot-insertion prolongation between two nested
    tensor-product levels: ``up`` maps coarse coefficients to fine,
    ``down`` is the exact transpose (restriction)."""

    def __init__(self, Ps, nf, shape_f, shape_c):
        self.Ps = tuple(Ps)          # per-direction [n_f, n_c], slowest 1st
        self.PTs = tuple(P.T.contiguous() for P in self.Ps)
        self.nf = int(nf)
        self.shape_f = tuple(int(n) for n in shape_f)
        self.shape_c = tuple(int(n) for n in shape_c)

    def up(self, xc):
        return _grid_prolong(self.Ps, xc, self.nf, self.shape_c)

    def down(self, rf):
        return _grid_prolong(self.PTs, rf, self.nf, self.shape_f)


def _safe_div(num, den):
    """num / den where den != 0, else 0 (device scalars, no sync)."""
    return torch.where(den != 0.0, num / den, torch.zeros_like(num))


def _vcycle_fn(nlev, n_smooth, omega):
    """The V-cycle over level operators (shared by the f32 and the mixed
    solvers).  A level operator is a StencilOperator or a multi-patch
    operator; both expose ``apply(x, mask, b, dinv, omega, mode)``, and an
    operator with dense interface inverses adds its multiplicative Schwarz
    correction (``schwarz``) after the Jacobi sweeps."""

    def smooth(sts, masks, dinvs, l, b, x=None):
        op = sts[l]
        if x is None:
            # first sweep from a zero guess: x = omega D^-1 b exactly
            x = (omega * dinvs[l]) * b
            sweeps = n_smooth - 1
        else:
            sweeps = n_smooth
        for _ in range(sweeps):
            x = op.apply(x, mask=masks[l], b=b, dinv=dinvs[l], omega=omega,
                         mode="jacobi")
        if getattr(op, "has_schwarz", False):
            x = x + op.schwarz(op.apply(x, mask=masks[l], b=b,
                                        mode="residual"), masks[l])
        return x

    def vcycle(sts, masks, dinvs, Ps, coarse_inv, l, b):
        if l == nlev - 1:
            # full-f32 coarse product (TF32 is off: tigar_tpu_torch.config)
            return torch.matmul(coarse_inv, b)
        x = smooth(sts, masks, dinvs, l, b)
        r = sts[l].apply(x, mask=masks[l], b=b, mode="residual")
        rc = masks[l + 1] * Ps[l].down(r)
        ec = vcycle(sts, masks, dinvs, Ps, coarse_inv, l + 1, rc)
        x = x + masks[l] * Ps[l].up(ec)
        return smooth(sts, masks, dinvs, l, b, x)

    return vcycle


def make_stencil_mgcg(nlev, n_smooth=2, omega=0.7, n_iters=15):
    """Fixed-iteration MG-preconditioned CG over stencil level operators:
    ``solve(sts, masks, dinvs, Ps, coarse_inv, b)`` (fine level first)."""
    vcycle = _vcycle_fn(nlev, n_smooth, omega)

    def solve(sts, masks, dinvs, Ps, coarse_inv, b):
        def M(r):
            return vcycle(sts, masks, dinvs, Ps, coarse_inv, 0, r)

        x = torch.zeros_like(b)
        r = b
        z = M(r)
        rz = torch.dot(r, z)
        p = z
        for _ in range(n_iters):
            Ap = _masked_apply(sts[0], masks[0], p)
            pAp = torch.dot(p, Ap)
            alpha = _safe_div(rz, pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = torch.dot(r, z)
            beta = _safe_div(rz_new, rz)
            p = z + beta * p
            rz = rz_new
        return x

    return solve


def make_stencil_mgcg_mixed(nlev, n_smooth=2, omega=0.7, n_iters=30):
    """Mixed-precision flexible CG: f64 recurrences and f64 stencil
    operator, the f32 V-cycle as preconditioner, Polak-Ribiere beta
    clipped at 0 (the f32 V-cycle is a slightly different map every call).
    ``solve(st64, mask64, sts32, masks, dinvs, Ps, coarse_inv, b64)``."""
    vcycle = _vcycle_fn(nlev, n_smooth, omega)

    def solve(st64, mask64, sts32, masks, dinvs, Ps, coarse_inv, b64):
        def M(r):
            z32 = vcycle(sts32, masks, dinvs, Ps, coarse_inv, 0, r.to(F32))
            return z32.to(b64.dtype)

        x = torch.zeros_like(b64)
        r = b64
        z = M(r)
        rz = torch.dot(r, z)
        p = z
        for _ in range(n_iters):
            Ap = _masked_apply(st64, mask64, p)
            pAp = torch.dot(p, Ap)
            alpha = _safe_div(rz, pAp)
            x = x + alpha * p
            r_new = r - alpha * Ap
            z = M(r_new)
            rz_new = torch.dot(r_new, z)
            beta = _safe_div(torch.dot(r_new - r, z), rz)
            beta = torch.clamp(beta, min=0.0)
            p = z + beta * p
            r, rz = r_new, rz_new
        return x

    return solve


class StencilNewton:
    """Newton driver over one ExtractedSpline (see module docstring).

    Parameters
    ----------
    spline       : fine ExtractedSpline (dtype f64 for the polish phase)
    adjoint_res  : adjoint-jet residual density adj(ctx, u) -> Jet, loads
                   included (models.shell.SVKShellAdjoint on CUDA)
    mg_splines   : coarser nested ExtractedSplines [next-coarser, ...,
                   coarsest] (at least one)
    cg_iters     : inner MG-CG iterations per production Newton step
    n_smooth, omega : V-cycle weighted-Jacobi smoothing
    polish_cg_iters : f64 flexible-CG iterations per polish step
    polish_tangent  : "f64" (rebuild the polish operator in f64) or
                      "cast" (the f32-assembled stencil cast to f64)
    build_quad_degree : quadrature degree of the tangent builds (None = the
                        spline's own rule)
    rebuild_rel  : polish stencils are rebuilt while rel |r| > rebuild_rel
    """

    def __init__(self, spline, adjoint_res, mg_splines=(), cg_iters=15,
                 n_smooth=2, omega=0.7, polish_cg_iters=30,
                 polish_tangent="f64", build_quad_degree=None,
                 rebuild_rel=1e-5):
        self.spline = spline
        self.adjoint = adjoint_res
        self.cg_iters = int(cg_iters)
        self.asm64 = spline._assembler("dx")
        self.asm32 = self.asm64.astype(F32)
        self._build_quad_degree = build_quad_degree
        asm64_b = (self.asm64 if build_quad_degree is None
                   else spline._assembler("dx",
                                          quad_degree=build_quad_degree))
        self.asm_b64 = asm64_b
        self.asm_b32 = asm64_b.astype(F32)
        self.mask64 = spline.mask
        self.mask32 = spline.mask.to(F32)
        self.basis = _equal_order_basis(spline)
        self.nf = spline.space.nfields
        self.mg_splines = list(mg_splines)
        if not self.mg_splines:
            raise ValueError("StencilNewton requires at least one coarser "
                             "spline in mg_splines")
        self._n_smooth = int(n_smooth)
        self._omega = float(omega)
        self._polish_cg_iters = int(polish_cg_iters)
        self.polish_tangent = str(polish_tangent)
        self.rebuild_rel = float(rebuild_rel)
        dev = spline.mask.device

        # -- multigrid ladder ------------------------------------------------
        all_bases = [self.basis] + [_equal_order_basis(s)
                                    for s in self.mg_splines]
        grid_shapes = [tuple(kv.ncp for kv in reversed(b.kvs))
                       for b in all_bases]
        nlev = len(grid_shapes)
        self._mgcg = make_stencil_mgcg(nlev, n_smooth=n_smooth,
                                       omega=omega, n_iters=self.cg_iters)
        self._mgcg_mixed = make_stencil_mgcg_mixed(
            nlev, n_smooth=n_smooth, omega=omega,
            n_iters=int(polish_cg_iters))
        self._Ps = tuple(
            TensorProlong(
                tuple(torch.as_tensor(insertion_matrix_1d(kc, kf),
                                      dtype=F32, device=dev)
                      for kc, kf in zip(reversed(bc.kvs),
                                        reversed(bf.kvs))),
                self.nf, grid_shapes[i], grid_shapes[i + 1])
            for i, (bf, bc) in enumerate(zip(all_bases[:-1],
                                             all_bases[1:])))

        # coarse stencils: built once at the zero state, in f32
        coarse_sts, diags, masks = [], [], []
        dense_inv = None
        for i, spl in enumerate(self.mg_splines):
            b_c = _equal_order_basis(spl)
            asm_c = spl._assembler("dx").astype(F32)
            m_c = spl.mask.to(F32)
            st = build_stencil(asm_c, self.adjoint,
                               torch.zeros(spl.ndof, dtype=F32, device=dev),
                               b_c, self.nf)
            d = st.diagonal()
            d = m_c * d + (1.0 - m_c)
            coarse_sts.append(st)
            diags.append(1.0 / d)
            masks.append(m_c)
            if i == len(self.mg_splines) - 1:
                A = torch.as_tensor(stencil_to_dense(st))
                A = apply_bc_matrix(A, m_c.cpu()).numpy()
                dense_inv = torch.as_tensor(np.linalg.inv(A), dtype=F32,
                                            device=dev)
        self._coarse_sts = tuple(coarse_sts)
        self._coarse_dinvs = tuple(diags)
        self._coarse_masks = tuple(masks)
        self._coarse_inv = dense_inv
        self._st64 = None   # frozen f64 stencil for the polish phase
        # fine-level Jacobi damping scale (the multi-patch solver sets it
        # per f32 tangent build; 1.0 leaves single-patch solves unchanged)
        self._fine_omega_scale = 1.0

    # -- device programs -------------------------------------------------------

    def _res(self, asm, mask, U):
        return mask * asm.residual_vector_adjoint(self.adjoint, U)

    def _build(self, asm, U):
        return build_stencil(asm, self.adjoint, U, self.basis, self.nf)

    # -- inner solves ----------------------------------------------------------

    def _fine_dinv(self, st32):
        d = st32.diagonal()
        d = self.mask32 * d + (1.0 - self.mask32)
        dinv = torch.where(d != 0.0, 1.0 / d, torch.ones_like(d))
        if self._fine_omega_scale != 1.0:
            dinv = self._fine_omega_scale * dinv
        return dinv

    def _inner_solve(self, st32, b32):
        sts = (st32,) + self._coarse_sts
        masks = (self.mask32,) + self._coarse_masks
        dinvs = (self._fine_dinv(st32),) + self._coarse_dinvs
        return self._mgcg(sts, masks, dinvs, self._Ps, self._coarse_inv,
                          b32)

    def _mixed_solve(self, st64, st32, b64):
        """f64 flexible CG preconditioned by the f32 V-cycle."""
        sts = (st32,) + self._coarse_sts
        masks = (self.mask32,) + self._coarse_masks
        dinvs = (self._fine_dinv(st32),) + self._coarse_dinvs
        return self._mgcg_mixed(st64, self.mask64, sts, masks, dinvs,
                                self._Ps, self._coarse_inv, b64)

    # -- Newton steps ----------------------------------------------------------

    def step(self, U):
        """One PRODUCTION Newton step (all-f32 linear algebra): returns
        (U_new, |r| as a device scalar, dU)."""
        U32 = U.to(F32)
        r = self._res(self.asm32, self.mask32, U32)
        st = self._build(self.asm_b32, U32)
        dU = self._inner_solve(st, r).to(U.dtype)
        return U - dU, torch.linalg.norm(r), dU

    def res_norm(self, U, f64=False):
        """|r(U)| in the requested working precision."""
        if f64:
            return float(torch.linalg.norm(
                self._res(self.asm64, self.mask64, U)))
        return float(torch.linalg.norm(self._res(
            self.asm32, self.mask32, U.to(F32))))

    def polish_step(self, U, rebuild=False):
        """One POLISH step: f64 residual, f64 flexible CG with the f32
        V-cycle preconditioner.  ``rebuild`` refreshes both stencils at U.
        Returns (U_new, |r64| before the step, dU)."""
        r64 = self._res(self.asm64, self.mask64, U)
        if self._st64 is None or rebuild:
            U32 = U.to(F32)
            self._st32_frozen = self._build(self.asm_b32, U32)
            if self.polish_tangent == "f64":
                self._st64 = self._build(self.asm_b64, U)
            else:
                self._st64 = self._st32_frozen.astype(U.dtype)
        dU = self._mixed_solve(self._st64, self._st32_frozen, r64)
        return U - dU, torch.linalg.norm(r64), dU

    def true_rel_residual(self, U):
        """f64 residual norm at U."""
        return float(torch.linalg.norm(self._res(self.asm64, self.mask64, U)))

    def solve(self, U0=None, rtol=1e-10, switch_rel=3e-5, max_iters=40,
              log=None, overshoot_reject=1e3, start_polish=False):
        """Full mixed-precision Newton solve: f32 production steps until
        the relative residual reaches ``switch_rel`` or stops halving, then
        f64-residual polish steps until ``rtol`` or the f64 evaluation
        floor (stagnation with a collapsed increment).  Returns
        (U, rel_f64, n_steps, dU_rel).  The control flow (one-step-late
        f32 readings, overshoot rollback, polish backtracking, the switch
        at the first stall) is that of tigar_tpu's StencilNewton.solve;
        see its docstring.  ``start_polish`` begins in the f64 polish
        phase (no f32 production steps)."""
        U = (torch.zeros(self.spline.ndof, dtype=self.spline.dtype,
                         device=self.mask64.device)
             if U0 is None else U0)
        r0 = None
        prev_rel = np.inf
        phase64 = bool(start_polish)
        polish_its = 0
        stalls = 0
        dU_rel = np.inf
        U_good = U        # input of the last f32 step with an acceptable
        #                   MEASURED residual (see overshoot_reject)
        U_in_prev = U     # input of the previous POLISH step
        dU_prev = None    # its increment (for catastrophic backtracking)
        halvings = 0
        for it in range(max_iters):
            _t_it = _time.time()
            if phase64:
                rebuild = polish_its == 0 or prev_rel > self.rebuild_rel
                U_in = U
                U, rn, dU = self.polish_step(U, rebuild=rebuild)
                polish_its += 1
                un = float(torch.linalg.norm(U))
                dUn = float(torch.linalg.norm(dU))
                dU_rel = dUn / un if un > 0 else dUn
            else:
                U_in = U
                U, rn, _dU = self.step(U)
            rn = float(rn)
            if r0 is None:
                r0 = rn
            rel = rn / r0
            if (phase64 and polish_its >= 3 and halvings < 12
                    and np.isfinite(prev_rel)
                    and rel > 10.0 * prev_rel and dU_prev is not None):
                # catastrophic polish overshoot (read one step late):
                # discard this step, halve the previous increment
                dU_prev = 0.5 * dU_prev
                U = U_in_prev - dU_prev
                halvings += 1
                if log:
                    log(f"  newton it {it} (f64): rel |r| = {rel:.3e} "
                        f"BACKTRACK (>10x growth); previous step halved "
                        f"({halvings})")
                continue
            if phase64:
                U_in_prev = U_in
                dU_prev = dU
                if rel < prev_rel:
                    halvings = 0
            if (not phase64 and it > 0
                    and rel > float(overshoot_reject) * prev_rel):
                # rn was measured at this step's INPUT: roll back to the
                # input of the previous iteration and polish from there
                if log:
                    log(f"  newton it {it} (f32): rel |r| = {rel:.3e} "
                        f"REJECTED (>{overshoot_reject:g}x blowup); "
                        "f64 polish resumes from the last good state")
                U = U_good
                phase64 = True
                continue
            if not phase64:
                U_good = U_in
            if log:
                log(f"  newton it {it} ({'f64' if phase64 else 'f32'}): "
                    f"rel |r| = {rel:.3e}"
                    + (f", |dU|/|U| = {dU_rel:.2e}" if phase64 else "")
                    + f"  [{_time.time() - _t_it:.2f}s]")
            if phase64:
                if rel <= rtol:
                    return U, rel, it + 1, dU_rel
                # the f64 evaluation floor: no contraction AND a collapsed
                # Newton increment
                stalls = stalls + 1 if rel > 0.9 * prev_rel else 0
                if polish_its > 1 and dU_rel < 1e-6 and (
                        stalls >= 3
                        or (rel > 0.5 * prev_rel and dU_rel < 1e-9)):
                    return U, rel, it + 1, dU_rel
            elif rel <= switch_rel or (it > 0 and rel > 0.7 * prev_rel):
                # f32 stopped halving: switch to the polish phase at the
                # first stall
                phase64 = True
            prev_rel = rel
        return U, prev_rel, max_iters, dU_rel
