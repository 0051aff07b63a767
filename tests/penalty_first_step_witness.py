"""Witness of the two-patch penalty point's first f32 Newton step: the
JAX package against the port on the CPU, quantity by quantity.

    JAX_PLATFORMS=cpu python tests/penalty_first_step_witness.py [NEL]

bench.py's two-patch point with BENCH_TP_COUPLING=penalty and the f32
phase first (default NEL=64: levels (64,128,132), (32,64,66), (16,32,33),
52,272 DoFs, pd = 1e2 E h / h_el).  It builds tigar_tpu's and the port's
MultiPatchStencilNewton and prints, as max |a - b| / max |b|:

  - the per-patch f32 stencils, interface blocks and Schwarz inverses of
    the fine build at U=0 and of every coarse level, the per-level
    damped Jacobi diagonals, the coarsest inverse and the f32 residual;
  - _lam_max_jacobi and the fine damping scale;
  - one V-cycle on identical data (tigar_tpu's own level data carried
    into the port), and each package's f32 cycle against its f64 cycle
    on the same data (its own f32 rounding);
  - the fifteen CG iterates of the first step (step lengths alpha and
    beta side by side);
  - the f64 relative residual after the first step: tigar_tpu's fused
    solver, the same tigar_tpu code as a Python loop of its jitted V-cycle
    and operator, the port's solver on tigar_tpu's data, the port alone.

Not a test (pytest does not collect it): at NEL=64 it takes minutes.
"""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

F32, F64 = torch.float32, torch.float64
E_MOD, NU, H_TH, Q = 1e7, 0.3, 0.03, 100.0


def rel(a, b):
    a, b = (np.asarray(x, dtype=np.float64) for x in (a, b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def jax_solver(nel):
    """tigar_tpu's solver as bench._two_patch_point builds it (penalty)."""
    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import TensorBSplineBasis
    from tigar_tpu.models.multipatch import (MultiPatchBSplineBasis,
                                             MultiPatchControlMesh)
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import (precompute_shell_reference,
                                        svk_shell_adjoint)
    from tigar_tpu.coupling import ShellInterfaceCoupling
    from tigar_tpu.solvers.newton_stencil_mp import MultiPatchStencilNewton

    def build(nx, nay, nby):
        basis = MultiPatchBSplineBasis([TensorBSplineBasis(
            [2, 2], [uniform_knots(2, 0.0, 1.0, nx),
                     uniform_knots(2, 0.0, 1.0, ny)]) for ny in (nay, nby)])

        def bnet(patch, x_off):
            g = patch.greville_points()
            B = np.zeros((g.shape[0], 4))
            B[:, 0], B[:, 1], B[:, 3] = g[:, 0] + x_off, 2 * g[:, 1] - 1, 1
            return B
        cm = MultiPatchControlMesh(basis, [bnet(basis.patches[0], -1.0),
                                           bnet(basis.patches[1], 0.0)])
        gen = EqualOrderSpline(3, cm)
        sides = [(0, 0, 0), (1, 0, 1)] + [(p, 1, s) for p in (0, 1)
                                          for s in (0, 1)]
        for i in range(3):
            for p, d, s in sides:
                gen.add_zero_dofs(i, basis.patch_side_dofs(p, d, s,
                                                           n_layers=2))
        return precompute_shell_reference(ExtractedSpline(gen, quad_degree=4,
                                                          nders=2))

    sizes, (nx, ay, by) = [], (nel, 2 * nel, 2 * nel + 4)
    while nx >= 16:
        sizes.append((nx, ay, by))
        nx, ay, by = nx // 2, ay // 2, by // 2
    sps = [build(*s) for s in sizes]
    cps = [ShellInterfaceCoupling(sp, 0, (0, 1), 1, (0, 0),
                                  penalty_disp=1e2 * E_MOD * H_TH * s[0],
                                  penalty_rot=1e2 * E_MOD * H_TH ** 3 * s[0])
           for sp, s in zip(sps, sizes)]

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_MOD, NU, H_TH)
        return F._replace(val=F.val.at[2].add(-Q))
    return MultiPatchStencilNewton(
        sps[0], res_adj, cps[0], mg_splines=sps[1:], mg_couplings=cps[1:],
        cg_iters=15, polish_cg_iters=40, polish_tangent="f64",
        build_quad_degree=2, rebuild_rel=0.1)


def jax_vcycle(nlev, n_smooth=2, omega=0.7):
    """tigar_tpu's V-cycle and level action, as make_stencil_mgcg writes
    them (tigar_tpu/solvers/newton_stencil.py:143-180), outside its fused
    solve."""
    def action(sts, masks, l, W):
        m = masks[l]
        return m * sts[l](m * W) + (1.0 - m) * W

    def smooth(sts, masks, dinvs, l, b, x=None):
        om_dinv = omega * dinvs[l]
        sweeps = n_smooth
        if x is None:
            x, sweeps = om_dinv * b, n_smooth - 1
        for _ in range(sweeps):
            x = x + om_dinv * (b - action(sts, masks, l, x))
        if getattr(sts[l], "has_schwarz", False):
            x = x + sts[l].schwarz(b - action(sts, masks, l, x), masks[l])
        return x

    def vcycle(sts, masks, dinvs, Ps, cinv, l, b):
        if l == nlev - 1:
            return jnp.matmul(cinv, b, precision=jax.lax.Precision.HIGHEST)
        x = smooth(sts, masks, dinvs, l, b)
        r = b - action(sts, masks, l, x)
        ec = vcycle(sts, masks, dinvs, Ps, cinv, l + 1,
                    masks[l + 1] * Ps[l].down(r))
        x = x + masks[l] * Ps[l].up(ec)
        return smooth(sts, masks, dinvs, l, b, x)
    return vcycle, action


def cg_iterates(A, M, b, dot, where, n=15):
    """The fixed-iteration PCG of make_stencil_mgcg, iterate by iterate."""
    x, r = 0.0 * b, b
    z = M(r)
    p, rz, out = z, dot(r, z), []
    for _ in range(n):
        Ap = A(p)
        alpha = where(dot(p, Ap), rz)
        x, r = x + alpha * p, r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = where(rz, rz_new)
        p, rz = z + beta * p, rz_new
        out.append((np.asarray(x), float(alpha), float(beta)))
    return out


def main(nel):
    import chip_smoke as cs
    from tigar_tpu.solvers.newton_stencil_mp import (
        _lam_max_jacobi as jlam)
    from tigar_tpu_torch import convert
    from tigar_tpu_torch.solvers import newton_stencil_mp as tmp
    from tigar_tpu_torch.solvers.newton_stencil import (
        _vcycle_fn, _masked_apply, make_stencil_mgcg)
    torch.set_num_threads(4)
    t0 = time.time()
    nj = jax_solver(nel)
    nt, _, sizes = cs.build_two_patch("cpu", nel=nel)
    print(f"levels {sizes}, setup {time.time() - t0:.1f} s", flush=True)

    def cmp_op(tag, oj, ot):
        aj, at = convert.mp_operator_arrays(oj), convert.mp_operator_arrays(ot)
        for key in ("S", "K", "Sinv"):
            errs = [rel(b, a) for a, b in zip(aj[key], at[key])
                    if a is not None]
            print(f"  {tag} {key}: {', '.join(f'{e:.3e}' for e in errs)}")
    for i, (oj, ot) in enumerate(zip(nj._coarse_sts, nt._coarse_sts)):
        cmp_op(f"coarse level {i + 1}", oj, ot)
        print(f"  coarse level {i + 1} damped dinv: "
              f"{rel(nt._coarse_dinvs[i], nj._coarse_dinvs[i]):.3e}")
    print(f"  coarsest inverse: {rel(nt._coarse_inv, nj._coarse_inv):.3e}")

    # -- the first f32 step's data, each package's own --------------------
    n = nt.spline.ndof
    r_j = nj._res(nj.asm32, nj.mask32, jnp.zeros(n, jnp.float32))
    st_j = nj._build(nj.asm_b32, jnp.zeros(n, jnp.float32))
    r_t = nt._res(nt.asm32, nt.mask32, torch.zeros(n, dtype=F32))
    st_t = nt._build(nt.asm_b32, torch.zeros(n, dtype=F32))
    print(f"  f32 residual: {rel(r_t, r_j):.3e}")
    cmp_op("fine", st_j, st_t)
    lam_j = float(jlam(st_j, nj.mask32, nj._lam_x0))
    lam_t = float(tmp._lam_max_jacobi(st_t, nt.mask32, nt._lam_x0))
    arr_j = convert.mp_operator_arrays(st_j)
    op_jt = convert.mp_operator_from_numpy(arr_j, "cpu", F32)
    lam_tj = float(tmp._lam_max_jacobi(op_jt, nt.mask32, nt._lam_x0))
    print(f"  lam_max: JAX {lam_j!r}, port {lam_t!r}, port on JAX's data "
          f"{lam_tj!r}; damping scale JAX {nj._fine_omega_scale!r}, port "
          f"{nt._fine_omega_scale!r}")

    # -- tigar_tpu's cycle and CG outside its fused solve ------------------
    d = st_j.diagonal()
    d = nj.mask32 * d + (1.0 - nj.mask32)
    dinv_j = jnp.where(d != 0.0, 1.0 / d, 1.0) * nj._fine_omega_scale
    sts = (st_j,) + nj._coarse_sts
    masks = (nj.mask32,) + nj._coarse_masks
    dinvs = (dinv_j,) + nj._coarse_dinvs
    vc, act = jax_vcycle(len(sts))
    M_j = jax.jit(lambda r: vc(sts, masks, dinvs, nj._Ps, nj._coarse_inv, 0,
                               r))
    A_j = jax.jit(lambda w: act(sts, masks, 0, w))
    Mr_j = M_j(r_j)

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64) if hasattr(a, "dtype")
            and jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
    Mr_j64 = vc(*f64((sts, masks, dinvs, nj._Ps, nj._coarse_inv)), 0,
                r_j.astype(jnp.float64))
    its_j = cg_iterates(A_j, M_j, r_j, jnp.vdot,
                        lambda den, num: jnp.where(den != 0, num / den, 0.0))
    dU_j = nj._inner_solve(st_j, r_j)

    # -- the port on tigar_tpu's data --------------------------------------
    def t(a, dt=None):
        return torch.as_tensor(np.array(a), dtype=dt)

    def ops_from(dtype):
        out = []
        for op in (st_j,) + tuple(nj._coarse_sts):
            a = convert.mp_operator_arrays(op)
            if dtype == F64:
                a["Sinv"] = [None if x is None else x.astype(np.float64)
                             for x in a["Sinv"]]
            out.append(convert.mp_operator_from_numpy(a, "cpu", dtype))
        return out
    sts_t = ops_from(F32)
    masks_t = [t(m) for m in masks]
    dinvs_t = [t(x) for x in dinvs]
    cinv_t = t(nj._coarse_inv)
    vct = _vcycle_fn(len(sts_t), 2, 0.7)
    r_jt = t(r_j)
    Mr_t = vct(sts_t, masks_t, dinvs_t, nt._Ps, cinv_t, 0, r_jt)
    Mr_t64 = vct(ops_from(F64), [m.double() for m in masks_t],
                 [x.double() for x in dinvs_t], nt._Ps, cinv_t.double(), 0,
                 r_jt.double())
    print(f"  one V-cycle on identical data: {rel(Mr_t, Mr_j):.3e}; own f32 "
          f"rounding (f32 against f64 cycle): JAX {rel(Mr_j, Mr_j64):.3e}, "
          f"port {rel(Mr_t, Mr_t64):.3e}; the f64 cycles "
          f"{rel(Mr_t64, Mr_j64):.3e}")
    print(f"  fine masked apply on identical data: "
          f"{rel(_masked_apply(sts_t[0], masks_t[0], r_jt), A_j(r_j)):.3e}")
    zero = torch.zeros((), dtype=F32)
    its_t = cg_iterates(
        lambda w: _masked_apply(sts_t[0], masks_t[0], w),
        lambda r: vct(sts_t, masks_t, dinvs_t, nt._Ps, cinv_t, 0, r), r_jt,
        torch.dot, lambda den, num: torch.where(den != 0, num / den, zero))
    for k, ((xj, aj, bj), (xt, at, bt)) in enumerate(zip(its_j, its_t)):
        print(f"  CG iterate {k + 1}: x {rel(xt, xj):.3e}; alpha {at:.6e} "
              f"(JAX {aj:.6e}), beta {bt:.6e} (JAX {bj:.6e})")
    dU_tj = make_stencil_mgcg(len(sts_t), n_iters=15)(
        sts_t, masks_t, dinvs_t, nt._Ps, cinv_t, r_jt)
    dU_t = nt._inner_solve(st_t, r_t)

    # -- the f64 residual after the first step ----------------------------
    z64 = torch.zeros(n, dtype=F64)
    r0 = float(torch.linalg.norm(nt._res(nt.asm64, nt.mask64, z64)))
    for name, dU in (("tigar_tpu's solver", dU_j),
                     ("tigar_tpu's code as a Python loop", its_j[-1][0]),
                     ("the port's solver on tigar_tpu's data", dU_tj),
                     ("the port alone", dU_t)):
        r1 = float(torch.linalg.norm(nt._res(nt.asm64, nt.mask64,
                                             -t(dU).double())))
        print(f"  rel64 after the first f32 step, {name}: {r1 / r0:.4f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
