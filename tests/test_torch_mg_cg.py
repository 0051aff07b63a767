"""tigar_tpu_torch's ``mg_cg`` linear solver and ``mg_dtype`` option
against tigar_tpu's on the CPU, on the Poisson problems of
tests/test_multigrid.py:350 and :549: the form-based V-cycle as the
preconditioner of ``solve_linear_variational_problem``, and an f32 cycle
inside an f64 CG.

Tolerances: mg_cg solutions within 1e-8 of the direct solve and of the
JAX package's; the f32 cycle at most 2 CG iterations more than the f64
one (the JAX package's f64 cycle takes the port's count).  Two cases, so
that xdist's loadfile runs this file beside the tail of the tier-1 run.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.solvers.multigrid import Multigrid as JMultigrid

from tigar_tpu_torch.solvers.multigrid import Multigrid

from torch_parity import rel, scalar_forms, scalar_spline

F32 = torch.float32


def test_mg_cg_linear_solver_dispatch():
    """tests/test_multigrid.py:350: linear_solver="mg_cg" through
    solve_linear_variational_problem matches the direct solve, and the
    JAX package's mg_cg solution."""
    out = {}
    for pkg in ("jax", "torch"):
        f = scalar_forms(pkg)
        fine = scalar_spline(pkg, 3, 16)
        U_direct = fine.solve_linear_variational_problem(f["a"],
                                                         rhs_form=f["L"])
        fine.set_solver_options(
            linear_solver="mg_cg", linear_tol=1e-12,
            mg_levels=[scalar_spline(pkg, 3, 8), scalar_spline(pkg, 3, 4)])
        out[pkg] = (U_direct,
                    fine.solve_linear_variational_problem(f["a"],
                                                          rhs_form=f["L"]))
    Ud, Umg = out["torch"]
    assert rel(Umg, Ud) <= 1e-8
    assert rel(Umg, out["jax"][1]) <= 1e-8


def _pcg_iters(action, b, M, tol=1e-10, maxiter=200):
    """tests/test_multigrid.py:80's host-side PCG: (x, iterations to
    |r| <= tol |b|)."""
    x = torch.zeros_like(b)
    r = b - action(x)
    z = M(r)
    p = z
    rz = float(torch.dot(r, z))
    b_norm = float(torch.linalg.norm(b))
    for it in range(maxiter):
        if float(torch.linalg.norm(r)) <= tol * b_norm:
            return x, it
        Ap = action(p)
        alpha = rz / float(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = float(torch.dot(r, z))
        p = z + (rz_new / rz) * p
        rz = rz_new
    raise AssertionError("PCG did not converge")


def test_mg_f32_vcycle_inside_f64_cg():
    """tests/test_multigrid.py:549: an f32 V-cycle preconditioning an f64
    CG takes at most 2 more iterations than the f64 cycle, reaches f64
    accuracy, and the mg_dtype option wires it up."""
    f = scalar_forms("torch")
    levels = [scalar_spline("torch", 2, n) for n in (16, 8, 4)]
    spline = levels[0]
    b = spline.assemble_vector(f["L"])
    action = spline.matrix_operator(f["a"])
    x64, it64 = _pcg_iters(action, b, Multigrid(levels, f["a"]))
    mg32 = Multigrid(levels, f["a"], dtype=F32)
    assert mg32._coarse_inv.dtype == F32
    x32, it32 = _pcg_iters(action, b, lambda r: mg32(r.to(F32)).to(r.dtype))
    assert it32 <= it64 + 2, (it64, it32)
    x_direct = torch.linalg.solve(spline.assemble_matrix(f["a"]), b)
    assert rel(x32, x_direct) <= 1e-8
    spline.set_solver_options(linear_solver="mg_cg", mg_levels=levels[1:],
                              mg_dtype=F32, linear_tol=1e-12)
    x_opt = spline._solve_linearized(f["a"], spline._zeros(), b)
    assert rel(x_opt, x_direct) <= 1e-8
    # the same iteration count as the JAX package's f64 cycle
    jf = scalar_forms("jax")
    jl = [scalar_spline("jax", 2, n) for n in (16, 8, 4)]
    # compiled once for the loop's calls
    jmg = jax.jit(JMultigrid(jl, jf["a"]))
    jop = jax.jit(jl[0].matrix_operator(jf["a"]))
    _, itj = _pcg_iters(lambda w: torch.as_tensor(np.asarray(
        jop(jnp.asarray(w.numpy())))), b,
        lambda r: torch.as_tensor(np.asarray(jmg(jnp.asarray(r.numpy())))))
    assert itj == it64
