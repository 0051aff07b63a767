"""tigar_tpu_torch's Newton solves with penalty self-contact against
tigar_tpu on the CPU, mirroring tests/test_contact.py:81-200: the
nonlinear variational solve, the combined manual Newton with a dense
tangent, and the matrix-free combined Newton (shell JVP plus contact HVP
inside Jacobi CG).

Tolerances: the same iteration count and U within 1e-10 of the JAX
package; the matrix-free Newton within 1e-6 of the port's dense one.

Cost: the port's AD shell tangent action takes 60-150 ms a call on a CPU
with one torch thread (torch.func's nested transforms), so the Krylov
loop that applies it runs 20 CG iterations (tests/test_contact.py:141
runs 400).  Both packages run the same count; on these small problems
(108-147 unknowns) the solves are near exact at it, and the matrix-free
Newton is still held to the dense one.  Three cases, so that xdist's
loadfile runs this file beside the tail of the tier-1 run.
"""

import contextlib
import io

import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.contact import PointContact as JContact
from tigar_tpu.forms import deriv as jderiv
from tigar_tpu.models.shell import svk_psi_surface as jpsi
from tigar_tpu.solvers import linear as jlin

from tigar_tpu_torch.contact import PointContact
from tigar_tpu_torch.forms import deriv
from tigar_tpu_torch.models.shell import svk_psi_surface
from tigar_tpu_torch.solvers.linear import (cg_fixed_iters,
                                            jacobi_preconditioner)

from torch_parity import contact_strip, rel

CG_ITERS = 20           # the matrix-free Newton's CG (module docstring)


# -- Newton solves with contact (tests/test_contact.py:81-200) ---------------

E_MOD, NU, H_TH, Q = 1e5, 0.3, 0.05, -2.0


def jres(ctx, u, v):
    return jderiv(lambda y: jpsi(ctx, y, E_MOD, NU, H_TH), u, v) \
        - Q * v.val[2]


def tres(ctx, u, v):
    return deriv(lambda y: svk_psi_surface(ctx, y, E_MOD, NU, H_TH), u, v) \
        - Q * v.val[2]


def _newton(pkg, spline, contact, solve_lin, rtol, max_iters=50):
    """The manual combined Newton loop of tests/test_contact.py:117-139:
    (U, iterations)."""
    xp = jnp if pkg == "jax" else torch
    U = (jnp.zeros(spline.ndof) if pkg == "jax"
         else torch.zeros(spline.ndof, dtype=torch.float64))
    res = jres if pkg == "jax" else tres
    n0 = None
    for it in range(max_iters):
        r = spline.assemble_vector(res, U=U) \
            + spline.mask * contact.residual(U)
        nrm = float(xp.linalg.norm(r))
        n0 = nrm if n0 is None else n0
        if nrm / n0 < rtol:
            return U, it
        U = U - solve_lin(U, r)
    raise AssertionError("combined Newton failed to converge")


def _dense_solver(pkg, spline, contact):
    res = jres if pkg == "jax" else tres
    mask = spline.mask

    def solve(U, r):
        A = spline.assemble_matrix(res, U=U)
        if pkg == "jax":
            Kc = jax.jacfwd(lambda uu: mask * contact.residual(uu))(U)
            return jnp.linalg.solve(A + Kc, r)
        Kc = torch.func.jacfwd(lambda uu: mask * contact.residual(uu))(U)
        return torch.linalg.solve(A + Kc, r)
    return solve


def _matfree_solver(pkg, spline, contact):
    res = jres if pkg == "jax" else tres
    mask = spline.mask
    cg = jlin.cg_fixed_iters if pkg == "jax" else cg_fixed_iters
    jac = jlin.jacobi_preconditioner if pkg == "jax" \
        else jacobi_preconditioner

    def cg_solve(U, r, diag):
        def A_op(W):
            return (spline.tangent_action(res, U, W)
                    + mask * contact.tangent_action(U, mask * W))
        return cg(A_op, r, CG_ITERS, M=jac(diag))[0]

    if pkg == "jax":
        # one compile for every Newton iteration (cg_fixed_iters' fori_loop
        # would otherwise compile its body again at each call)
        cg_solve = jax.jit(cg_solve)

    def solve(U, r):
        return cg_solve(U, r, spline.assemble_diagonal(res, U=U))
    return solve


@pytest.fixture(scope="module")
def membrane():
    """tests/test_contact.py:81-139's clamped membrane (nel=4): the pure
    elastic Newton solve (r_self=1e9 disables every pair) through
    solve_nonlinear_variational_problem, its log counting the iterates,
    and the combined manual Newton with a dense tangent, in both
    packages."""
    out = {}
    for pkg in ("jax", "torch"):
        sp = contact_strip(pkg, clamp=True)
        sp.set_solver_options(max_iters=50, relative_tolerance=1e-6)
        C = JContact if pkg == "jax" else PointContact
        c0 = C(sp, k=1e8, r_max=0.05, r_self=1e9)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            U_noc = sp.solve_nonlinear_variational_problem(
                jres if pkg == "jax" else tres, log=True)
        c2 = C(sp, k=1e6, r_max=0.04, r_self=0.3)
        U, its = _newton(pkg, sp, c2, _dense_solver(pkg, sp, c2), 1e-6)
        out[pkg] = dict(U_noc=U_noc, e_noc=float(c0.energy(U_noc)),
                        log=log.getvalue().splitlines(), U=U, its=its)
    return out


def test_nonlinear_solve_matches_jax(membrane):
    j, t = membrane["jax"], membrane["torch"]
    assert t["e_noc"] == 0.0 == j["e_noc"]
    assert len(t["log"]) == len(j["log"]) > 1
    assert rel(t["U_noc"], j["U_noc"]) <= 1e-10


def test_combined_dense_newton_matches_jax(membrane):
    j, t = membrane["jax"], membrane["torch"]
    assert t["its"] == j["its"]
    assert rel(t["U"], j["U"]) <= 1e-10
    assert bool(torch.isfinite(t["U"]).all())


def test_matrix_free_combined_newton_matches_jax():
    """tests/test_contact.py:141 (nel=5): the combined tangent only as an
    action (shell JVP + contact HVP) inside Jacobi CG, against the same
    loop in the JAX package and against the port's dense Newton."""
    out = {}
    for pkg in ("jax", "torch"):
        sp = contact_strip(pkg, nel=5, clamp=True)
        C = JContact if pkg == "jax" else PointContact
        c = C(sp, k=1e6, r_max=0.04, r_self=0.3)
        out[pkg] = _newton(pkg, sp, c, _matfree_solver(pkg, sp, c), 1e-9)
        if pkg == "torch":
            U_dense, _ = _newton(pkg, sp, c, _dense_solver(pkg, sp, c), 1e-9)
    (Uj, nj), (Ut, nt) = out["jax"], out["torch"]
    assert nt == nj
    assert rel(Ut, Uj) <= 1e-10
    assert rel(Ut, U_dense) <= 1e-6
