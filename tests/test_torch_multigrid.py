"""tigar_tpu_torch's multigrid, CG and iterative refinement against
tigar_tpu's on the same inputs (CPU; the port's plain K4 version carries
the level operators).

Tolerances: insertion matrices and transfers 1e-14; the Jacobi-CG
iterate after a fixed 25 iterations 1e-10 and its recurrence residual
1e-8 (unconverged: the residual is small against b, so the two
recurrences' round-off weighs more in it); the MG-CG solution 1e-10
relative (both solves converge to rel < 1e-10, so the iterates agree
to the solver's own accuracy whatever the V-cycle precision); Chebyshev
bounds 1e-10 (power iteration from the same numpy start vectors); the
refinement solution 1e-10 with the same sweep count.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.ops.knots import uniform_knots as j_knots, KnotVector as JKV
from tigar_tpu.models.bspline import TensorBSplineBasis as JBasis
from tigar_tpu.ops import sumfac as jsf
from tigar_tpu.solvers import multigrid as jmg
from tigar_tpu.solvers.linear import cg_fixed_iters as j_cg
from tigar_tpu.solvers.linear import jacobi_preconditioner as j_jacobi
from tigar_tpu.solvers.refinement import refine_solve as j_refine_solve

from tigar_tpu_torch.ops.knots import uniform_knots as t_knots
from tigar_tpu_torch.ops.knots import KnotVector as TKV
from tigar_tpu_torch.models.bspline import TensorBSplineBasis as TBasis
from tigar_tpu_torch.ops import sumfac as tsf
from tigar_tpu_torch.solvers import multigrid as tmg
from tigar_tpu_torch.solvers.linear import (cg_fixed_iters,
                                            jacobi_preconditioner)
from tigar_tpu_torch.solvers.refinement import refine_solve

from torch_parity import rel

P = 2


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("p", [2, 3])
def test_insertion_matrix(p, periodic):
    Pj = jmg.insertion_matrix_1d(JKV(p, j_knots(p, 0, 1, 6, periodic)),
                                 JKV(p, j_knots(p, 0, 1, 12, periodic)))
    Pt = tmg.insertion_matrix_1d(TKV(p, t_knots(p, 0, 1, 6, periodic)),
                                 TKV(p, t_knots(p, 0, 1, 12, periodic)))
    assert Pt.shape == Pj.shape
    assert np.max(np.abs(Pt - Pj)) <= 1e-14


def test_field_transfer():
    """Separable prolongation and restriction of a 3D field (one periodic
    direction) against the JAX transfer."""
    per = (False, True, False)
    bases = {}
    for pkg, knots, Basis in (("jax", j_knots, JBasis),
                              ("torch", t_knots, TBasis)):
        bases[pkg] = [Basis([P] * 3, [knots(P, 0, 1, n, q) for q in per])
                      for n in (6, 3)]
    tj = jmg.make_field_transfer(bases["jax"][1], bases["jax"][0],
                                 jnp.float64)
    tt = tmg.make_field_transfer(bases["torch"][1], bases["torch"][0],
                                 torch.float64, "cpu")
    rng = np.random.default_rng(0)
    xc, xf = rng.normal(size=tj.shape_c), rng.normal(size=tj.shape_f)
    xc, xf = xc.reshape(-1), xf.reshape(-1)
    assert rel(tt.prolong(torch.as_tensor(xc)),
               tj.prolong(jnp.asarray(xc))) <= 1e-14
    assert rel(tt.restrict(torch.as_tensor(xf)),
               tj.restrict(jnp.asarray(xf))) <= 1e-14


def _levels(knots, Basis, nel, stop=2):
    sizes = []
    n = nel
    while n >= stop:
        sizes.append(n)
        n //= 2
    bases = [Basis([P] * 3, [knots(P, 0.0, 1.0, s)] * 3) for s in sizes]
    masks = []
    for b in bases:
        m = np.ones(b.ncp)
        for d in range(3):
            for side in (0, 1):
                m[b.side_dofs(d, side)] = 0.0
        masks.append(m)
    return bases, masks


def _rhs_j(x, y, z):
    return 3.0 * jnp.pi ** 2 * (jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)
                                * jnp.sin(jnp.pi * z))


def _rhs_t(x, y, z):
    return 3.0 * torch.pi ** 2 * (torch.sin(torch.pi * x)
                                  * torch.sin(torch.pi * y)
                                  * torch.sin(torch.pi * z))


def test_jacobi_cg():
    """Fixed-iteration CG with the Jacobi preconditioner of the 1D-separable
    diagonal on the 3D operator (nel=4)."""
    bj, mj = _levels(j_knots, JBasis, 4, stop=4)
    bt, mt = _levels(t_knots, TBasis, 4, stop=4)
    diag, _ = tmg.identity_level_data(bt[0], 2 * P, mt[0])
    v = np.random.default_rng(9).normal(size=bj[0].ncp) * mj[0]
    op_j = jsf.make_sumfac_identity_operator(bj[0], 2 * P,
                                             mask=jnp.asarray(mj[0]))
    x_j, r_j = j_cg(op_j, jnp.asarray(v), 25,
                    M=j_jacobi(jnp.asarray(diag)))
    op = tsf.make_sumfac_identity_operator(bt[0], 2 * P,
                                           mask=torch.as_tensor(mt[0]),
                                           device="cpu")
    x, r = cg_fixed_iters(op, torch.as_tensor(v), 25,
                          M=jacobi_preconditioner(torch.as_tensor(diag)))
    assert rel(x, x_j) <= 1e-10 and rel(r, r_j) <= 1e-8


@pytest.mark.parametrize("vcycle", ["f64", "f32"])
def test_identity_poisson_mg_cg(vcycle):
    """The Poisson main path at nel=8 (levels 8/4/2): f64 CG with an f64
    or f32 V-cycle, 18 iterations."""
    bj, mj = _levels(j_knots, JBasis, 8)
    m0 = jnp.asarray(mj[0])
    op_j = jsf.make_sumfac_identity_operator(bj[0], 2 * P, mask=m0)
    b_j = jsf.sumfac_linear_form(bj[0], 2 * P, _rhs_j) * m0
    jdt = jnp.float32 if vcycle == "f32" else jnp.float64
    mg_j = jmg.identity_poisson_multigrid(bj, 2 * P, mj, dtype=jdt)
    x_j, _ = j_cg(op_j, b_j, 18,
                  M=lambda r: mg_j(r.astype(jdt)).astype(r.dtype))

    bt, mt = _levels(t_knots, TBasis, 8)
    m0 = torch.as_tensor(mt[0])
    op = tsf.make_sumfac_identity_operator(bt[0], 2 * P, mask=m0,
                                           device="cpu")
    b = tsf.sumfac_linear_form(bt[0], 2 * P, _rhs_t, device="cpu") * m0
    tdt = torch.float32 if vcycle == "f32" else torch.float64
    mg = tmg.identity_poisson_multigrid(bt, 2 * P, mt, dtype=tdt,
                                        device="cpu")
    x, r = cg_fixed_iters(op, b, 18, M=lambda r: mg(r.to(tdt)).to(r.dtype))
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-10
    assert rel(x, x_j) <= 1e-10


def test_chebyshev_bounds():
    """Chebyshev smoothing on a Helmholtz-type operator (ck K + cm M, which
    the level diagonals and the coarse matrix must follow)."""
    bj, mj = _levels(j_knots, JBasis, 8)
    bt, mt = _levels(t_knots, TBasis, 8)
    lj = jmg.identity_poisson_multigrid(bj, 2 * P, mj, ck=1.0,
                                        cm=50.0).enable_chebyshev()
    lt = tmg.identity_poisson_multigrid(bt, 2 * P, mt, ck=1.0, cm=50.0,
                                        device="cpu").enable_chebyshev()
    assert rel(np.array(lt._cheb_bounds), np.array(lj._cheb_bounds)) <= 1e-10
    # the Chebyshev V-cycle is a fixed linear operator: same action
    v = np.random.default_rng(7).normal(size=bj[0].ncp)
    assert rel(lt(torch.as_tensor(v)), lj(jnp.asarray(v))) <= 1e-10


def test_refine_solve():
    """Mixed-precision refinement (the SOLVER=refine branch) at nel=6."""
    bj, mj = _levels(j_knots, JBasis, 6, stop=6)
    bt, mt = _levels(t_knots, TBasis, 6, stop=6)
    m = mj[0]
    op64_j = jsf.make_sumfac_identity_operator(bj[0], 2 * P,
                                               mask=jnp.asarray(m))
    op32_j = jsf.make_sumfac_identity_operator(
        bj[0], 2 * P, mask=jnp.asarray(m, dtype=jnp.float32),
        dtype=jnp.float32)
    b_j = jsf.sumfac_linear_form(bj[0], 2 * P, _rhs_j) * jnp.asarray(m)
    x_j, sweeps_j, rel_j = j_refine_solve(op64_j, op32_j, b_j, tol=1e-12,
                                          max_sweeps=30, inner_iters=20)

    m = torch.as_tensor(mt[0])
    op64 = tsf.make_sumfac_identity_operator(bt[0], 2 * P, mask=m,
                                             device="cpu")
    op32 = tsf.make_sumfac_identity_operator(bt[0], 2 * P, mask=m,
                                             dtype=torch.float32,
                                             device="cpu")
    b = tsf.sumfac_linear_form(bt[0], 2 * P, _rhs_t, device="cpu") * m
    x, sweeps, rel64 = refine_solve(op64, op32, b, tol=1e-12, max_sweeps=30,
                                    inner_iters=20)
    assert sweeps == sweeps_j and rel64 < 1e-12 and rel_j < 1e-12
    assert rel(x, x_j) <= 1e-10
