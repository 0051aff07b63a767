"""tigar_tpu_torch's f32 fast-path apply (B5: layouts, the element
matrices and the plain version of kernel K12), mixed-precision
refinement with an f32 preconditioner and warm starts, against
tigar_tpu's on the same inputs (CPU).

Tolerances: layouts 1e-6 (float32); the plain B5 apply on identical
layouts, and K12's element-matrix form built from them, 1e-6 of the
largest entry (float32, summed in another order); the element matrices
in f64 against the generic assembler's 1e-12; the operator 2e-6 against
the f64 AD tangent action (tests/test_fastpath.py:34);
refinement on identical f32/f64 operators: the same sweep count and x
within 1e-12 relative; refine_solve with M_f32 as tests/test_refinement.py
(nel=16): rel < 1e-12, within 1e-10 of the direct solve, the same sweeps
as the JAX package; warm-started CG 1e-12.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.ops import fastpath as jfp
from tigar_tpu.solvers.linear import cg_fixed_iters as j_cg
from tigar_tpu.solvers.linear import jacobi_preconditioner as j_jacobi
from tigar_tpu.solvers.refinement import refine_solve as j_refine

from tigar_tpu_torch import convert
from tigar_tpu_torch.ops import fastpath as tfp
from tigar_tpu_torch.solvers.linear import cg_fixed_iters as t_cg
from tigar_tpu_torch.solvers.linear import jacobi_preconditioner as t_jacobi
from tigar_tpu_torch.solvers.refinement import refine_solve as t_refine

from torch_parity import rel, scalar_forms as forms, scalar_spline as spline


@pytest.fixture(scope="module", params=[(2, 6), (3, 4)],
                ids=["p2-nel6", "p3-nel4"])
def pair(request):
    p, nel = request.param
    return spline("jax", p, nel), spline("torch", p, nel)


def test_layouts_match_jax(pair):
    js, ts = pair
    A1j, A2j = jfp.laplace_layouts(js._assembler("dx"))
    A1t, A2t = tfp.laplace_layouts(ts._assembler("dx"))
    assert A1t.dtype == A2t.dtype == torch.float32
    for t, j in ((A1t, A1j), (A2t, A2j)):
        assert tuple(t.shape) == j.shape
        assert rel(t, j) <= 1e-6


@pytest.mark.parametrize("wtype", ["f32", "f64"])
def test_plain_apply_matches_jax_on_identical_layouts(pair, wtype):
    js, ts = pair
    ja = js._assembler("dx")
    A1j, A2j = jfp.laplace_layouts(ja)
    connT = np.asarray(ja.conns[0]).T
    A1, A2, cT = convert.laplace_layouts_from_numpy(
        np.asarray(A1j), np.asarray(A2j), connT, "cpu")
    W = np.random.default_rng(0).normal(size=js.ndof)
    if wtype == "f32":
        W = W.astype(np.float32)
    yj = jfp._laplace_apply(A1j, A2j, jnp.asarray(connT), js.mask,
                            jnp.asarray(W), js.ndof, connT.shape[0])
    yt = tfp.laplace_apply(A1, A2, cT, ts.mask, torch.as_tensor(W))
    assert str(yt.dtype).endswith(str(np.asarray(yj).dtype))
    assert rel(yt, yj) <= 1e-6


def test_element_matrix_apply_matches_jax_on_identical_layouts(pair):
    """K12's form: the element matrices built from the JAX package's f32
    layouts, applied by ``laplace_apply_elem_ref``, against JAX's
    ``_laplace_apply`` on those layouts (1e-6 of the largest entry)."""
    js, ts = pair
    ja = js._assembler("dx")
    A1j, A2j = jfp.laplace_layouts(ja)
    connT = np.asarray(ja.conns[0]).T
    A1, A2, cT = convert.laplace_layouts_from_numpy(
        np.asarray(A1j), np.asarray(A2j), connT, "cpu")
    Ke = tfp.laplace_element_matrices_from_layouts(A1, A2, connT.shape[0])
    assert Ke.dtype == torch.float32
    assert tuple(Ke.shape) == (connT.shape[0] * (connT.shape[0] + 1) // 2,
                               connT.shape[1])
    W = np.random.default_rng(1).normal(size=js.ndof).astype(np.float32)
    yj = jfp._laplace_apply(A1j, A2j, jnp.asarray(connT), js.mask,
                            jnp.asarray(W), js.ndof, connT.shape[0])
    yt = tfp.laplace_apply_elem_ref(Ke, cT, ts.mask.float(),
                                    torch.as_tensor(W))
    assert yt.dtype == torch.float32
    assert rel(yt, yj) <= 1e-6


def test_element_matrices_match_generic_assembler(pair):
    """K_e from the assembler in f64 against the generic assembler's
    element matrices of the same Laplace form (1e-12)."""
    _, ts = pair
    asm = ts._assembler("dx")
    Ke = tfp.laplace_element_matrices(asm, torch.float64)
    E = asm.element_matrices(forms("torch")["a"],
                             torch.zeros(ts.ndof, dtype=torch.float64))
    nen = E.shape[-1]
    a, b = torch.triu_indices(nen, nen)
    assert Ke.dtype == torch.float64
    assert rel(Ke, E[:, a, b].t()) <= 1e-12


def test_plain_apply_matches_ad_tangent(pair):
    _, ts = pair
    W = torch.as_tensor(np.random.default_rng(0).normal(size=ts.ndof))
    ref = ts.tangent_action(forms("torch")["a"], torch.zeros_like(W), W)
    out = tfp.make_laplace_operator(ts._assembler("dx"), ts.mask)(W)
    assert float((out - ref).abs().max()) < 2e-6 * float(ref.abs().max())


def _spd(n, seed):
    """A seeded SPD matrix with spread eigenvalues (condition 100)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.logspace(0, 2, n)) @ Q.T, rng.normal(size=n)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("warm", [False, True], ids=["x0=0", "x0"])
def test_refine_solve_matches_jax_on_identical_operators(precond, warm):
    """The port's refine_solve (M_f32, x0) against tigar_tpu's with the same
    f64 and f32 dense operators and the same f32 Jacobi preconditioner."""
    A, b = _spd(60, 3)
    A32 = A.astype(np.float32)
    x0 = 0.1 * np.random.default_rng(4).normal(size=b.size) if warm else None
    d32 = np.diag(A32)
    jM = j_jacobi(jnp.asarray(d32)) if precond == "jacobi" else None
    tM = t_jacobi(torch.as_tensor(d32)) if precond == "jacobi" else None
    xj, sj, rj = j_refine(lambda w: jnp.asarray(A) @ w,
                          lambda w: jnp.asarray(A32) @ w, jnp.asarray(b),
                          tol=1e-12, inner_iters=25, M_f32=jM,
                          x0=None if x0 is None else jnp.asarray(x0))
    At, At32 = torch.as_tensor(A), torch.as_tensor(A32)
    xt, st, rt = t_refine(lambda w: At @ w, lambda w: At32 @ w,
                          torch.as_tensor(b), tol=1e-12, inner_iters=25,
                          M_f32=tM,
                          x0=None if x0 is None else torch.as_tensor(x0))
    assert st == sj and rt < 1e-12 and rj < 1e-12
    assert rel(xt, xj) <= 1e-12


def test_cg_fixed_iters_warm_start_matches_jax():
    A, b = _spd(40, 5)
    x0 = np.random.default_rng(6).normal(size=b.size)
    d = np.diag(A)
    xj, rj = j_cg(lambda w: jnp.asarray(A) @ w, jnp.asarray(b), 15,
                  M=j_jacobi(jnp.asarray(d)), x0=jnp.asarray(x0))
    At = torch.as_tensor(A)
    xt, rt = t_cg(lambda w: At @ w, torch.as_tensor(b), 15,
                  M=t_jacobi(torch.as_tensor(d)), x0=torch.as_tensor(x0))
    assert rel(xt, xj) <= 1e-12
    assert rel(rt, rj) <= 1e-8


def test_refinement_reaches_f64_accuracy_as_jax():
    """tests/test_refinement.py: nel=16, inner_iters=60, Jacobi of the
    assembled diagonal in f32."""
    out = {}
    for pkg in ("jax", "torch"):
        s = spline(pkg, 2, 16)
        f = forms(pkg)
        b = s.assemble_vector(f["L"])
        asm = s._assembler("dx")
        if pkg == "jax":
            op32 = jfp.make_laplace_operator(asm, s.mask)
            M32 = j_jacobi(s.assemble_diagonal(f["a"]).astype(jnp.float32))
            refine = j_refine
        else:
            op32 = tfp.make_laplace_operator(asm, s.mask)
            M32 = t_jacobi(s.assemble_diagonal(f["a"]).float())
            refine = t_refine
        x, sweeps, r = refine(s.matrix_operator(f["a"]), op32, b, tol=1e-12,
                              inner_iters=60, M_f32=M32)
        x_direct = s.solve_linear_variational_problem(f["a"], rhs_form=f["L"])
        out[pkg] = (x, sweeps, r, x_direct)
    x, sweeps, r, x_direct = out["torch"]
    assert r < 1e-12
    assert rel(x, x_direct) < 1e-10
    assert sweeps == out["jax"][1]
    assert rel(x, out["jax"][0]) < 1e-10
