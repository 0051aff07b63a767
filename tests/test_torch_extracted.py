"""tigar_tpu_torch's generic form path (forms, the per-element assembler,
ExtractedSpline's assembly and linear solvers) against tigar_tpu's on the
same splines and the same forms, written once per package (CPU).

Tolerances: assembled vectors, functionals, tangent actions, dense and
sparse matrices, diagonals and error norms 1e-12 relative in f64 (the
same arithmetic in another order); solutions 1e-10 relative (both
packages solve to a 1e-12 residual, or directly); the SA-preconditioned
solution 1e-8 (tests/test_aggregation.py's bound).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.models.extracted import term as j_term

from tigar_tpu_torch.models.extracted import term as t_term

from torch_parity import rel, scalar_forms as forms, scalar_spline as spline

F64 = 1e-12
SOLUTION = 1e-10


PARAMS = {"c": 0.3, "s": 2.0}
CASES = [(2, 6), (3, 4)]


@pytest.fixture(scope="module", params=CASES, ids=["p2-nel6", "p3-nel4"])
def pair(request):
    p, nel = request.param
    js, ts = spline("jax", p, nel), spline("torch", p, nel)
    U = np.random.default_rng(p).normal(size=js.ndof) * 0.3
    W = np.random.default_rng(10 + p).normal(size=js.ndof)
    return js, ts, U, W


def _as(pkg, x):
    return jnp.asarray(x) if pkg == "jax" else torch.as_tensor(x)


QUANTITIES = ["vector", "residual", "functional", "tangent_action",
              "matrix", "sparse", "diagonal", "errornorm"]


@pytest.mark.parametrize("what", QUANTITIES)
def test_assembly_matches_jax(pair, what):
    js, ts, U, W = pair
    out = {}
    for pkg, s in (("jax", js), ("torch", ts)):
        f = forms(pkg)
        prm = PARAMS if pkg == "jax" else {k: v for k, v in PARAMS.items()}
        u, w = _as(pkg, U), _as(pkg, W)
        if what == "vector":
            out[pkg] = s.assemble_vector(f["L"])
        elif what == "residual":
            out[pkg] = s.assemble_vector(f["res"], U=u, params=prm)
        elif what == "functional":
            out[pkg] = s.assemble_functional(f["energy"], U=u)
        elif what == "tangent_action":
            out[pkg] = s.tangent_action(f["res"], u, w, params=prm)
        elif what == "matrix":
            out[pkg] = s.assemble_matrix(f["res"], U=u, params=prm)
        elif what == "sparse":
            M = s.assemble_sparse(f["res"], U=u, params=prm, diag=2.0)
            out[pkg] = M.todense() if pkg == "jax" else M.to_dense()
        elif what == "diagonal":
            out[pkg] = s.assemble_diagonal(f["res"], U=u, params=prm)
        else:
            out[pkg] = s.errornorm(u, lambda ctx, f=f: f["soln"](ctx.x))
    t, j = np.atleast_1d(out["torch"]), np.atleast_1d(np.asarray(out["jax"]))
    assert t.shape == j.shape
    assert rel(t, j) <= F64


@pytest.mark.parametrize("what", ["residual", "tangent_action", "matrix",
                                  "functional"])
def test_chunked_assembly_matches_one_batch(what, monkeypatch):
    """Element batches mapped in chunks (8,192 elements on the card; 5
    here, with a ragged last chunk) give what one batch gives, to
    1e-14."""
    import tigar_tpu_torch.ops.assembly as tasm
    s = spline("torch", 2, 6)
    f = forms("torch")
    rng = np.random.default_rng(5)
    U = torch.as_tensor(0.3 * rng.normal(size=s.ndof))
    W = torch.as_tensor(rng.normal(size=s.ndof))
    run = {"residual": lambda: s.assemble_vector(f["res"], U=U,
                                                 params=PARAMS),
           "tangent_action": lambda: s.tangent_action(f["res"], U, W,
                                                      params=PARAMS),
           "matrix": lambda: s.assemble_matrix(f["res"], U=U, params=PARAMS),
           "functional": lambda: s.assemble_functional(f["energy"], U=U)}
    one = run[what]()
    monkeypatch.setattr(tasm, "DEFAULT_ASSEMBLY_CHUNK", 5)
    assert rel(run[what](), one) <= 1e-14


@pytest.mark.parametrize("method", ["direct", "cg", "bicgstab", "sparse_cg"])
def test_linear_solve_matches_jax(method):
    Us = {}
    for pkg in ("jax", "torch"):
        s = spline(pkg, 2, 6)
        s.set_solver_options(linear_solver=method)
        f = forms(pkg)
        Us[pkg] = s.solve_linear_variational_problem(f["a"], rhs_form=f["L"])
    assert rel(Us["torch"], Us["jax"]) <= SOLUTION


def test_residual_form_solve_and_measure_options_match_jax():
    """The residual-form path (one Newton step from U0) and a dict form
    with a per-term quadrature degree and a subdomain predicate."""
    out = {}
    for pkg in ("jax", "torch"):
        xp = jnp if pkg == "jax" else torch
        f = forms(pkg)
        s = spline(pkg, 2, 6)
        term = j_term if pkg == "jax" else t_term

        def res(ctx, u, v, f=f):
            return f["a"](ctx, u, v) - f["L"](ctx, v)

        U = s.solve_linear_variational_problem(res)
        left = term(f["L"], quad_degree=7,
                    where=lambda ctx, xp=xp: ctx.x[0] < 0.5)
        b = s.assemble_vector({"dx": left})
        out[pkg] = (U, b)
    assert rel(out["torch"][0], out["jax"][0]) <= SOLUTION
    assert rel(out["torch"][1], out["jax"][1]) <= F64


def test_biharmonic_lap_form_matches_jax():
    """demos/biharmonic/biharmonic.py:44-52 at nel 6: quartic splines,
    nders=2, two clamped layers, a = lap(u) lap(v); the solution and the
    energy error."""
    out = {}
    for pkg in ("jax", "torch"):
        xp = jnp if pkg == "jax" else torch
        s = spline(pkg, 4, 6, lo=-1.0, layers=2, nders=2)
        pi = math.pi

        def f_rhs(x, xp=xp):
            cx, cy = xp.cos(pi * x[0]), xp.cos(pi * x[1])
            return pi ** 4 * (cx * (cy + 1.0) + 2.0 * cx * cy
                              + (cx + 1.0) * cy)

        def lap_exact(x, xp=xp):
            cx, cy = xp.cos(pi * x[0]), xp.cos(pi * x[1])
            return -pi ** 2 * (cx * (cy + 1.0) + (cx + 1.0) * cy)

        def a(ctx, u, v):
            return ctx.lap(u) * ctx.lap(v)

        def L(ctx, v, f_rhs=f_rhs):
            return f_rhs(ctx.x) * v.val

        U = s.solve_linear_variational_problem(a, rhs_form=L)

        def err(ctx, u, lap_exact=lap_exact):
            e = ctx.lap(u) - lap_exact(ctx.x)
            return e * e

        out[pkg] = (U, s.assemble_functional(err, U=U))
    assert rel(out["torch"][0], out["jax"][0]) <= SOLUTION
    assert rel(out["torch"][1], out["jax"][1]) <= F64


def test_poisson_rate():
    """tests/test_poisson.py's manufactured Poisson at p=2 over nel 4, 8,
    16 in the port: the L2 rate is optimal (p + 1 = 3, less 0.25)."""
    errs = []
    for nel in (4, 8, 16):
        s = spline("torch", 2, nel)
        f = forms("torch")
        U = s.solve_linear_variational_problem(f["a"], rhs_form=f["L"])
        errs.append(float(s.errornorm(U, lambda ctx: f["soln"](ctx.x),
                                      rationalize=False)))
    rates = [math.log2(errs[i - 1] / errs[i]) for i in (1, 2)]
    assert all(r > 2.75 for r in rates), rates


@pytest.mark.parametrize("what", ["ds", "mg_cg"])
def test_unported_measures_and_solvers_raise(what):
    s = spline("torch", 2, 4)
    f = forms("torch")
    if what == "ds":
        with pytest.raises(NotImplementedError):
            s.assemble_vector({"dx": f["L"], ("ds", 0, 1): f["L"]})
    else:
        s.set_solver_options(linear_solver="mg_cg")
        with pytest.raises(NotImplementedError, match="A8"):
            s.solve_linear_variational_problem(f["a"], rhs_form=f["L"])


def test_geometry_evaluation_matches_jax():
    xi = np.random.default_rng(4).uniform(size=(7, 2))
    js, ts = spline("jax", 3, 4), spline("torch", 3, 4)
    assert np.max(np.abs(ts.evaluate_geometry(xi)
                         - np.asarray(js.evaluate_geometry(xi)))) <= 1e-14
