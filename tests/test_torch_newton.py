"""tigar_tpu_torch's Newton loop (solvers/newton.newton_solve) against
tigar_tpu's on the problems of tests/test_pipeline.py: the same iterates
and iteration counts with and without the pipelined convergence check,
the post-loop drain at the last iteration, and the non-convergence error.

Tolerances: U equal between the two modes of one package (the same
arithmetic, only the host read moves), and within 1e-15 of the JAX
package's U (float64, one division and one cube a step).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.solvers.newton import newton_solve as jnewton

from tigar_tpu_torch.solvers.newton import NewtonError, newton_solve

from torch_parity import rel


def _cube_root_problem(xp):
    def residual(U):
        return U ** 3 - 2.0

    def solve_lin(U, r):
        return r / (3.0 * U ** 2)

    return residual, solve_lin


@pytest.mark.parametrize("pipeline", [False, True])
def test_newton_matches_jax(pipeline):
    U0 = 1.5 * np.ones(5)
    Uj, nj = jnewton(*_cube_root_problem(jnp), jnp.asarray(U0), rtol=1e-12,
                     pipeline=pipeline)
    Ut, nt = newton_solve(*_cube_root_problem(torch), torch.as_tensor(U0),
                          rtol=1e-12, pipeline=pipeline)
    assert nt == nj
    assert rel(Ut, Uj) <= 1e-15
    np.testing.assert_allclose(Ut.numpy(), 2.0 ** (1.0 / 3.0), rtol=1e-12)


def test_pipelined_newton_identical():
    """tests/test_pipeline.py:15: same iterates, same count."""
    outs = {pl: newton_solve(*_cube_root_problem(torch),
                             1.5 * torch.ones(5, dtype=torch.float64),
                             rtol=1e-12, pipeline=pl)
            for pl in (False, True)}
    (Ua, na), (Ub, nb) = outs[False], outs[True]
    assert na == nb
    assert torch.equal(Ua, Ub)


def test_pipelined_newton_nonconvergence():
    """tests/test_pipeline.py:35."""
    with pytest.raises(NewtonError):
        newton_solve(lambda U: U + 1.0, lambda U, r: 0.0 * r,
                     torch.ones(3, dtype=torch.float64), max_iters=3,
                     pipeline=True)


def test_pipelined_newton_converges_at_last_iteration():
    """tests/test_pipeline.py:41: convergence at iterate max_iters - 1 is
    found by the drain after the loop."""
    U0 = 1.5 * torch.ones(2, dtype=torch.float64)
    _, n_sync = newton_solve(*_cube_root_problem(torch), U0, rtol=1e-12)
    _, n = newton_solve(*_cube_root_problem(torch), U0, rtol=1e-12,
                        max_iters=n_sync + 1, pipeline=True)
    assert n == n_sync


def test_reference_error_and_update_match_jax():
    """``reference_error`` sets the denominator and ``update`` the step, in
    both packages alike."""
    U0 = 1.5 * np.ones(3)
    kw = dict(rtol=1e-10, reference_error=10.0, max_iters=80)
    Uj, nj = jnewton(*_cube_root_problem(jnp), jnp.asarray(U0),
                     update=lambda U, dU: U - 0.5 * dU, **kw)
    Ut, nt = newton_solve(*_cube_root_problem(torch), torch.as_tensor(U0),
                          update=lambda U, dU: U - 0.5 * dU, **kw)
    assert nt == nj
    assert rel(Ut, Uj) <= 1e-15


@pytest.mark.parametrize("lump_mass", [False, True])
def test_project_matches_jax(lump_mass):
    """ExtractedSpline.project (L2 and lumped) of the Poisson solution on
    the p=2 nel=6 square, against the JAX package (1e-12: the same mass
    solve or lumped division on the same vector)."""
    from torch_parity import scalar_forms, scalar_spline
    out = {}
    for pkg in ("jax", "torch"):
        sp = scalar_spline(pkg, 2, 6)
        soln = scalar_forms(pkg)["soln"]
        out[pkg] = sp.project(lambda ctx: soln(ctx.x), lump_mass=lump_mass)
        assert sp.fit == sp.project
    assert rel(out["torch"], out["jax"]) <= 1e-12
