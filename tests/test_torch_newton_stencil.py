"""tigar_tpu_torch's StencilNewton against tigar_tpu's on the clamped SVK
plate at nel=8 with one coarse level (mg=[4]), q=10, cg_iters=40 (the
setting of tests/test_newton_stencil.py::test_stencil_newton_two_level):

  - one production (f32) Newton step from the same state: rel <= 1e-6
    (f32 CG recurrences in two libraries: roundoff amplified by the
    linear solve);
  - the residual norms at that state: f32 rel <= 1e-5, f64 rel <= 1e-12;
  - the full mixed-precision solve: the same number of Newton steps +-1
    and U within 1e-8 relative;
  - the driver's control paths of the port alone: the tuned production
    options, the overshoot rollback and the coarse-level requirement.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.solvers.newton_stencil import StencilNewton as JNewton
from tigar_tpu_torch.solvers.newton_stencil import StencilNewton

from torch_parity import (build_jax, build_torch, jax_density,
                          torch_density, rel)

Q = 10.0


@pytest.fixture(scope="module")
def jax_run():
    ns = JNewton(build_jax(8), jax_density(Q), mg_splines=[build_jax(4)],
                 cg_iters=40)
    U1, _, _ = ns.step(jnp.zeros(ns.spline.ndof))
    U2, rn2, _ = ns.step(U1)
    res32, res64 = ns.res_norm(U1), ns.res_norm(U1, f64=True)
    U, rel64, nit, dU_rel = ns.solve(rtol=1e-9)
    return dict(U1=np.array(U1), U2=np.array(U2), rn2=float(rn2),
                res32=res32, res64=res64, U=np.array(U), rel=rel64, nit=nit)


def _port(**kw):
    return StencilNewton(build_torch(8), torch_density(Q),
                         mg_splines=[build_torch(4)], cg_iters=40, **kw)


def test_step_matches_jax(jax_run):
    ns = _port()
    U2, rn2, dU = ns.step(torch.as_tensor(jax_run["U1"]))
    assert U2.dtype == torch.float64 and dU.dtype == torch.float64
    assert abs(float(rn2) - jax_run["rn2"]) <= 1e-6 * jax_run["rn2"]
    assert rel(U2, jax_run["U2"]) <= 1e-6


def test_res_norm_matches_jax(jax_run):
    ns = _port()
    U1 = torch.as_tensor(jax_run["U1"])
    assert abs(ns.res_norm(U1) - jax_run["res32"]) <= 1e-5 * jax_run["res32"]
    res64 = ns.res_norm(U1, f64=True)
    assert abs(res64 - jax_run["res64"]) <= 1e-12 * jax_run["res64"]
    assert res64 == ns.true_rel_residual(U1)


def test_solve_matches_jax(jax_run):
    ns = _port()
    U, rel64, nit, dU_rel = ns.solve(rtol=1e-9)
    assert rel64 < 1e-9 and dU_rel < 1e-9
    assert abs(nit - jax_run["nit"]) <= 1, (nit, jax_run["nit"])
    assert rel(U, jax_run["U"]) <= 1e-8
    assert ns.true_rel_residual(U) <= 1e-9 * ns.true_rel_residual(
        torch.zeros_like(U))


def test_tuned_production_options(jax_run):
    """bench options: cast polish tangent, 2-point tangent builds, early
    stencil freeze; the reduced-rule assembler has its own shell_ref."""
    ns = _port(polish_tangent="cast", build_quad_degree=2, rebuild_rel=0.1)
    assert ns.asm_b32.nq == 4 and "shell_ref" in ns.asm_b32.ctx.aux
    U, rel64, nit, _ = ns.solve(rtol=1e-10)
    assert rel64 < 1e-10, (rel64, nit)
    assert rel(U, jax_run["U"]) <= 1e-8


def test_overshoot_reject_rolls_back(jax_run):
    """A poisoned first f32 step is read one iteration late, rejected, and
    the solve finishes in the polish phase from the last good state."""
    ns = _port()
    real_step = ns.step
    calls = {"n": 0}

    def poisoned(U):
        Un, rn, dU = real_step(U)
        calls["n"] += 1
        if calls["n"] == 1:
            return Un + 1e3 * ns.mask64, rn, dU
        return Un, rn, dU

    ns.step = poisoned
    logs = []
    U, rel64, nit, _ = ns.solve(rtol=1e-9, log=logs.append)
    assert any("REJECTED" in s for s in logs), logs
    assert rel64 < 1e-9
    assert rel(U, jax_run["U"]) <= 1e-8


def test_requires_coarse_level():
    with pytest.raises(ValueError, match="coarser"):
        StencilNewton(build_torch(4), torch_density(Q))
