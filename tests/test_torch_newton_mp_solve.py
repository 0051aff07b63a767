"""tigar_tpu_torch's MultiPatchStencilNewton against tigar_tpu's: the
two-patch KL plate of tests/test_newton_mp.py (levels (16,16,20),
(8,8,10), (4,4,5); E=1e7, h=0.05, q=0.05; displacement + rotation penalty
pd = 1e2 E h / h_el, pr = 1e2 E h^3 / h_el; cg_iters=25,
polish_cg_iters=40) with every outer side clamped, as bench.py's
two-patch point clamps it.  With the cantilever clamping of that test the
f32 CG's step lengths carry ~1e-1 relative roundoff (f32 dot products
that cancel), so no f32 step of two libraries agrees there; the fully
clamped plate keeps the f32 step comparable.

  - the operator built at a nonzero state (per-patch stencils, K): f64
    1e-11, f32 1e-5 (with the Schwarz inverse and the damping scale);
  - one production (f32) Newton step from the same state: 1e-6;
  - the full solve, from the f32 phase and with ``start_polish``: the same
    step count +-1, U within 1e-7, and the same interface jump and
    deflection.

The JAX solver's compiles make this module the heaviest port test; it
holds few tests, so the tier-1 run schedules it late, beside the JAX
package's own multi-patch tests.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import mp_smooth_state, mp_solver, rel

F32, F64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def port():
    return mp_solver("torch")


@pytest.fixture(scope="module")
def jax_run(port):
    ns = mp_solver("jax")
    U1, _, _ = ns.step(jnp.zeros(ns.spline.ndof))
    U2, _, _ = ns.step(U1)
    solves = {sp: ns.solve(rtol=1e-10, max_iters=25, start_polish=sp)
              for sp in (False, True)}
    Us = mp_smooth_state(port)
    op64 = ns._build(ns.asm_b64, jnp.asarray(Us))
    op32 = ns._build(ns.asm_b32, jnp.asarray(Us, dtype=jnp.float32))
    return dict(ns=ns, U1=np.array(U1), U2=np.array(U2),
                U={sp: np.array(r[0]) for sp, r in solves.items()},
                nit={sp: r[2] for sp, r in solves.items()},
                Us=Us, ops={F64: op64, F32: op32},
                scale=ns._fine_omega_scale)


def test_mp_build_matches_jax(port, jax_run):
    """_build at a nonzero state, f64 then f32: per-patch K2/jacfwd
    stencils, the K7 twin's interface block, and (f32) the Schwarz inverse
    and damping."""
    for dtype, tol in ((F64, 1e-11), (F32, 1e-5)):
        f64 = dtype == F64
        U = torch.as_tensor(jax_run["Us"], dtype=dtype)
        op = port._build(port.asm_b64 if f64 else port.asm_b32, U)
        ref = jax_run["ops"][dtype]
        assert len(op.sts) == 2 and len(op.ifaces) == 1
        for a, b in zip(op.sts, ref.sts):
            assert a.S.dtype == dtype and rel(a.S, b.S) <= tol
        assert np.array_equal(op.ifaces[0].idx.numpy(),
                              np.asarray(ref.ifaces[0].idx))
        assert rel(op.ifaces[0].K, ref.ifaces[0].K) <= tol
        if f64:
            assert op.ifaces[0].Sinv is None
        else:
            assert rel(op.ifaces[0].Sinv, ref.ifaces[0].Sinv) <= tol
            assert abs(port._fine_omega_scale - jax_run["scale"]) <= tol


def test_step_matches_jax(port, jax_run):
    U2, rn2, dU = port.step(torch.as_tensor(jax_run["U1"]))
    assert U2.dtype == F64 and dU.dtype == F64
    assert rel(U2, jax_run["U2"]) <= 1e-6


def test_solve_matches_jax(port, jax_run):
    """The full solve, from f32 production steps and (as bench.py's
    penalty point) straight in the f64 polish phase."""
    nsj = jax_run["ns"]
    xi = np.asarray([[0.5, 0.5]])
    for start_polish in (False, True):
        U, rel64, nit, _ = port.solve(rtol=1e-10, max_iters=25,
                                      start_polish=start_polish)
        ref_nit = jax_run["nit"][start_polish]
        ref_U = jax_run["U"][start_polish]
        assert rel64 < 2e-8, (start_polish, rel64, nit)
        assert abs(nit - ref_nit) <= 1, (start_polish, nit, ref_nit)
        assert rel(U, ref_U) <= 1e-7
        jump = float(port.couplings[0].jump_norm(U))
        jump_j = float(nsj.couplings[0].jump_norm(jnp.asarray(ref_U)))
        assert abs(jump - jump_j) <= 1e-6 * jump_j
        # the plate bends across the interface (patch 1) as tigar_tpu's
        w = port.spline.evaluate(U, xi, patch=1)[0, 2]
        w_j = nsj.spline.evaluate(ref_U, xi, patch=1)[0, 2]
        assert abs(w) > 1e-8 and abs(w - w_j) <= 1e-7 * abs(w_j)
    # the prolonged coarse solution is exact knot insertion, re-masked
    Uc = torch.as_tensor(np.random.default_rng(7).normal(
        size=port.mg_splines[0].ndof))
    Up = port.prolong_solution(Uc)
    assert torch.all(Up[port.mask64 == 0.0] == 0.0)
