"""tigar_tpu_torch's reef-knot demo (demos/reef_knot_contact.py) against
the JAX demo's loop on the CPU: ``run`` at the demo's default NEL=6, one
step without MG, against demos/kl_shell_svk/reef_knot_contact.py's loop
reproduced here (the JAX demo runs at import, so it cannot be imported).

Tolerances: f64 CG the same Newton history to 1e-10 and U within 1e-10;
f32 CG (inside the f64 Newton loop) the Newton count within 1 and U
within 1e-5, because the two packages round the f32 CG differently.

Cost: the port's AD shell tangent action takes 60-150 ms a call on a CPU
with one torch thread (torch.func's nested transforms), so the demo's
loop runs 10 CG iterations (the JAX demo's CG_ITERS knob; its default
without MG is 200), both packages at that count.  Two cases, so that
xdist's loadfile runs this file beside the tail of the tier-1 run.
"""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.contact import PointContact as JContact
from tigar_tpu.forms import deriv as jderiv
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh as JMesh
from tigar_tpu.models.extracted import ExtractedSpline as JSpline
from tigar_tpu.models.shell import svk_psi_surface as jpsi
from tigar_tpu.models.space import EqualOrderSpline as JSpace
from tigar_tpu.solvers import linear as jlin

from tigar_tpu_torch.demos import reef_knot_contact as demo

from torch_parity import jax_f32, rel

DEMO_CG_ITERS = 10      # the demo loop's CG at NEL=6 (module docstring)


# -- the demo's step (demos/kl_shell_svk/reef_knot_contact.py at NEL=6) -----


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX demo's objects at NEL=6 (reef_knot_contact.py:57-153),
    built once so both CG variants share their compiles."""
    from tigar_tpu.ops.knots import uniform_knots as uk

    DT, DENS, DAMP, LOAD, E, nu, h = 2.0e-3, 1.0, 5.0, -8.0, 1.0e5, 0.3, 0.03
    mesh = JMesh([2, 2], [uk(2, 0.0, 1.0, 6)] * 2, extra_dim=1)
    gen = JSpace(3, mesh)
    basis = mesh.scalar_basis()
    for d in (0, 1):
        for s in (0, 1):
            dofs = basis.side_dofs(d, s)
            for i in range(3):
                gen.add_zero_dofs(i, dofs)
    spline = JSpline(gen, quad_degree=4, nders=2)
    spline.set_solver_options(max_iters=60, relative_tolerance=1e-4)

    def res(ctx, st, v):
        u, uo = st["u"], st["u_old"]
        udot = (u - uo) * (1.0 / DT)
        dWint = jderiv(lambda y: jpsi(ctx, y, E, nu, h), u, v)
        return dWint + DENS * DAMP * h * jnp.sum(udot.val * v.val) \
            - LOAD * v.val[2]

    contact = JContact(spline, k=1e7, r_max=0.06, r_self=0.25)

    @jax.jit
    def comb32(a32, c32, m32, state32, Ui32, W):
        out = jax.jvp(
            lambda a: a32.residual_vector(res, {**state32, "u": a}),
            (state32["u"],), (m32 * W,))[1]
        out = m32 * out + (1.0 - m32) * W
        return out + m32 * c32.tangent_action(Ui32, m32 * W)

    asm32, contact32 = jax_f32(spline._assembler("dx")), jax_f32(contact)
    mask32 = spline.mask.astype(jnp.float32)
    mask = spline.mask

    # the demo's CG calls, each compiled once for every Newton iteration
    # (cg_fixed_iters' fori_loop would otherwise compile its body again at
    # each call)
    @partial(jax.jit, static_argnums=4)
    def cg64(state, Ui, r, diag, n):
        def A_op(W):
            return (spline.tangent_action(res, state, W)
                    + mask * contact.tangent_action(Ui, mask * W))
        return jlin.cg_fixed_iters(A_op, r, n,
                                   M=jlin.jacobi_preconditioner(diag))[0]

    @partial(jax.jit, static_argnums=4)
    def cg32(state32, Ui32, r32, diag32, n):
        A_op = partial(comb32, asm32, contact32, mask32, state32, Ui32)
        return jlin.cg_fixed_iters(A_op, r32, n,
                                   M=jlin.jacobi_preconditioner(diag32))[0]

    return dict(spline=spline, res=res, contact=contact, cg64=cg64,
                cg32=cg32)


def _jax_demo_step(fx, mixed, cg_iters):
    """One time step of the JAX demo's loop without MG
    (reef_knot_contact.py:155-210): (U, Newton history)."""
    spline, res, contact = fx["spline"], fx["res"], fx["contact"]
    mask = spline.mask
    Ui = U_old = jnp.zeros(spline.ndof, dtype=spline.dtype)
    n0, hist = None, []
    for _ in range(spline.max_iters):
        state = {"u": Ui, "u_old": U_old}
        r = spline.assemble_vector(res, U=state) \
            + mask * contact.residual(Ui)
        nrm = float(jnp.linalg.norm(r))
        n0 = nrm if n0 is None else n0
        hist.append(nrm / n0)
        if hist[-1] < spline.relative_tolerance:
            return Ui, hist
        diag = spline.assemble_diagonal(res, U=state)
        if mixed:
            state32 = {k: v.astype(jnp.float32) for k, v in state.items()}
            dU32 = fx["cg32"](state32, Ui.astype(jnp.float32),
                              r.astype(jnp.float32),
                              diag.astype(jnp.float32), cg_iters)
            Ui = Ui - dU32.astype(spline.dtype)
        else:
            Ui = Ui - fx["cg64"](state, Ui, r, diag, cg_iters)
    raise AssertionError("JAX demo loop failed to converge")


@pytest.mark.parametrize("mixed", [False, True])
def test_demo_step_matches_jax(jax_demo, mixed):
    """run(6, 1) without MG against the JAX demo's loop: f64 CG the same
    Newton history to 1e-10 and U within 1e-10; f32 CG (inside the f64
    Newton loop) the Newton count within 1 and U within 1e-5, because the
    two packages round the f32 CG differently."""
    Uj, hj = _jax_demo_step(jax_demo, mixed, DEMO_CG_ITERS)
    Ut, ht, energy = demo.run(6, 1, mixed=mixed, mg=False,
                              cg_iters=DEMO_CG_ITERS, device="cpu")
    assert energy == 0.0
    assert bool(torch.isfinite(Ut).all())
    if mixed:
        assert abs(len(ht[0]) - len(hj)) <= 1
        assert rel(Ut, Uj) <= 1e-5
    else:
        assert len(ht[0]) == len(hj)
        assert np.max(np.abs(np.array(ht[0]) - np.array(hj))) <= 1e-10
        assert rel(Ut, Uj) <= 1e-10
