"""tigar_tpu_torch's form-based multigrid against tigar_tpu's (CPU):
``Multigrid(splines, form)`` with its level tangent actions, per-field
``from_level_data`` with f32 actions (the reef-knot demo's V-cycle),
``tangent_action(dtype=)``, and the scalar operator-level path of the
Poisson solve (the ``mg_cg`` solver and ``mg_dtype``:
tests/test_torch_mg_cg.py).

The shell levels are the reef-knot demo's (nel 12 and 6, the step
residual at the zero state), built by each package from the same inputs;
the V-cycles run on one numpy-seeded vector.

Tolerances: float64 V-cycles 1e-12 relative to the largest entry (the same
level operators, transfers and dense coarse inverse); the float32 cycle
within 3x of either package's own float32 rounding (its distance from its
float64 cycle), as tests/test_torch_newton_mp.py::test_vcycle_matches_jax
holds the stencil cycle; float32 tangent actions 1e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.forms import deriv as jderiv
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh as JMesh
from tigar_tpu.models.extracted import ExtractedSpline as JSpline
from tigar_tpu.models.shell import svk_psi_surface as jpsi
from tigar_tpu.models.space import EqualOrderSpline as JSpace
from tigar_tpu.ops.knots import uniform_knots as juk
from tigar_tpu.solvers.multigrid import Multigrid as JMultigrid

from tigar_tpu_torch.demos import reef_knot_contact as demo
from tigar_tpu_torch.solvers.multigrid import Multigrid

from torch_parity import jax_f32, rel, scalar_spline

F32 = torch.float32
NELS = (12, 6)


def jax_shell(nel):
    """The demo's spline in the JAX package (reef_knot_contact.py:57)."""
    mesh = JMesh([2, 2], [juk(2, 0.0, 1.0, nel)] * 2, extra_dim=1)
    gen = JSpace(3, mesh)
    basis = mesh.scalar_basis()
    for d in (0, 1):
        for s in (0, 1):
            dofs = basis.side_dofs(d, s)
            for i in range(3):
                gen.add_zero_dofs(i, dofs)
    return JSpline(gen, quad_degree=4, nders=2)


def jres(ctx, s, v):
    """The demo's step residual (reef_knot_contact.py:103)."""
    u, uo = s["u"], s["u_old"]
    udot = (u - uo) * (1.0 / demo.DELTA_T)
    dWint = jderiv(lambda y: jpsi(ctx, y, demo.E_MOD, demo.NU, demo.H_TH),
                   u, v)
    return dWint + demo.DENS * demo.DAMP * demo.H_TH \
        * jnp.sum(udot.val * v.val) - demo.LOAD * v.val[2]


@pytest.fixture(scope="module")
def shells():
    """Both packages' demo levels and their zero states, and the seeded
    right-hand side."""
    js = [jax_shell(n) for n in NELS]
    ts = [demo.build_spline(n, "cpu") for n in NELS]
    jz = [{"u": jnp.zeros(s.ndof), "u_old": jnp.zeros(s.ndof)} for s in js]
    tz = [{"u": s._zeros(), "u_old": s._zeros()} for s in ts]
    b = ts[0].mask.numpy() * np.random.default_rng(3).normal(size=ts[0].ndof)
    return dict(js=js, ts=ts, jz=jz, tz=tz, b=b)


@pytest.fixture(scope="module")
def cycles64(shells):
    """The form-based f64 V-cycles (the demo's MG=1 MIXED=0 branch) of both
    packages, and each applied to b."""
    jmg = JMultigrid(shells["js"], jres, states=shells["jz"])
    tmg = Multigrid(shells["ts"], demo.res, states=shells["tz"])
    b = shells["b"]
    return jmg, tmg, np.asarray(jmg(jnp.asarray(b))), \
        tmg(torch.as_tensor(b)).numpy()


@pytest.mark.parametrize("what", ["dinv0", "dinv1", "coarse_inv", "cycle"])
def test_form_vcycle_matches_jax(cycles64, what):
    jmg, tmg, yj, yt = cycles64
    if what == "cycle":
        assert np.max(np.abs(yj)) > 0.0
        assert rel(yt, yj) <= 1e-12
    elif what == "coarse_inv":
        assert rel(tmg._coarse_inv, jmg._coarse_inv) <= 1e-12
    else:
        lev = int(what[-1])
        assert rel(tmg.levels[lev]["dinv"], jmg.levels[lev]["dinv"]) <= 1e-12


def test_tangent_action_dtype_matches_jax(shells):
    """``tangent_action(..., dtype=float32)`` at a nonzero state: the JAX
    package's cast assembler and the port's, 1e-5."""
    js, ts = shells["js"][0], shells["ts"][0]
    rng = np.random.default_rng(4)
    u = ts.mask.numpy() * rng.normal(size=ts.ndof) * 1e-3
    W = rng.normal(size=ts.ndof)
    jst = {"u": jnp.asarray(u), "u_old": jnp.zeros(ts.ndof)}
    tst = {"u": torch.as_tensor(u), "u_old": ts._zeros()}
    yj = js.tangent_action(jres, jst, jnp.asarray(W), dtype=jnp.float32)
    yt = ts.tangent_action(demo.res, tst, torch.as_tensor(W), dtype=F32)
    y64 = ts.tangent_action(demo.res, tst, torch.as_tensor(W))
    assert yt.dtype == F32 and yj.dtype == jnp.float32
    assert rel(yt, yj) <= 1e-5
    assert rel(yt, y64) <= 1e-5


def test_per_field_vcycle_f32_matches_jax(shells, cycles64):
    """The demo's MIXED=1 V-cycle: from_level_data over three bases a
    level, the f32 AD shell actions, the f32 diagonals and masks and the
    f64-inverted coarse matrix, in both packages, against each package's
    f64 form-based cycle on the same b."""
    js, ts, jz, tz = shells["js"], shells["ts"], shells["jz"], shells["tz"]
    b = shells["b"]
    _, _, y64j, y64t = cycles64

    @jax.jit
    def shell32(a32, m32, z32, W):
        out = jax.jvp(
            lambda a: a32.residual_vector(jres, {"u": a, "u_old": z32}),
            (z32,), (m32 * W,))[1]
        return m32 * out + (1.0 - m32) * W

    def jact(s):
        a32, m32 = jax_f32(s._assembler("dx")), s.mask.astype(jnp.float32)
        z32 = jnp.zeros(s.ndof, dtype=jnp.float32)
        return lambda W: shell32(a32, m32, z32, W)

    jmg = JMultigrid.from_level_data(
        [[s.space.fields[0]] * 3 for s in js], [jact(s) for s in js],
        [s.assemble_diagonal(jres, U=st).astype(jnp.float32)
         for s, st in zip(js, jz)],
        [s.mask.astype(jnp.float32) for s in js],
        np.asarray(js[-1].assemble_matrix(jres, U=jz[-1])),
        dtype=jnp.float32)
    tmg = demo.ReefKnot(NELS[0], mixed=True, mg=True, device="cpu").M
    assert [len(t) for t in tmg.transfers] == [3]
    yj = np.asarray(jmg(jnp.asarray(b, dtype=jnp.float32)))
    yt = tmg(torch.as_tensor(b, dtype=F32)).numpy()
    assert yt.dtype == np.float32
    own = max(rel(yj, y64j), rel(yt, y64t))
    assert 0.0 < own <= 1e-3
    assert rel(yt, yj) <= 3.0 * own


# -- the Poisson problems of tests/test_multigrid.py --------------------------


def test_scalar_level_data_path_unchanged():
    """The Poisson path's operator-level cycle (one scalar basis a level,
    as identity_poisson_multigrid passes them) equals the per-field form
    with one-field lists, and tigar_tpu's cycle on the same data."""
    from tigar_tpu.solvers.multigrid import (
        identity_poisson_multigrid as jipm)
    from tigar_tpu_torch.solvers.multigrid import identity_poisson_multigrid
    from tigar_tpu_torch.solvers.multigrid import identity_level_data
    levels = [scalar_spline("torch", 2, n) for n in (8, 4)]
    bases = [s.space.fields[0] for s in levels]
    masks = [s.mask.numpy() for s in levels]
    mg = identity_poisson_multigrid(bases, 4, masks, device="cpu")
    diags, A = zip(*[identity_level_data(b, 4, m, dense=True)
                     for b, m in zip(bases, masks)])
    mg_lists = Multigrid.from_level_data(
        [[b] for b in bases], mg._actions, list(diags), masks, A[-1],
        device="cpu")
    r = np.random.default_rng(9).normal(size=bases[0].ncp)
    y = mg(torch.as_tensor(r))
    assert torch.equal(mg_lists(torch.as_tensor(r)), y)
    jl = [scalar_spline("jax", 2, n) for n in (8, 4)]
    jmg = jipm([s.space.fields[0] for s in jl], 4,
               [np.asarray(s.mask) for s in jl])
    assert rel(y, jmg(jnp.asarray(r))) <= 1e-12
