"""tigar_tpu_torch's consistent (Nitsche) interface coupling against
tigar_tpu's EnergyNitscheCoupling, on the CPU, with the same inputs:

  - ``svk_psi_surface`` (value and jet gradient, reference geometry read or
    recomputed) and the identity ``svk_shell_adjoint == grad
    svk_psi_surface`` that kernels K8/K9 rely on: 1e-12;
  - ``_taylor_shift`` / ``_side_ctx_at`` / ``_jet2_at`` at a nonzero
    parametric offset: 1e-13;
  - the form's energy, residual and tangent block for the two densities of
    tests/test_interface.py:322, the Laplace energy (w_order=1) on its p=2
    two-patch plate (nel 4 / 6, carried across by ``convert``) and the SVK
    shell energy (w_order=2) on the Nitsche plate below: f64 1e-11, f32
    1e-5; ``convert`` carries a JAX form across unchanged;
  - MultiPatchStencilNewton on the Nitsche plate of
    tests/test_newton_mp.py:132 at its two coarsest levels (8,8,10),
    (4,4,5) (a fine level and a coarse one, as its two finest levels;
    the JAX reference's traces and compiles, not the plate size, set
    the module's cost), E=1e7, h=0.05, q=0.05, beta_d = 10 (D/h^3 + E h/h),
    beta_r = 10 D/h per level, cg_iters=25, polish_cg_iters=40, with
    every outer side clamped as in tests/test_torch_newton_mp.py's solver
    tests
    (on the cantilever the residual after the first f32 step already
    differs by 0.4% between the two libraries, so no f32 step compares
    there): the operator at a
    nonzero state (f64 1e-11, f32 1e-5), one f32 step (1e-6), and the
    full solve with the f32 phase first (steps +-1, U within 1e-7).

The shell density's form checks run on the solver's fine-level coupling,
so that the JAX package compiles each of its residuals and tangent blocks
once for the whole module (its solver's traces dominate the module's
time: three of the Nitsche tangent block, the coarse level's f32 at
construction and the fine level's f32 and f64; the JAX energy is jitted
so that its own trace and derivatives are reused among them, ~20% of
the fixture).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (ALL_SIDES, MP_E, MP_H, MP_LEVELS, NU, mp_density,
                          mp_smooth_state, rel, two_patch)

F32, F64 = torch.float32, torch.float64
LEVELS = MP_LEVELS[1:]
D_BEND = MP_E * MP_H ** 3 / 12.0 / (1 - NU ** 2)
SHELL_PARAMS = {"E": MP_E, "nu": NU, "h": MP_H}


@jax.jit
def _jax_shell_energy(ctx, u, params):
    # jitted, so that JAX's nested derivatives of it (the Nitsche flux,
    # then the tangent block's Hessian) reuse its traced and transformed
    # jaxpr across levels instead of re-tracing the energy each time
    from tigar_tpu.models.shell import svk_psi_surface
    return svk_psi_surface(ctx, u, params["E"], params["nu"], params["h"])


def _jax_laplace_energy(ctx, u, params):
    g = u.g @ ctx.pinv
    return 0.5 * jnp.sum(g * g)


def _torch_laplace_energy(ctx, u, params):
    # the per-point scalar is summed last: torch.func's forward mode gives
    # (0-dim tensor) * (Python float) a float64 tangent
    g = u.g @ ctx.pinv
    return (0.5 * g * g).sum((-2, -1))


def shell_nitsche(pkg, sp, nx):
    """The Nitsche coupling of tests/test_newton_mp.py:132 on a level with
    nx elements across."""
    h = 1.0 / nx
    kw = dict(beta_d=10.0 * (D_BEND / h ** 3 + MP_E * MP_H / h),
              beta_r=10.0 * D_BEND / h, w_order=2, params=SHELL_PARAMS)
    if pkg == "jax":
        from tigar_tpu.interface import EnergyNitscheCoupling
        energy = _jax_shell_energy
    else:
        from tigar_tpu_torch.interface import EnergyNitscheCoupling
        from tigar_tpu_torch.models.shell import svk_shell_energy as energy
    return EnergyNitscheCoupling(sp, 0, (0, 1), 1, (0, 0), energy, **kw)


def nitsche_solver(pkg):
    if pkg == "jax":
        from tigar_tpu.solvers.newton_stencil_mp import MultiPatchStencilNewton
    else:
        from tigar_tpu_torch.solvers.newton_stencil_mp import (
            MultiPatchStencilNewton)
    sps = [two_patch(pkg, *lv, clamps=ALL_SIDES) for lv in LEVELS]
    cps = [shell_nitsche(pkg, s, lv[0]) for s, lv in zip(sps, LEVELS)]
    return MultiPatchStencilNewton(sps[0], mp_density(pkg), cps[0],
                                   mg_splines=sps[1:], mg_couplings=cps[1:],
                                   cg_iters=25, polish_cg_iters=40)


def laplace_plate(pkg):
    """tests/test_interface.py's scalar two-patch plate (p=2, A 4x4, B
    4x6 elements, Dirichlet on the outer sides) with its Nitsche
    coupling (beta_d = 11, w_order = 1)."""
    if pkg == "jax":
        from tigar_tpu.ops.knots import uniform_knots
        from tigar_tpu.models.bspline import TensorBSplineBasis
        from tigar_tpu.models.multipatch import (MultiPatchBSplineBasis,
                                                 MultiPatchControlMesh)
        from tigar_tpu.models.space import EqualOrderSpline
        from tigar_tpu.models.extracted import ExtractedSpline
        from tigar_tpu.interface import EnergyNitscheCoupling
        energy, kw = _jax_laplace_energy, {}
    else:
        from tigar_tpu_torch.ops.knots import uniform_knots
        from tigar_tpu_torch.models.bspline import TensorBSplineBasis
        from tigar_tpu_torch.models.multipatch import (MultiPatchBSplineBasis,
                                                       MultiPatchControlMesh)
        from tigar_tpu_torch.models.space import EqualOrderSpline
        from tigar_tpu_torch.models.extracted import ExtractedSpline
        from tigar_tpu_torch.interface import EnergyNitscheCoupling
        energy, kw = _torch_laplace_energy, {"device": "cpu"}
    p, nel, nel_b = 2, 4, 6
    basis = MultiPatchBSplineBasis([
        TensorBSplineBasis([p, p], [uniform_knots(p, 0.0, 1.0, nel),
                                    uniform_knots(p, 0.0, 1.0, ny)])
        for ny in (nel, nel_b)])

    def bnet(patch, x_off):
        g = patch.greville_points()
        B = np.ones((g.shape[0], 3))
        B[:, 0] = g[:, 0] + x_off
        B[:, 1] = g[:, 1]
        return B

    cm = MultiPatchControlMesh(basis, [bnet(basis.patches[0], 0.0),
                                       bnet(basis.patches[1], 1.0)])
    gen = EqualOrderSpline(1, cm)
    gen.add_zero_dofs(0, basis.patch_side_dofs(0, 0, 0))
    gen.add_zero_dofs(0, basis.patch_side_dofs(1, 0, 1))
    for patch in (0, 1):
        for s in (0, 1):
            gen.add_zero_dofs(0, basis.patch_side_dofs(patch, 1, s))
    sp = ExtractedSpline(gen, quad_degree=2 * p, **kw)
    return sp, EnergyNitscheCoupling(sp, 0, (0, 1), 1, (0, 0), energy,
                                     beta_d=11.0, w_order=1)


def _jax_cast(form, dtype):
    from tigar_tpu.solvers.newton_stencil_mp import _cast_pytree
    return _cast_pytree(form, dtype)


def _jax_form_results(c, U, K=None):
    """energy, residual and (support, tangent block) of a JAX form at U;
    ``K``: the tangent block the solver's build already holds."""
    from tigar_tpu.interface import _iform_residual, _iform_tangent_block
    idx, pa, pb = c.support_positions()
    e = float(jax.jit(lambda u: c.energy(u))(U))
    r = np.asarray(_iform_residual(c, U))
    if K is None:
        K = _iform_tangent_block(c, U[idx], pa, pb, c.params)
    return e, r, (np.asarray(idx), np.asarray(K))


@pytest.fixture(scope="module")
def port():
    return nitsche_solver("torch")


@pytest.fixture(scope="module")
def jax_run(port):
    """The JAX solver's first two f32 steps, its full solve, and its
    operators, residuals and form results at a seeded smooth state (the
    solver's compiled builds and residuals are reused; the standalone
    energy and interface residual are compiled in f64 only, the port's f32
    results are held to them)."""
    ns = nitsche_solver("jax")
    U1, _, _ = ns.step(jnp.zeros(ns.spline.ndof))
    U2, _, _ = ns.step(U1)
    U, _, nit, _ = ns.solve(rtol=1e-10, max_iters=25)
    Us = mp_smooth_state(port)
    U64, U32 = jnp.asarray(Us), jnp.asarray(Us, dtype=jnp.float32)
    ops = {F64: ns._build(ns.asm_b64, U64), F32: ns._build(ns.asm_b32, U32)}
    res = {F64: np.asarray(ns._res(ns.asm64, ns.mask64, U64)),
           F32: np.asarray(ns._res(ns.asm32, ns.mask32, U32))}
    c64 = ns._c64[0]
    forms = {F64: _jax_form_results(c64, U64, K=ops[F64].ifaces[0].K),
             F32: (None, None, (np.asarray(c64.support),
                                np.asarray(ops[F32].ifaces[0].K)))}
    return dict(ns=ns, U1=np.array(U1), U2=np.array(U2), U=np.array(U),
                nit=nit, Us=Us, ops=ops, res=res, forms=forms,
                scale=ns._fine_omega_scale)


@pytest.fixture(scope="module")
def laplace():
    """The Laplace plate's JAX form and its f64 results at a seeded state,
    the port's own form and the JAX form carried across."""
    from tigar_tpu_torch import convert
    from tigar_tpu_torch.interface import (EnergyNitscheCoupling,
                                           NitscheDensity)
    jsp, jc = laplace_plate("jax")
    _, tc = laplace_plate("torch")
    U = np.random.default_rng(0).normal(size=jsp.ndof) * 0.1
    carried = convert.interface_from_numpy(
        convert.interface_arrays(jc), EnergyNitscheCoupling,
        NitscheDensity(_torch_laplace_energy, 1), jsp.ndof, device="cpu")
    return dict(jax=jc, forms=(tc, carried), U=U,
                ref=_jax_form_results(jc, jnp.asarray(U)))


def _case(name, port, jax_run, laplace):
    """(JAX form, port forms, state, f64 results) of one density."""
    if name == "laplace":
        return (laplace["jax"], laplace["forms"], laplace["U"],
                laplace["ref"])
    return (jax_run["ns"]._c64[0], (port._c64[0],), jax_run["Us"],
            jax_run["forms"][F64])


# -- the shell energy and the flux machinery ------------------------------------


def _close(a, b, tol):
    """max |a - b| <= tol max(|b|, 1) (b may be all zeros)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) <= tol * max(np.max(np.abs(b)), 1.0)


def _shell_points(n=5, seed=0):
    """Seeded reference Jacobians/Hessians and displacement jets of n
    points of a curved surface (numpy)."""
    rng = np.random.default_rng(seed)
    DF = np.tile(np.array([[1.0, 0.1], [0.05, 0.9], [0.2, -0.3]]), (n, 1, 1))
    DF += 0.05 * rng.normal(size=DF.shape)
    d2F = 0.2 * rng.normal(size=(n, 3, 2, 2))
    d2F = 0.5 * (d2F + d2F.transpose(0, 1, 3, 2))
    g = 0.02 * rng.normal(size=(n, 3, 2))
    h = 0.05 * rng.normal(size=(n, 3, 2, 2))
    return DF, d2F, g, 0.5 * (h + h.transpose(0, 1, 3, 2))


def _shell_ctx(ref):
    """The port's QP of the seeded points, with or without shell_ref."""
    from tigar_tpu_torch.forms import QP
    from tigar_tpu_torch.models.shell import shell_reference
    DF, d2F, _, _ = _shell_points()
    ctx = QP(xi=None, x=torch.zeros(len(DF), 3), w=None, wg=None, wh=None,
             DF=torch.as_tensor(DF), d2F=torch.as_tensor(d2F), g=None,
             ginv=None, sqrtJ=None, pinv=None)
    if ref:
        ctx = ctx._replace(aux={"shell_ref": shell_reference(ctx)})
    return ctx


@pytest.fixture(scope="module")
def jax_psi():
    """tigar_tpu's svk_psi_surface and its jet gradient at the seeded
    points (reference geometry recomputed: the ctx carries no aux)."""
    from tigar_tpu.forms import QP as JQP, Jet as JJet
    from tigar_tpu.models.shell import svk_psi_surface as jpsi

    def jval(DFq, d2Fq, gq, hq):
        ctx = JQP(xi=None, x=None, w=None, wg=None, wh=None, DF=DFq,
                  d2F=d2Fq, g=None, ginv=None, sqrtJ=None, pinv=None)
        return jpsi(ctx, JJet(jnp.zeros(3), gq, hq), MP_E, NU, MP_H)

    pts = _shell_points()
    val = jax.jit(jax.vmap(jval))(*pts)
    grads = jax.jit(jax.vmap(jax.grad(jval, argnums=(2, 3))))(*pts)
    return np.asarray(val), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("ref", [False, True], ids=["recomputed",
                                                    "shell_ref"])
def test_svk_psi_surface_matches_jax(jax_psi, ref):
    """Value and jet gradient of the SVK energy, reference geometry
    recomputed (as at the Nitsche shifted points) or read from shell_ref:
    1e-12."""
    from tigar_tpu_torch.forms import Jet
    from tigar_tpu_torch.models.shell import svk_psi_surface
    _, _, g, h = (torch.as_tensor(x) for x in _shell_points())
    ctx = _shell_ctx(ref)

    def psi(gq, hq):
        return svk_psi_surface(ctx, Jet(None, gq, hq), MP_E, NU, MP_H).sum()

    jv, (jg, jh) = jax_psi
    assert rel(svk_psi_surface(ctx, Jet(None, g, h), MP_E, NU, MP_H),
               jv) <= 1e-12
    tg, th = torch.func.grad(psi, argnums=(0, 1))(g, h)
    assert rel(tg, jg) <= 1e-12 and rel(th, jh) <= 1e-12


def test_svk_shell_adjoint_is_energy_gradient(jax_psi):
    """svk_shell_adjoint (the closed form K1/K2/K8/K9 evaluate) equals the
    jet gradient of svk_psi_surface: 1e-12; and the configuration's
    Taylor polynomial is X + y."""
    from tigar_tpu_torch.forms import Jet
    from tigar_tpu_torch.models.shell import (configuration_fn,
                                              svk_shell_adjoint)
    DF, d2F, g, h = _shell_points()
    F = svk_shell_adjoint(_shell_ctx(True), Jet(None, torch.as_tensor(g),
                                                torch.as_tensor(h)),
                          MP_E, NU, MP_H)
    _, (jg, jh) = jax_psi
    assert rel(F.g, jg) <= 1e-12 and rel(F.h, jh) <= 1e-12
    t = torch.as_tensor
    c0 = _shell_ctx(False)._replace(x=t(np.zeros(3)), DF=t(DF[0]),
                                    d2F=t(d2F[0]))
    y = Jet(t(np.ones(3)), t(g[0]), t(h[0]))
    d = np.array([0.1, -0.2])
    want = (DF[0] + g[0]) @ d + 1.0 + 0.5 * np.einsum(
        "icd,c,d->i", d2F[0] + h[0], d, d)
    assert rel(configuration_fn(c0, y)(t(d)), want) <= 1e-13


@pytest.mark.parametrize("side", ["a", "b"])
def test_taylor_shift_matches_jax(port, side):
    """The shifted geometry context and field jets of one side of the fine
    coupling at a nonzero offset: 1e-13."""
    from tigar_tpu.interface import (SideQP as JSideQP, Jet3 as JJet3,
                                     _side_ctx_at as j_ctx,
                                     _jet2_at as j_jet2)
    from tigar_tpu_torch.interface import Jet3, _side_ctx_at, _jet2_at
    cpl = port._c64[0]
    U = torch.as_tensor(np.random.default_rng(4).normal(
        size=port.spline.ndof) * 1e-2)
    delta = np.array([0.013, -0.021])
    for sd in (getattr(cpl, "side_" + side),):
        u3 = cpl._jets(U, sd)
        ctx = _side_ctx_at(sd.qp, torch.as_tensor(delta).expand(
            sd.qp.nu_flat.shape))
        jet = _jet2_at(u3, torch.as_tensor(delta).expand(
            sd.qp.nu_flat.shape))
        for q in (0, 7, sd.R0.shape[0] - 1):
            sq = JSideQP(**{k: (None if v is None
                                else jnp.asarray(v[q].numpy()))
                            for k, v in sd.qp._asdict().items()})
            jc = j_ctx(sq, jnp.asarray(delta))
            jj = j_jet2(JJet3(*[jnp.asarray(v[q].numpy()) for v in u3]),
                        jnp.asarray(delta))
            for name in ("xi", "x", "w", "wg", "wh", "DF", "d2F", "g",
                         "ginv", "sqrtJ", "pinv"):
                assert _close(getattr(ctx, name)[q], getattr(jc, name),
                              1e-13), name
            assert jc.aux is None and ctx.aux is None
            for a, b in zip(jet, jj):
                assert _close(a[q], b, 1e-13)
    assert isinstance(u3, Jet3) and u3.t3 is not None


@pytest.mark.parametrize("density", ["laplace", "shell"])
def test_convert_carries_nitsche_form(port, jax_run, laplace, density):
    """``convert`` carries a JAX EnergyNitscheCoupling (nested params,
    jets to order 3) across, and the port's own form tabulates the same
    data: 1e-13."""
    from tigar_tpu_torch import convert
    jc, forms, _, _ = _case(density, port, jax_run, laplace)
    arrs = convert.interface_arrays(jc)
    assert isinstance(arrs["params"]["w"], dict)
    assert arrs["nders"] == (2 if density == "laplace" else 3)
    for f in forms:
        got = convert.interface_arrays(f)
        assert got["params"] == arrs["params"]
        for side in ("side_a", "side_b"):
            for k in ("conn", "R0", "R1", "R2", "R3"):
                a, b = got[side][k], arrs[side][k]
                assert (a is None) == (b is None), k
                if a is not None:
                    assert np.array_equal(a, b) if k == "conn" \
                        else _close(a, b, 1e-13), k
            for k, v in arrs[side]["qp"].items():
                assert (v is None) == (got[side]["qp"][k] is None), k
                if v is not None:
                    assert _close(got[side]["qp"][k], v, 1e-13), k
        for k in ("wq", "nu", "w_param", "surfJ"):
            assert _close(got[k], arrs[k], 1e-13), k


@pytest.mark.parametrize("density", ["laplace", "shell"])
@pytest.mark.parametrize("dtype,tol", [(F64, 1e-11), (F32, 1e-5)])
def test_nitsche_form_matches_jax(port, jax_run, laplace, density, dtype,
                                  tol):
    """Energy, residual and tangent block of the port's form (and of the
    carried one) against JAX's: f64 1e-11, f32 1e-5 (the f32 tangent
    against JAX's f32 build, the rest against its f64 results)."""
    jc, forms, U, (e, r, (idx, K)) = _case(density, port, jax_run, laplace)
    if density == "shell":
        idx, K = jax_run["forms"][dtype][2]
    elif dtype == F32:
        from tigar_tpu.interface import _iform_tangent_block
        c32 = _jax_cast(jc, jnp.float32)
        _, pa, pb = c32.support_positions()
        K = np.asarray(_iform_tangent_block(
            c32, jnp.asarray(U, dtype=jnp.float32)[idx], pa, pb,
            c32.params))
    for f in forms:
        c = f.astype(dtype)
        # the f32 copies keep the stabilization as Python floats
        assert isinstance(c.params["beta_d"], float)
        Ut = torch.as_tensor(U, dtype=dtype)
        assert abs(float(c.energy(Ut)) - e) <= tol * abs(e)
        rt = c.residual(Ut)
        assert rt.dtype == dtype and rel(rt, r) <= tol
        it, Kt = c.tangent_block(Ut)
        assert np.array_equal(it, idx)
        assert Kt.dtype == dtype and rel(Kt, K) <= tol
    if dtype == F64:
        # the diagnostics the main path prints
        for name in ("jump_norm", "grad_jump_norm"):
            a = float(getattr(forms[0], name)(torch.as_tensor(U)))
            b = float(getattr(jc, name)(jnp.asarray(U)))
            assert abs(a - b) <= 1e-12 * abs(b), name


# -- the multi-patch solver with Nitsche couplings ------------------------------


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-11), (F32, 1e-5)])
def test_nitsche_build_matches_jax(port, jax_run, dtype, tol):
    """_build at a nonzero state: per-patch stencils, the Nitsche tangent
    block, and (f32) the Schwarz inverse and damping."""
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


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-11), (F32, 1e-5)])
def test_nitsche_residual_matches_jax(port, jax_run, dtype, tol):
    """The solver's masked residual (shell residual plus the Nitsche
    interface residual) at a nonzero state."""
    f64 = dtype == F64
    U = torch.as_tensor(jax_run["Us"], dtype=dtype)
    r = port._res(port.asm64 if f64 else port.asm32,
                  port.mask64 if f64 else port.mask32, U)
    assert r.dtype == dtype and rel(r, jax_run["res"][dtype]) <= tol


def test_nitsche_step_matches_jax(port, jax_run):
    """One production (f32) step from the same state: 1e-6."""
    U2, _, dU = port.step(torch.as_tensor(jax_run["U1"]))
    assert U2.dtype == F64 and dU.dtype == F64
    assert rel(U2, jax_run["U2"]) <= 1e-6


def test_nitsche_solve_matches_jax(port, jax_run):
    """The full solve with the f32 phase first, as bench.py runs its
    Nitsche point: the same step count +-1, U within 1e-7, the same
    jumps."""
    U, rel64, nit, _ = port.solve(rtol=1e-10, max_iters=25)
    assert rel64 < 1e-8, (rel64, nit)
    assert abs(nit - jax_run["nit"]) <= 1, (nit, jax_run["nit"])
    assert rel(U, jax_run["U"]) <= 1e-7
    cj = jax_run["ns"].couplings[0]
    for name in ("jump_norm", "grad_jump_norm"):
        a = float(getattr(port.couplings[0], name)(U))
        b = float(getattr(cj, name)(jnp.asarray(jax_run["U"])))
        assert abs(a - b) <= 1e-6 * b, name
