"""tigar_tpu_torch's multi-patch operator, transfers, damping estimate and
solver against tigar_tpu's.  On identical data (``convert``):

  - MultiPatchStencilOperator apply / residual / Jacobi / diagonal /
    multiplicative Schwarz, on the two-patch plate of tests/test_newton_mp.py
    and on its three-patch L, whose two interface supports share corner
    DoFs: 1e-12 (f64, Schwarz inverses in f64 on both sides);
  - MultiPatchProlong up and down against tigar_tpu's, built from its own
    insertion matrices: 1e-14;
  - _lam_max_jacobi from the same x0 on the same operator: 1e-8;
  - one V-cycle over all three levels on identical level data, through one
    MG-CG iteration of each package's make_stencil_mgcg (x1 = alpha M(b)):
    1e-12 in f64; in f32 the direction of x1 agrees within three times
    the larger of the two packages' own f32 rounding of it (each one's
    f32 cycle against its f64 cycle on the same data).  This is how the
    bench's penalty point's first f32 step was traced (ROADMAP C1): every
    quantity agrees to f32 rounding, the f32 cycles of both packages sit
    4e-5 from the exact one, and the CG step lengths amplify that.

The solver level (the last three tests), MultiPatchStencilNewton against
tigar_tpu's on the same plate (levels (16,16,20), (8,8,10), (4,4,5);
E=1e7, h=0.05, q=0.05; displacement + rotation penalty pd = 1e2 E h /
h_el, pr = 1e2 E h^3 / h_el; cg_iters=25, polish_cg_iters=40) with every
outer side clamped, as bench.py's two-patch point clamps it.  With the
cantilever clamping of tests/test_newton_mp.py the f32 CG's step lengths
carry ~1e-1 relative roundoff (f32 dot products that cancel), so no f32
step of two libraries agrees there; the fully clamped plate keeps the
f32 step comparable:

  - the operator built at a nonzero state (per-patch stencils, K): f64
    1e-11, f32 1e-5 (with the Schwarz inverse and the damping scale);
  - one production (f32) Newton step from the same state: 1e-6;
  - the full solve, from the f32 phase and with ``start_polish``: the same
    step count +-1, U within 1e-7, and the same interface jump and
    deflection.

They share the port solver of the operator tests; the JAX solver's
compiles (~110 s alone) run in this many-case file, before the tier-1
run's tail file, so that they do not slow that file down.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.ops.stencil import StencilOperator as JStencil
from tigar_tpu.solvers import newton_stencil_mp as jmp
from tigar_tpu_torch import convert
from tigar_tpu_torch.solvers import newton_stencil_mp as tmp

from torch_parity import (MP_LEVELS, MP_PD, MP_PR, l_shell, mp_density,
                          mp_smooth_state, mp_solver, rel, shell_coupling)

F32, F64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def port():
    return mp_solver("torch")


@pytest.fixture(scope="module")
def operators(port):
    """Operator data built by the port (f32 build with Schwarz inverses)
    for the two-patch plate and the three-patch L."""
    ops = {"two_patch": (port, port._build(
        port.asm_b32, torch.as_tensor(mp_smooth_state(port), dtype=F32)))}
    nels = ((8, 12), (10, 14), (12, 8))
    sps = [l_shell("torch", n) for n in
           (nels, tuple((a // 2, b // 2) for a, b in nels))]
    cps = [[shell_coupling("torch", s, MP_PD, MP_PR, w) for w in (0, 1)]
           for s in sps]
    ns = tmp.MultiPatchStencilNewton(sps[0], mp_density("torch"), cps[0],
                                     mg_splines=sps[1:],
                                     mg_couplings=cps[1:])
    U = 1e-3 * np.random.default_rng(4).normal(size=sps[0].ndof)
    ops["l_shell"] = (ns, ns._build(ns.asm_b32, ns.mask32 * torch.as_tensor(
        U, dtype=F32)))
    return ops


def _f64_arrays(op32):
    """The operator's arrays with the Schwarz inverses in f64, so both
    packages compute in one type."""
    arrays = convert.mp_operator_arrays(op32)
    arrays["Sinv"] = [Si.astype(np.float64) for Si in arrays["Sinv"]]
    return arrays


def _jax_operator(arrays):
    """tigar_tpu's MultiPatchStencilOperator from ``mp_operator_arrays``
    (f64)."""
    def f64(a):
        return jnp.asarray(a, dtype=jnp.float64)
    sts = [JStencil(f64(S), g, d, arrays["nf"])
           for S, g, d in zip(arrays["S"], arrays["grid_shape"],
                              arrays["degrees"])]
    blocks = [jmp.IfaceBlock(jnp.asarray(i), f64(K), f64(Si))
              for i, K, Si in zip(arrays["idx"], arrays["K"],
                                  arrays["Sinv"])]
    return jmp.MultiPatchStencilOperator(sts, blocks, arrays["foffsets"],
                                         arrays["doffsets"], arrays["nf"])


@pytest.mark.parametrize("what", ["apply", "residual", "jacobi", "diagonal",
                                  "schwarz"])
@pytest.mark.parametrize("case", ["two_patch", "l_shell"])
def test_mp_operator_matches_jax(operators, case, what):
    ns, op32 = operators[case]
    arrays = _f64_arrays(op32)
    op = convert.mp_operator_from_numpy(arrays, "cpu", F64)
    opj = _jax_operator(arrays)
    if case == "l_shell":      # the two supports share corner DoFs
        ia, ib = (set(blk.idx.tolist()) for blk in op.ifaces)
        assert ia & ib
    rng = np.random.default_rng(5)
    x, b = rng.normal(size=op.ndof), rng.normal(size=op.ndof)
    m = ns.mask64.numpy()
    mj, xj, bj = jnp.asarray(m), jnp.asarray(x), jnp.asarray(b)
    act = mj * opj(mj * xj) + (1.0 - mj) * xj
    d = np.asarray(opj.diagonal())
    dinv = 1.0 / (m * d + (1.0 - m))
    tx, tb, tm = (torch.as_tensor(v) for v in (x, b, m))
    if what == "diagonal":
        got, ref = op.diagonal(), d
    elif what == "schwarz":
        got, ref = op.schwarz(tb, tm), opj.schwarz(bj, mj)
    else:
        got = op.apply(tx, mask=tm, b=tb, dinv=torch.as_tensor(dinv),
                       omega=0.7, mode=what)
        ref = {"apply": act, "residual": bj - act,
               "jacobi": xj + 0.7 * dinv * (bj - act)}[what]
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("direction", ["up", "down"])
def test_prolong_matches_jax(port, direction):
    """Each level transfer of the port against tigar_tpu's, built from its
    own bases and insertion matrices (host numpy, no JAX solver)."""
    from tigar_tpu.models.bspline import TensorBSplineBasis
    from tigar_tpu.models.multipatch import MultiPatchBSplineBasis
    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.solvers.multigrid import insertion_matrix_1d
    bases = [MultiPatchBSplineBasis([
        TensorBSplineBasis([2, 2], [uniform_knots(2, 0.0, 1.0, nx),
                                    uniform_knots(2, 0.0, 1.0, ny)])
        for ny in (nay, nby)]) for nx, nay, nby in MP_LEVELS]
    nf = 3
    for lev, Pt in enumerate(port._Ps):
        bf, bc = bases[lev], bases[lev + 1]
        Ps = [tuple(jnp.asarray(insertion_matrix_1d(kc, kf))
                    for kc, kf in zip(reversed(pc.kvs), reversed(pf.kvs)))
              for pf, pc in zip(bf.patches, bc.patches)]
        shapes = [[tuple(kv.ncp for kv in reversed(pt.kvs))
                   for pt in b.patches] for b in (bf, bc)]
        Pj = jmp.MultiPatchProlong(
            Ps, nf, shapes[0], shapes[1], [f * bf.ncp for f in range(nf)],
            [f * bc.ncp for f in range(nf)], bf.doffsets, bc.doffsets)
        n = nf * (bc if direction == "up" else bf).ncp
        x = np.random.default_rng(6).normal(size=n)
        got = getattr(Pt, direction)(torch.as_tensor(x))
        ref = getattr(Pj, direction)(jnp.asarray(x))
        assert got.dtype == F64 and rel(got, ref) <= 1e-14


def test_lam_max_matches_jax(operators):
    """Power iteration from the same x0 on the same (f64) operator."""
    ns, op32 = operators["two_patch"]
    arrays = _f64_arrays(op32)
    op = convert.mp_operator_from_numpy(arrays, "cpu", F64)
    opj = _jax_operator(arrays)
    x0 = np.random.default_rng(0).normal(size=op.ndof)
    lam_t = float(tmp._lam_max_jacobi(op, ns.mask64, torch.as_tensor(x0)))
    lam_j = float(jmp._lam_max_jacobi(opj, jnp.asarray(ns.mask64.numpy()),
                                      jnp.asarray(x0)))
    assert abs(lam_t - lam_j) <= 1e-8 * lam_j


def _jax_prolongs():
    """tigar_tpu's level transfers of the two-patch setting, built from its
    own bases and insertion matrices as in test_prolong_matches_jax."""
    from tigar_tpu.models.bspline import TensorBSplineBasis
    from tigar_tpu.models.multipatch import MultiPatchBSplineBasis
    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.solvers.multigrid import insertion_matrix_1d
    bases = [MultiPatchBSplineBasis([
        TensorBSplineBasis([2, 2], [uniform_knots(2, 0.0, 1.0, nx),
                                    uniform_knots(2, 0.0, 1.0, ny)])
        for ny in (nay, nby)]) for nx, nay, nby in MP_LEVELS]
    out = []
    for bf, bc in zip(bases[:-1], bases[1:]):
        Ps = [tuple(jnp.asarray(insertion_matrix_1d(kc, kf))
                    for kc, kf in zip(reversed(pc.kvs), reversed(pf.kvs)))
              for pf, pc in zip(bf.patches, bc.patches)]
        shapes = [[tuple(kv.ncp for kv in reversed(pt.kvs))
                   for pt in b.patches] for b in (bf, bc)]
        out.append(jmp.MultiPatchProlong(
            Ps, 3, shapes[0], shapes[1], [f * bf.ncp for f in range(3)],
            [f * bc.ncp for f in range(3)], bf.doffsets, bc.doffsets))
    return out


def _cast(tree, dtype):
    """A tigar_tpu pytree with its floating leaves in ``dtype``."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, tree)


def test_vcycle_matches_jax(operators):
    """One V-cycle (fine f32 build at a state, the zero-state coarse
    levels, the dense coarsest inverse) on identical data in both
    packages, seen through one MG-CG iteration: see the module
    docstring."""
    from tigar_tpu.solvers.newton_stencil import make_stencil_mgcg as jmgcg
    from tigar_tpu_torch.solvers.newton_stencil import (
        make_stencil_mgcg as tmgcg)
    ns, op32 = operators["two_patch"]
    ops = [op32] + list(ns._coarse_sts)
    masks = [ns.mask32] + list(ns._coarse_masks)
    dinvs = [ns._fine_dinv(op32)] + list(ns._coarse_dinvs)
    b = masks[0].numpy() * np.random.default_rng(7).normal(size=op32.ndof)
    x1 = {}
    arrays = [_f64_arrays(op) for op in ops]   # f32 values, held in f64
    cinv = ns._coarse_inv.numpy()
    for tdt, jdt in ((F64, jnp.float64), (F32, jnp.float32)):
        x1["port", tdt] = tmgcg(len(ops), n_iters=1)(
            [convert.mp_operator_from_numpy(
                dict(a, Sinv=[Si.astype(np.float32 if tdt == F32 else
                                        np.float64) for Si in a["Sinv"]]),
                "cpu", tdt) for a in arrays],
            [m.to(tdt) for m in masks], [d.to(tdt) for d in dinvs], ns._Ps,
            torch.as_tensor(cinv, dtype=tdt), torch.as_tensor(b, dtype=tdt))
        x1["jax", tdt] = jmgcg(len(ops), n_iters=1)(
            _cast([_jax_operator(a) for a in arrays], jdt),
            [jnp.asarray(m.numpy(), dtype=jdt) for m in masks],
            [jnp.asarray(d.numpy(), dtype=jdt) for d in dinvs],
            _cast(_jax_prolongs(), jdt),
            jnp.asarray(cinv, dtype=jdt), jnp.asarray(b, dtype=jdt))
    assert rel(x1["port", F64], x1["jax", F64]) <= 1e-12

    def unit(x):
        x = np.asarray(x, dtype=np.float64)
        return x / np.linalg.norm(x)
    own = max(rel(unit(x1[p, F32]), unit(x1[p, F64])) for p in ("port", "jax"))
    assert 0.0 < own <= 1e-3
    assert rel(unit(x1["port", F32]), unit(x1["jax", F32])) <= 3.0 * own


def test_solver_checks_its_arguments(port):
    sp, cp = port.spline, port.couplings[0]
    dens = mp_density("torch")
    with pytest.raises(ValueError, match="at least one interface"):
        tmp.MultiPatchStencilNewton(sp, dens, [], mg_splines=port.mg_splines,
                                    mg_couplings=[[], []])
    with pytest.raises(ValueError, match="one mg_coupling"):
        tmp.MultiPatchStencilNewton(sp, dens, cp, mg_splines=port.mg_splines,
                                    mg_couplings=[])
    with pytest.raises(ValueError, match="coarser"):
        tmp.MultiPatchStencilNewton(sp, dens, cp)


# -- the solver: MultiPatchStencilNewton against tigar_tpu's ----------------


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
