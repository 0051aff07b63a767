"""tigar_tpu_torch's multi-patch operator, transfers and damping estimate
against tigar_tpu's on identical data (``convert``; no solver of the JAX
package is built here -- tests/test_torch_newton_mp_solve.py holds the
solver-level parity):

  - MultiPatchStencilOperator apply / residual / Jacobi / diagonal /
    multiplicative Schwarz, on the two-patch plate of tests/test_newton_mp.py
    and on its three-patch L, whose two interface supports share corner
    DoFs: 1e-12 (f64, Schwarz inverses in f64 on both sides);
  - MultiPatchProlong up and down against tigar_tpu's, built from its own
    insertion matrices: 1e-14;
  - _lam_max_jacobi from the same x0 on the same operator: 1e-8.
"""

import numpy as np
import pytest
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
