"""tigar_tpu_torch's space-agnostic Newton tier (solvers/newton_sa.py,
solvers/aggregation.py, the Krylov loops of solvers/linear.py) against
tigar_tpu's on the clamped 8x8 SVK plate of tests/test_newton_sa.py:33
(q=10), with the JAX solver of that test built once (cg_iters=60,
polish_cg_iters=80, coarse_size=100):

  - masked element matrices: f64 1e-12, f32 1e-5 (float32 jet-Jacobians);
  - ElemTangent apply, BC'd apply and diagonal on identical E: f64 1e-12,
    f32 1e-5;
  - the port's masked f64 element matrices of the plate and of the nel=4
    star T-spline are symmetric to 1e-13 (kernel K10 reads their upper
    triangles);
  - MultilevelSA.from_coo on the identical BC'd coo operator: level sizes
    equal, ELL arrays and om_dinv 1e-12, coarse inverse 1e-10;
  - kernel K11's sliced layout of those ELL arrays, through its plain
    version, against the carried arrays' plain product (f64): 1e-14; the
    fused "jacobi0" and "add" modes against their compositions: equal;
  - one V and one W cycle, linear and quadratic near-kernels, on the JAX
    hierarchy carried across (``convert.mlsa_from_numpy``), its f32 fine
    operator included: 1e-5 (float32 cycles, sums in another order);
  - cg/fcg/bicgstab_device_iters with a tolerance exit on seeded SPD and
    nonsymmetric systems: 1e-12;
  - the first f32 SANewton steps, multilevel and dense-inverse
    preconditioners: 1e-6 (f32 CG roundoff through the solve);
  - SANewton.solve: the same number of steps, U within 1e-8.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.solvers import aggregation as jagg
from tigar_tpu.solvers import linear as jlin
from tigar_tpu.solvers import newton_sa as jsa
from tigar_tpu_torch import convert
from tigar_tpu_torch.solvers import aggregation as tagg
from tigar_tpu_torch.solvers import linear as tlin
from tigar_tpu_torch.solvers.newton_sa import SANewton

from torch_parity import (build_jax, build_torch, jax_density,
                          torch_density, rel)

Q = 10.0
SA_KW = {"coarse_size": 100}
F32, F64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def jax_run():
    """tigar_tpu's SANewton: the first two f32 steps of its solve (the
    hierarchy built at the zero state), the masked element matrices at the
    first step's result, the dense-inverse first step, and the solve."""
    ns = jsa.SANewton(build_jax(8), jax_density(Q), cg_iters=60,
                      polish_cg_iters=80, sa_kwargs=SA_KW)
    U0 = jnp.zeros(ns.spline.ndof)
    U1 = ns.step(U0)[0]
    U2, rn2, _ = ns.step(U1)
    out = dict(ns=ns, mask=np.asarray(ns.mask64), U1=np.asarray(U1),
               U2=np.asarray(U2), rn2=float(rn2), levels=ns._sa.level_sizes,
               conn=np.asarray(ns.asm64.cat_conn))
    for tag, asm in (("f64", ns.asm64), ("f32", ns.asm32)):
        out["E" + tag] = np.asarray(ns._build(
            asm, U1.astype(asm.scale.dtype)).E)
    dense = jsa.SANewton(build_jax(8), jax_density(Q), cg_iters=60)
    out["U1_dense"] = np.asarray(dense.step(U0)[0])
    U, rel64, nit, _ = ns.solve(rtol=1e-9)
    out.update(U=np.asarray(U), rel=rel64, nit=nit)
    return out


def _port(**kw):
    kw.setdefault("sa_kwargs", SA_KW)
    return SANewton(build_torch(8), torch_density(Q), cg_iters=60,
                    polish_cg_iters=80, **kw)


@pytest.mark.parametrize("tag,tol", [("f64", 1e-12), ("f32", 1e-5)])
def test_element_matrices_match_jax(jax_run, tag, tol):
    ns = _port()
    asm = ns.asm64 if tag == "f64" else ns.asm32
    U = torch.as_tensor(jax_run["U1"], dtype=asm.dtype)
    st = ns._build(asm, U)
    assert st.E.dtype == asm.dtype
    assert np.array_equal(st.conn.numpy(), jax_run["conn"])
    assert rel(st.E, jax_run["E" + tag]) <= tol


@pytest.mark.parametrize("case", ["plate", "star"])
def test_plain_element_matrices_are_symmetric(jax_run, case):
    """The premise of kernel K10's upper-triangle read: the port's plain
    masked f64 element matrices, of the nel=8 plate at the first step's
    result and of the nel=4 star T-spline (1e-3 N(0, 1) on its free DoFs),
    are symmetric: max |E - E^T| <= 1e-13 max |E|."""
    if case == "plate":
        ns = _port()
        U = torch.as_tensor(jax_run["U1"])
    else:
        from tigar_tpu_torch.demos import star_tspline_shell as demo
        ns = demo.build(4, "cpu")
        U = ns.mask64 * torch.as_tensor(
            np.random.default_rng(0).normal(size=ns.spline.ndof) * 1e-3)
    E = ns._build(ns.asm64, U).E
    assert E.dtype == F64
    assert float((E - E.transpose(1, 2)).abs().max()
                 / E.abs().max()) <= 1e-13


def _jax_elem(jax_run, tag):
    dt = jnp.float64 if tag == "f64" else jnp.float32
    return jsa.ElemTangent(jnp.asarray(jax_run["conn"]),
                           jnp.asarray(jax_run["Ef64"], dtype=dt),
                           jax_run["ns"].spline.ndof)


@pytest.mark.parametrize("what", ["apply", "masked", "diagonal"])
@pytest.mark.parametrize("tag,tol", [("f64", 1e-12), ("f32", 1e-5)])
def test_elem_tangent_matches_jax(jax_run, what, tag, tol):
    dt = F64 if tag == "f64" else F32
    ej = _jax_elem(jax_run, tag)
    et = convert.elem_tangent_from_numpy(jax_run["conn"], jax_run["Ef64"],
                                         ej.ndof, "cpu", dt)
    x = np.random.default_rng(7).normal(size=ej.ndof)
    xj, xt = jnp.asarray(x, dtype=ej.E.dtype), torch.as_tensor(x, dtype=dt)
    m = jax_run["mask"].copy()
    if what == "apply":
        got, ref = et(xt), ej(xj)
    elif what == "masked":
        got = et.apply(xt, mask=torch.as_tensor(m, dtype=dt))
        ref = jsa._masked_act(ej, jnp.asarray(m, dtype=ej.E.dtype), xj)
    else:
        got, ref = et.diagonal(), ej.diagonal()
    assert got.dtype == dt and rel(got, ref) <= tol


def _coo(jax_run):
    """The BC'd coo operator SANewton hands to from_coo, at the f32
    element matrices of the first step's result."""
    ns = jax_run["ns"]
    n = ns.spline.ndof
    rows = np.concatenate([ns._rows_h, np.arange(n)])
    cols = np.concatenate([ns._cols_h, np.arange(n)])
    vals = np.concatenate([jax_run["Ef32"].reshape(-1).astype(np.float64),
                           1.0 - ns._mask_h])
    return (rows, cols, vals, n, ns._pts_dof, ns._mask_h), ns._field_of


@pytest.mark.parametrize("near_kernel", ["linear", "quadratic"])
def test_from_coo_matches_jax(jax_run, near_kernel):
    args, field_of = _coo(jax_run)
    kw = dict(field_of=field_of, near_kernel=near_kernel, coarse_size=50)
    saj = jagg.MultilevelSA.from_coo(*args, **kw)
    sat = tagg.MultilevelSA.from_coo(*args, device="cpu", **kw)
    assert sat.level_sizes == saj.level_sizes and sat.n_levels == 3
    aj, at = convert.mlsa_arrays(saj), convert.mlsa_arrays(sat)
    for lj, lt in zip(aj["levels"], at["levels"]):
        for k in lj:
            if k.endswith("cols"):
                assert np.array_equal(lj[k], lt[k]), k
            else:
                assert rel(lt[k], lj[k]) <= 1e-12, k
    assert rel(at["coarse_inv"], aj["coarse_inv"]) <= 1e-10


@pytest.fixture(scope="module")
def port_sa(jax_run):
    """The port's three-level hierarchy of the same coo operator (CPU)."""
    args, field_of = _coo(jax_run)
    return tagg.MultilevelSA.from_coo(*args, device="cpu", field_of=field_of,
                                      coarse_size=50)


@pytest.mark.parametrize("mode", ["apply", "residual", "jacobi", "jacobi0",
                                  "add"])
def test_sliced_ell_matches_carried_arrays(port_sa, mode):
    """Kernel K11's sliced layout of every level's A, P and Pt (f64),
    through its plain version, against the carried ELL arrays' plain
    product: 1e-14 of the largest entry (one sum order, trailing zero
    slots dropped); the fused modes' plain versions against their
    compositions: equal."""
    from tigar_tpu_torch.ops import sparse
    g = torch.Generator().manual_seed(5)
    for (A, P, Pt), lv in zip(port_sa._ops, port_sa._levels):
        for op in (A, P, Pt):
            if mode in ("jacobi", "jacobi0") and op is not A:
                continue
            vals = op.vals.double()
            sl = sparse.sliced_ell(op.cols, vals, op.ncols)
            assert int(sl.width.max()) % 4 == 0 and sl.fill()[0] == int(
                (vals != 0).sum())
            x, b = (torch.randn(k, generator=g, dtype=F64)
                    for k in (op.ncols, op.n))
            om = lv.om_dinv.double()
            x = None if mode == "jacobi0" else x
            want = sparse.ell_spmv_ref(op.cols, vals, x, b, om, mode)
            assert rel(sparse.sliced_ell_ref(sl, x, b, om, mode),
                       want) <= 1e-14
            if mode == "jacobi0":
                comp = sparse.ell_spmv_ref(op.cols, vals, om * b, b, om,
                                           "jacobi")
            elif mode == "add":
                comp = b + sparse.ell_spmv_ref(op.cols, vals, x)
            else:
                continue
            assert torch.equal(want, comp)


@pytest.mark.parametrize("cycle", ["V", "W"])
@pytest.mark.parametrize("near_kernel", ["linear", "quadratic"])
def test_cycle_matches_jax(jax_run, near_kernel, cycle):
    args, field_of = _coo(jax_run)
    m32 = jax_run["mask"].astype(np.float32)
    ej = _jax_elem(jax_run, "f32")
    saj = jagg.MultilevelSA.from_coo(
        *args, field_of=field_of, near_kernel=near_kernel, coarse_size=50,
        cycle=cycle, fine_op=ej, fine_mask=jnp.asarray(m32))
    et = convert.elem_tangent_from_numpy(jax_run["conn"], jax_run["Ef64"],
                                         ej.ndof, "cpu", F32)
    sat = convert.mlsa_from_numpy(convert.mlsa_arrays(saj), "cpu",
                                  fine_op=et, fine_mask=torch.as_tensor(m32))
    assert sat._cycle == cycle and sat.n_levels == 3
    r = np.random.default_rng(8).normal(size=ej.ndof) * jax_run["mask"]
    got = sat(torch.as_tensor(r))
    assert got.dtype == F64
    assert rel(got, saj(jnp.asarray(r))) <= 1e-5


def _systems():
    rng = np.random.default_rng(9)
    n = 40
    G = rng.normal(size=(n, n))
    spd = G @ G.T + n * np.eye(n)
    nonsym = spd + 0.3 * n * np.triu(rng.normal(size=(n, n)), 1)
    return spd, nonsym, rng.normal(size=n)


@pytest.mark.parametrize("name", ["cg", "fcg", "bicgstab"])
def test_krylov_device_iters_match_jax(name):
    spd, nonsym, b = _systems()
    A = nonsym if name == "bicgstab" else spd
    d = np.diag(A)
    fj = getattr(jlin, f"{name}_device_iters")
    ft = getattr(tlin, f"{name}_device_iters")
    Aj, Atc = jnp.asarray(A), torch.as_tensor(A)
    kw = dict(tol=1e-10, check_every=5)
    xj, rj = fj(lambda v: Aj @ v, jnp.asarray(b), 200,
                M=lambda r: r / jnp.asarray(d), **kw)
    xt, rt = ft(lambda v: Atc @ v, torch.as_tensor(b), 200,
                M=lambda r: r / torch.as_tensor(d), **kw)
    assert np.linalg.norm(rt.numpy()) <= 1e-10 * np.linalg.norm(b)
    assert rel(xt, xj) <= 1e-12
    assert rel(xt, np.linalg.solve(A, b)) <= 1e-8


@pytest.mark.parametrize("pre", ["multilevel", "dense"])
def test_step_matches_jax(jax_run, pre):
    """The first step from zero builds the preconditioner; with the
    multilevel one the second step, from tigar_tpu's first, is held too."""
    ns = _port() if pre == "multilevel" else _port(sa_kwargs={})
    U1 = ns.step(torch.zeros(ns.spline.ndof, dtype=F64))[0]
    assert U1.dtype == F64
    if pre == "dense":
        assert ns._sa.n_levels == 1
        assert rel(U1, jax_run["U1_dense"]) <= 1e-6
        return
    assert ns._sa.level_sizes == jax_run["levels"]
    assert rel(U1, jax_run["U1"]) <= 1e-6
    U2, rn2, _ = ns.step(torch.as_tensor(jax_run["U1"]))
    assert abs(float(rn2) - jax_run["rn2"]) <= 1e-5 * jax_run["rn2"]
    assert rel(U2, jax_run["U2"]) <= 1e-6


def test_solve_matches_jax(jax_run):
    ns = _port()
    U, rel64, nit, dU_rel = ns.solve(rtol=1e-9)
    assert rel64 < 1e-9
    assert abs(nit - jax_run["nit"]) <= 1, (nit, jax_run["nit"])
    assert rel(U, jax_run["U"]) <= 1e-8
    with pytest.raises(NotImplementedError):
        ns.solve_nested()


def test_sa_builds_on_the_card_by_default():
    """The hierarchy's device defaults to the card: without one the build
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = (np.arange(4), np.arange(4), np.ones(4), 4,
            np.zeros((4, 2)), np.ones(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tagg.MultilevelSA.from_coo(*args, coarse_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.elem_tangent_from_numpy(np.zeros((1, 1)), np.ones((1, 1, 1)),
                                        1)
