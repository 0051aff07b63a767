"""tigar_tpu_torch's sum-factorized operators against tigar_tpu's on the
same numpy inputs (CPU; the port's plain version of kernel K4).

Tolerances, relative to the largest entry of the JAX result: the operator
1e-12 in float64 (the same contractions summed in another order) and 1e-5
in float32 (the port computes in float32 from float32 tables, the
reference in float64); the right-hand side and the L2 error 1e-12.
Also: the port's entry points default to the card and raise without one.
"""

import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.ops.knots import uniform_knots as j_knots
from tigar_tpu.ops.refine import uniform_refine as j_refine
from tigar_tpu.models.bspline import (ExplicitBSplineControlMesh as JMesh,
                                      TensorBSplineBasis as JBasis)
from tigar_tpu.models.nurbs import NURBSControlMesh, quarter_annulus_control
from tigar_tpu.models.space import (EqualOrderSpline as JEqualOrder,
                                    FieldListSpline as JFieldList)
from tigar_tpu.models.extracted import ExtractedSpline as JSpline
from tigar_tpu.ops import sumfac as jsf

from tigar_tpu_torch.ops.knots import uniform_knots as t_knots
from tigar_tpu_torch.models.bspline import (ExplicitBSplineControlMesh
                                            as TMesh,
                                            TensorBSplineBasis as TBasis)
from tigar_tpu_torch.models.space import (EqualOrderSpline as TEqualOrder,
                                          SplineSpace as TFieldList)
from tigar_tpu_torch.models.extracted import ExtractedSpline as TSpline
from tigar_tpu_torch.ops import sumfac as tsf

from torch_parity import rel

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}

# name: (dim, p, nel, periodic directions or None, continuity_drop, ck, cm)
CASES = {
    "3d_open_k": (3, 2, 4, None, 0, 1.0, 0.0),
    "3d_open_km": (3, 2, 4, None, 0, 1.0, 3.0),
    "2d_p3": (2, 3, 5, None, 0, 1.0, 0.0),
    "2d_gather_drop1": (2, 2, 6, None, 1, 1.0, 0.5),
    "2d_periodic_tt": (2, 2, 6, (True, True), 0, 1.0, 0.7),
    "2d_periodic_tf": (2, 3, 5, (True, False), 0, 0.6, 1.0),
    "3d_periodic_identity": (3, 2, 4, (True, True, True), 0, 1.0, 0.7),
}


def _spline(pkg, dim, p, nel, periodic, drop, dtype=torch.float64):
    """The same scalar space in either package: Dirichlet on every side
    for open cases, a periodic field on the open identity mesh otherwise."""
    if pkg == "jax":
        knots, Mesh, Basis, EqualOrder, FieldList, Spline, kw = (
            j_knots, JMesh, JBasis, JEqualOrder, JFieldList, JSpline, {})
    else:
        knots, Mesh, Basis, EqualOrder, FieldList, Spline, kw = (
            t_knots, TMesh, TBasis, TEqualOrder, TFieldList, TSpline,
            {"device": "cpu", "dtype": dtype})
    mesh = Mesh([p] * dim, [knots(p, 0.0, 1.0, nel, continuity_drop=drop)]
                * dim)
    if periodic is None:
        sp = EqualOrder(1, mesh)
        basis = sp.fields[0]
        for d in range(dim):
            for side in (0, 1):
                sp.add_zero_dofs(0, basis.side_dofs(d, side))
    else:
        field = Basis([p] * dim, [knots(p, 0.0, 1.0, nel, periodic=per)
                                  for per in periodic])
        sp = FieldList(mesh, [field])
    return Spline(sp, quad_degree=2 * p, **kw)


_JAX_CACHE = {}


def _jax_case(name):
    """(W, JAX result) of a case, computed once per test process."""
    if name not in _JAX_CACHE:
        dim, p, nel, periodic, drop, ck, cm = CASES[name]
        sj = _spline("jax", dim, p, nel, periodic, drop)
        W = np.random.default_rng(len(name)).normal(size=sj.ndof)
        if name.endswith("identity"):
            op = jsf.make_sumfac_identity_operator(sj.space.fields[0], 2 * p,
                                                   ck=ck, cm=cm)
        else:
            op = jsf.make_sumfac_operator(sj, ck=ck, cm=cm)
        _JAX_CACHE[name] = (W, np.asarray(op(jnp.asarray(W))))
    return _JAX_CACHE[name]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(CASES))
def test_sumfac_operator(name, dtype):
    dim, p, nel, periodic, drop, ck, cm = CASES[name]
    W, r_jax = _jax_case(name)
    st = _spline("torch", dim, p, nel, periodic, drop, dtype)
    if name.endswith("identity"):
        op = tsf.make_sumfac_identity_operator(
            st.space.fields[0], 2 * p, ck=ck, cm=cm, dtype=dtype,
            device="cpu")
    else:
        op = tsf.make_sumfac_operator(st, ck=ck, cm=cm)
    r = op(torch.as_tensor(W, dtype=dtype))
    assert r.dtype == dtype and tuple(r.shape) == (st.ndof,)
    assert rel(r, r_jax) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_sumfac_rational_metric(dtype):
    """The metric path (G = qw sqrtJ g^-1 with off-diagonal terms) on the
    JAX package's quarter-annulus NURBS geometry, handed over as arrays."""
    degrees, kvecs, ctrl = quarter_annulus_control()
    kvecs, ctrl = j_refine(degrees, kvecs, ctrl, levels=2)
    sp = JEqualOrder(1, NURBSControlMesh(degrees, kvecs, ctrl))
    basis = sp.get_scalar_spline()
    for d in (0, 1):
        sp.add_zero_dofs(0, basis.side_dofs(d, 0))
    sj = JSpline(sp, quad_degree=6)
    W = np.random.default_rng(3).normal(size=sj.ndof)
    r_jax = np.asarray(jsf.make_sumfac_operator(sj, ck=2.0, cm=0.5)(
        jnp.asarray(W)))

    geom = types.SimpleNamespace(
        sqrtJ=torch.as_tensor(np.array(sj.geometry.sqrtJ)),
        ginv=torch.as_tensor(np.array(sj.geometry.ginv)))
    tbasis = TBasis(list(degrees), [kv.knots for kv in basis.kvs])
    data = tsf.build_sumfac_data(tbasis, geom, 6, device="cpu", dtype=dtype)
    mask = torch.as_tensor(np.asarray(sj.mask), dtype=dtype)
    r = tsf.sumfac_apply(data, torch.as_tensor(W, dtype=dtype), 2.0, 0.5,
                         mask)
    assert rel(r, r_jax) <= TOL[dtype]


# name: (dim, p, nel, periodic directions or None)
FORM_CASES = {
    "3d_open": (3, 2, 6, None),
    "2d_p3": (2, 3, 5, None),
    "2d_periodic_tf": (2, 3, 5, (True, False)),
    "3d_periodic": (3, 2, 4, (True, True, True)),
}


def _fn(mod):
    def f(*x):
        v = mod.sin(np.pi * x[0]) * mod.cos(x[1]) + x[0]
        return v * (1.0 + x[2] ** 2) if len(x) == 3 else v
    return f


@pytest.mark.parametrize("name", list(FORM_CASES))
def test_sumfac_linear_form_and_l2_error(name):
    dim, p, nel, periodic = FORM_CASES[name]
    per = periodic or (False,) * dim
    bj = JBasis([p] * dim, [j_knots(p, 0.0, 1.0, nel, periodic=q)
                            for q in per])
    bt = TBasis([p] * dim, [t_knots(p, 0.0, 1.0, nel, periodic=q)
                            for q in per])
    b_jax = np.asarray(jsf.sumfac_linear_form(bj, 2 * p, _fn(jnp)))
    b = tsf.sumfac_linear_form(bt, 2 * p, _fn(torch), device="cpu")
    assert rel(b, b_jax) <= 1e-12

    U = 0.1 * np.random.default_rng(0).normal(size=bj.ncp)
    e_jax = float(jsf.sumfac_l2_error(bj, 2 * p, jnp.asarray(U), _fn(jnp)))
    e = float(tsf.sumfac_l2_error(bt, 2 * p, torch.as_tensor(U), _fn(torch)))
    assert abs(e - e_jax) <= 1e-12 * e_jax


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the constructors raise unless the caller asks for
    the CPU; they never drop to the CPU by themselves."""
    from tigar_tpu_torch.convert import stencil_from_numpy
    from tigar_tpu_torch.solvers.multigrid import identity_poisson_multigrid
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = TEqualOrder(1, TMesh([2, 2], [t_knots(2, 0.0, 1.0, 4)] * 2))
    basis = space.fields[0]
    with pytest.raises(RuntimeError):
        TSpline(space, quad_degree=4)
    with pytest.raises(RuntimeError):
        tsf.make_sumfac_identity_operator(basis, 4)
    with pytest.raises(RuntimeError):
        identity_poisson_multigrid([basis], 4, [np.ones(basis.ncp)])
    with pytest.raises(RuntimeError):
        stencil_from_numpy(np.zeros((1, 1, 5, 5, 6, 6)), (6, 6), (2, 2), 1)
    spline = TSpline(space, quad_degree=4, device="cpu")
    assert spline.device.type == "cpu" and spline.mask.device.type == "cpu"
