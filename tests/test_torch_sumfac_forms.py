"""tigar_tpu_torch's sum-factorized forms (ops/sumfac_forms.py, the plain
versions of kernels K15/K16) against tigar_tpu's on the same numpy
inputs, on the CPU, for every space family of tests/test_sumfac_forms.py:
rational (NURBS) geometry, RT multi-field with per-field degrees, reduced
continuity (strided slide windows), periodic knots (gather windows) and
3D.  The SVK shell's residual and tangent action are in
tests/test_torch_sumfac_shell.py.

Tolerances, relative to the largest entry of the JAX result: f64 1e-12
(the same contractions summed in another order; tables, metas and
NURBS control nets exactly equal), jets and their transpose 1e-13.  Each
JAX assembler runs its residuals under ``jax.jit`` (one compile per
case).  Also: the port's sumfac assembler against the port's generic
assembler on the same cases, ``convert`` carrying a JAX assembler across,
NURBSControlMesh's control net, and the entry points defaulting to the
card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.ops.knots import uniform_knots as j_knots
from tigar_tpu.models.bspline import (ExplicitBSplineControlMesh as JMesh,
                                      TensorBSplineBasis as JBasis)
from tigar_tpu.models.nurbs import (NURBSControlMesh as JNURBS,
                                    quarter_annulus_control as j_annulus)
from tigar_tpu.models.space import (EqualOrderSpline as JEqualOrder,
                                    FieldListSpline as JFieldList)
from tigar_tpu.models.extracted import ExtractedSpline as JSpline
from tigar_tpu.ops import sumfac_forms as jsf

from tigar_tpu_torch import convert
from tigar_tpu_torch.ops.knots import uniform_knots as t_knots
from tigar_tpu_torch.models.bspline import (ExplicitBSplineControlMesh
                                            as TMesh,
                                            TensorBSplineBasis as TBasis)
from tigar_tpu_torch.models.nurbs import (NURBSControlMesh as TNURBS,
                                          quarter_annulus_control
                                          as t_annulus)
from tigar_tpu_torch.models.space import (EqualOrderSpline as TEqualOrder,
                                          FieldListSpline as TFieldList)
from tigar_tpu_torch.models.extracted import ExtractedSpline as TSpline
from tigar_tpu_torch.ops import sumfac_forms as tsf

from torch_parity import rel

F64 = torch.float64


# -- the spaces of tests/test_sumfac_forms.py, in either package -------------


def _distorted_grid(gp, n0, n1):
    w = 1.0 + 0.3 * gp[:, 0] * gp[:, 1]
    B = np.zeros((gp.shape[0], 3))
    B[:, 0] = (gp[:, 0] + 0.1 * gp[:, 1] ** 2) * w
    B[:, 1] = (gp[:, 1] + 0.05 * np.sin(3 * gp[:, 0])) * w
    B[:, 2] = w
    return B.reshape(n1, n0, 3).transpose(1, 0, 2)


def _periodic_mesh(basis):
    gp = basis.greville_points()
    B = np.zeros((basis.ncp, 3))
    B[:, :2] = gp
    B[:, 2] = 1.0

    class PCM:
        nsd = 2

        def scalar_basis(self):
            return basis

        def homogeneous_points(self):
            return B

    return PCM()


def make_spline(pkg, case):
    """(spline, form key) of one case in tigar_tpu ("jax") or the port."""
    jx = pkg == "jax"
    uk = j_knots if jx else t_knots
    Mesh, Basis = (JMesh, JBasis) if jx else (TMesh, TBasis)
    EqualOrder = JEqualOrder if jx else TEqualOrder
    kw = {} if jx else {"device": "cpu"}

    def spline(space, **opts):
        return (JSpline if jx else TSpline)(space, **opts, **kw)

    if case in ("nurbs", "functional"):
        kv = uk(2, 0.0, 1.0, 5)
        basis = Basis([2, 2], [kv, kv])
        n0, n1 = basis.ncp_per_dir
        cm = (JNURBS if jx else TNURBS)(
            [2, 2], [kv, kv], _distorted_grid(basis.greville_points(), n0,
                                              n1))
        return spline(EqualOrder(1, cm), quad_degree=4), "poisson"
    if case == "rt":
        from tigar_tpu.models.compatible import generate_fields_compat as jg
        from tigar_tpu_torch.models.compatible import (
            generate_fields_compat as tg)
        cm = Mesh([1, 1], [uk(1, 0., 1., 4)] * 2)
        fields = (jg if jx else tg)(cm, "RT", [1, 1])
        return spline((JFieldList if jx else TFieldList)(cm, fields),
                      quad_degree=4, nders=1, geom_nders=2), "rt"
    if case == "reduced":
        kvr = uk(2, 0.0, 1.0, 5, continuity_drop=1)
        return (spline(EqualOrder(1, Mesh([2, 2], [kvr, kvr])),
                       quad_degree=4), "poisson")
    if case == "periodic":
        basis = Basis([2, 2], [uk(2, 0.0, 1.0, 6, periodic=True),
                               uk(2, 0.0, 1.0, 4)])
        return (spline(EqualOrder(1, _periodic_mesh(basis)), quad_degree=4),
                "poisson")
    assert case == "3d"
    cm = Mesh([2, 2, 2], [uk(2, 0., 1., 3)] * 3)
    return spline(EqualOrder(1, cm), quad_degree=4), "poisson"


def j_poisson(ctx, u, v):
    uu, vv = ctx.rationalize(u), ctx.rationalize(v)
    return jnp.dot(ctx.grad(uu), ctx.grad(vv)) - 1.0 * vv.val


def t_poisson(ctx, u, v):
    uu, vv = ctx.rationalize(u), ctx.rationalize(v)
    return torch.dot(ctx.grad(uu), ctx.grad(vv)) - 1.0 * vv.val


def j_rt(ctx, u, v):
    up, vp = ctx.pushforward_RT(u), ctx.pushforward_RT(v)
    return ctx.div(up) * ctx.div(vp) + jnp.dot(up.val, vp.val)


def t_rt(ctx, u, v):
    up, vp = ctx.pushforward_RT(u), ctx.pushforward_RT(v)
    return ctx.div(up) * ctx.div(vp) + torch.dot(up.val, vp.val)


FORMS = {"poisson": (j_poisson, t_poisson), "rt": (j_rt, t_rt)}
CASES = ["nurbs", "rt", "reduced", "periodic", "3d"]


@pytest.fixture(scope="module")
def built():
    """Per case: the JAX spline and SumfacAssembler, the port's spline and
    SumfacAssembler, a seeded state and JAX's residual there (jitted)."""
    out = {}
    rng = np.random.default_rng(7)
    for case in CASES:
        jsp, key = make_spline("jax", case)
        tsp, _ = make_spline("torch", case)
        jasm = jsf.make_sumfac_assembler(jsp)
        U = rng.normal(size=jsp.ndof)
        jform = FORMS[key][0]
        r = jax.jit(lambda a, u, f=jform: a.residual_vector(f, u))(
            jasm, jnp.asarray(U))
        out[case] = dict(jsp=jsp, jasm=jasm, tsp=tsp,
                         tasm=tsf.make_sumfac_assembler(tsp), U=U,
                         r=np.asarray(r), key=key)
    # tests/test_sumfac_forms.py:174 draws its own state on the NURBS patch
    out["functional"] = dict(out["nurbs"], U=rng.normal(
        size=out["nurbs"]["jsp"].ndof))
    return out


# -- tables, metas, jets ------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_plans_match_jax(built, case):
    """Metas (mode, start0, stride, nel, pp) and the 1D tables and gather
    windows of every field: identical to JAX's."""
    b = built[case]
    ja, ta = b["jasm"], b["tasm"]
    assert ta.metas == ja.metas and ta.ncp_ds == ja.ncp_ds
    assert ta.nders == ja.nders and ta.offsets == ja.offsets
    for jt, tt in zip(ja.tabs, ta.tabs):
        for x, y in zip(jt, tt):
            assert np.array_equal(y.numpy(), np.asarray(x))
    for ji, ti in zip(ja.idxs, ta.idxs):
        for x, y in zip(ji, ti):
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(y.numpy(), np.asarray(x))
    if case == "reduced":
        assert all(m[0] == "slide" and m[2] == 2 for m in ta.metas[0])
    if case == "periodic":
        assert ta.metas[0][0][0] == "gather"
        assert ta.metas[0][1][0] == "slide"
    if case == "rt":
        assert ta.layout.M == 2 and len(ta.layout.groups) == 2


@pytest.mark.parametrize("case", CASES)
def test_jets_and_transpose_match_jax(built, case):
    """The jets of a seeded vector and the transpose of seeded jet
    cotangents against JAX's jets and scatter_jets (1e-13); the adjoint
    identity <E u, c> = <u, E^T c> (1e-13)."""
    b = built[case]
    ja, ta = b["jasm"], b["tasm"]
    U = b["U"]
    jj = jax.jit(lambda a, u: a.jets(u))(ja, jnp.asarray(U))
    tj = ta.jets(torch.as_tensor(U))
    for x, y in zip(jj, tj):
        assert (x is None) == (y is None)
        if x is not None:
            assert tuple(y.shape) == x.shape and rel(y, x) <= 1e-13
    rng = np.random.default_rng(11)
    cot = [None if x is None else rng.normal(size=x.shape) for x in jj]
    from tigar_tpu.forms import Jet as JJet
    from tigar_tpu_torch.forms import Jet
    rj = jax.jit(lambda a, c: a.scatter_jets(c))(
        ja, JJet(*[None if c is None else jnp.asarray(c) for c in cot]))
    rt = ta.scatter_jets(Jet(*[None if c is None else torch.as_tensor(c)
                               for c in cot]))
    assert rel(rt, rj) <= 1e-13
    lhs = sum(float((y * torch.as_tensor(c)).sum())
              for y, c in zip(tj, cot) if c is not None)
    rhs = float((torch.as_tensor(U) * rt).sum())
    assert abs(lhs - rhs) <= 1e-13 * max(abs(rhs), 1.0)


@pytest.mark.parametrize("mode", ["slide", "strided", "gather"])
def test_field_jets_plain_matches_jax(mode):
    """field_jets_plain on one field, W [ncp] and a batch of columns
    [m, ncp], against JAX's field_jets (nders 2): 1e-13."""
    if mode == "slide":
        kvs = [(3, 0.0, 1.0, 4, False, 0), (2, 0.0, 2.0, 5, False, 0)]
    elif mode == "strided":
        kvs = [(2, 0.0, 1.0, 4, False, 1), (3, 0.0, 1.0, 3, False, 2)]
    else:
        kvs = [(2, 0.0, 1.0, 5, True, 0), (3, 0.0, 1.0, 4, True, 0)]
    jb = JBasis([k[0] for k in kvs], [j_knots(p, a, b, n, periodic=pe,
                                             continuity_drop=cd)
                                     for p, a, b, n, pe, cd in kvs])
    tb = TBasis([k[0] for k in kvs], [t_knots(p, a, b, n, periodic=pe,
                                             continuity_drop=cd)
                                     for p, a, b, n, pe, cd in kvs])
    jp, tp = jsf.FieldPlan(jb, 4, 2), tsf.FieldPlan(tb, 4, 2)
    assert tp.meta() == jp.meta()
    assert {m[0] for m in tp.meta()} == {"slide" if mode != "gather"
                                         else "gather"}
    W = np.random.default_rng(5).normal(size=(3, tp.ncp))
    jtabs = tuple(t.T for t in jp.tables)
    jidx = tuple(t.idx for t in jp.tables)
    ttabs = tuple(torch.as_tensor(t.T) for t in tp.tables)
    tidx = tuple(None if t.idx is None else torch.as_tensor(
        t.idx.astype(np.int64)) for t in tp.tables)
    for c in range(3):
        want = jsf.field_jets(jnp.asarray(W[c]), jtabs, jidx, jp.meta(),
                              jp.ncp_d, 2)
        got = tsf.field_jets_plain(torch.as_tensor(W[c]), ttabs, tidx,
                                   tp.meta(), tp.ncp_d, 2)
        batch = tsf.field_jets_plain(torch.as_tensor(W), ttabs, tidx,
                                     tp.meta(), tp.ncp_d, 2)
        for x, y, z in zip(want, got, batch):
            assert rel(y, x) <= 1e-13 and rel(z[:, c], x) <= 1e-13


def _k16_cover(plan, d):
    """{(coefficient, element, slot)} that kernel K16's gather pass visits
    in direction d, by its rule (csrc/sumfac_jets.cu ``cover``): a slide
    window's candidates solved from start / stride, a gather direction's
    inverse lists; a Counter, so a pair visited twice shows."""
    from collections import Counter
    _, _, inv, starts, strides = plan.kernel_args()
    _, _, _, nel, pp = plan.metas[d]
    ncp = plan.ncp_d[d]
    out = Counter()
    for i in range(ncp):
        if inv[d].numel():
            ptr = inv[d][:ncp + 1].tolist()
            for ent in inv[d][ncp + 1 + ptr[i]:ncp + 1 + ptr[i + 1]].tolist():
                out[(i, ent // pp, ent % pp)] += 1
            continue
        for k in range(pp):
            n = i - starts[d] - k
            if n >= 0 and n % strides[d] == 0 and n // strides[d] < nel:
                out[(i, n // strides[d], k)] += 1
    return out


@pytest.mark.parametrize("case", ["slide", "strided", "gather", "3d",
                                  "reduced"])
def test_k16_cover_visits_each_pair_once(built, case):
    """K16's gather pass visits each (coefficient, covering element,
    window slot) pair of every direction exactly once: its rule against
    the forward windows of the plan (start0 + stride e + a, or the gather
    windows)."""
    from collections import Counter
    if case == "strided":
        b = TBasis([2, 3], [t_knots(2, 0., 1., 4, continuity_drop=1),
                            t_knots(3, 0., 1., 3, continuity_drop=2)])
        plans = [tsf.DevicePlan(tsf.FieldPlan(b, 3, 1), "cpu",
                                torch.float64)]
        assert [m[2] for m in plans[0].metas] == [2, 3]
    else:
        key = {"slide": "nurbs", "gather": "periodic"}.get(case, case)
        plans = [g.plan for g in built[key]["tasm"].layout.groups]
    modes = set()
    for plan in plans:
        for d, (mode, s0, m, nel, pp) in enumerate(plan.metas):
            modes.add(mode)
            want = Counter()
            for e in range(nel):
                for a in range(pp):
                    i = (int(plan.idxs[d][e, a]) if mode == "gather"
                         else s0 + m * e + a)
                    want[(i, e, a)] += 1
            assert _k16_cover(plan, d) == want
    assert modes == ({"gather", "slide"} if case == "gather" else {"slide"})


def test_sumfac_geometry_matches_jax(built):
    """The geometry ctx leaves and weights on the distorted NURBS patch
    (rational, nders 2) against JAX's sumfac_geometry: 1e-13."""
    jsp, tsp = built["nurbs"]["jsp"], built["nurbs"]["tsp"]
    jctx, jqw, _ = jsf.sumfac_geometry(jsp.control_basis, jsp.bnet, 4)
    tctx, tqw, _ = tsf.sumfac_geometry(tsp.control_basis, tsp.bnet, 4,
                                       device="cpu")
    assert rel(tqw, jqw) <= 1e-13
    for k in jctx._fields:
        a, b = getattr(jctx, k), getattr(tctx, k)
        assert (a is None) == (b is None), k
        if a is not None and k != "aux":
            assert tuple(b.shape) == a.shape and rel(b, a) <= 1e-13, k


# -- assembly -------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_residual_matches_jax(built, case):
    """The residual against JAX's SumfacAssembler (1e-12) and against the
    port's generic tabulated assembler (1e-12)."""
    b = built[case]
    tform = FORMS[b["key"]][1]
    U = torch.as_tensor(b["U"])
    r = b["tasm"].residual_vector(tform, U)
    assert r.dtype == F64 and tuple(r.shape) == (b["tsp"].ndof,)
    assert rel(r, b["r"]) <= 1e-12
    r_gen = b["tsp"]._assembler("dx").residual_vector(tform, U)
    assert rel(r, r_gen) <= 1e-12


def test_functional_and_linear_match_jax(built):
    """functional and linear_vector (tests/test_sumfac_forms.py:174)
    against JAX's sumfac assembler and the port's generic one: 1e-12."""
    b = built["functional"]
    ja, ta, tsp = b["jasm"], b["tasm"], b["tsp"]
    U = b["U"]

    def jenergy(ctx, u):
        return jnp.sum(ctx.rationalize(u).val ** 2)

    def tenergy(ctx, u):
        return torch.sum(ctx.rationalize(u).val ** 2)

    def jload(ctx, v):
        return ctx.x[0] * ctx.rationalize(v).val

    def tload(ctx, v):
        return ctx.x[0] * ctx.rationalize(v).val

    f_j = float(jax.jit(lambda a, u: a.functional(jenergy, u))(
        ja, jnp.asarray(U)))
    f_t = float(ta.functional(tenergy, torch.as_tensor(U)))
    f_g = float(tsp._assembler("dx").functional(tenergy, torch.as_tensor(U)))
    assert abs(f_t - f_j) <= 1e-12 * abs(f_j)
    assert abs(f_t - f_g) <= 1e-12 * abs(f_j)
    b_j = jax.jit(lambda a: a.linear_vector(jload))(ja)
    b_t = ta.linear_vector(tload)
    assert rel(b_t, b_j) <= 1e-12
    assert rel(b_t, tsp._assembler("dx").linear_vector(tload)) <= 1e-12


def test_tangent_action_with_aux_fields_matches_jax(built):
    """tangent_action of a nonlinear density with a dict state (the
    unknown under "u", a known field beside it) against JAX's (jitted):
    1e-12."""
    b = built["3d"]
    ja, ta = b["jasm"], b["tasm"]
    rng = np.random.default_rng(13)
    U, F, W = (rng.normal(size=ja.ndof) for _ in range(3))

    def jdens(ctx, s, v):
        u, f = s["u"], s["f"]
        return (1.0 + u.val ** 2) * jnp.dot(ctx.grad(u), ctx.grad(v)) \
            + f.val * u.val * v.val

    def tdens(ctx, s, v):
        u, f = s["u"], s["f"]
        return (1.0 + u.val ** 2) * torch.dot(ctx.grad(u), ctx.grad(v)) \
            + f.val * u.val * v.val

    want = jax.jit(lambda a, s, w: a.tangent_action(jdens, s, w))(
        ja, {"u": jnp.asarray(U), "f": jnp.asarray(F)}, jnp.asarray(W))
    got = ta.tangent_action(tdens, {"u": torch.as_tensor(U),
                                    "f": torch.as_tensor(F)},
                            torch.as_tensor(W))
    assert rel(got, want) <= 1e-12


def test_pushforwards_match_jax(built):
    """QP.pushforward_RT / _N / _W at points of the 3D geometry with
    seeded parametric jets against JAX's: 1e-13."""
    from tigar_tpu.forms import Jet as JJet
    from tigar_tpu_torch.forms import Jet
    jctx, tctx = built["3d"]["jasm"].ctx, built["3d"]["tasm"].ctx
    rng = np.random.default_rng(17)
    for q in (0, 11, 40):
        jq = type(jctx)(*[None if v is None or k == "aux" else v[q]
                          for k, v in jctx._asdict().items()])
        tq = tctx.map(lambda x, q=q: x[q])
        val, g = rng.normal(size=3), rng.normal(size=(3, 3))
        ju = JJet(jnp.asarray(val), jnp.asarray(g), None)
        tu = Jet(torch.as_tensor(val), torch.as_tensor(g), None)
        for name in ("pushforward_RT", "pushforward_N"):
            a = getattr(jq, name)(ju)
            b = getattr(tq, name)(tu)
            assert rel(b.val, a.val) <= 1e-13 and rel(b.grad, a.grad) <= 1e-13
            if a.div_exact is not None:
                assert abs(float(b.div_exact) - float(a.div_exact)) <= \
                    1e-13 * abs(float(a.div_exact))
        assert rel(tq.pushforward_W(tu), jq.pushforward_W(ju)) <= 1e-13


def test_autograd_through_functional(built):
    """torch.autograd through the jets (the plain map on the CPU) gives
    the residual of the energy's Gateaux derivative: 1e-12."""
    b = built["3d"]
    ta = b["tasm"]
    U = torch.as_tensor(b["U"]).requires_grad_(True)

    def energy(ctx, u):
        g = ctx.grad(u)
        return 0.5 * torch.dot(g, g) - u.val

    (gU,) = torch.autograd.grad(ta.functional(energy, U), U)
    r = ta.residual_vector(t_poisson, U.detach())
    assert rel(gU, r) <= 1e-12


def test_convert_carries_sumfac_assembler(built):
    """``convert`` carries JAX's assembler (tables, windows, ctx, scale)
    across; the carried assembler's residual matches JAX's (1e-12) and
    its equal-order fields share one plan."""
    for case in ("periodic", "rt"):
        b = built[case]
        arrs = convert.sumfac_assembler_arrays(b["jasm"])
        ta = convert.sumfac_assembler_from_numpy(arrs, device="cpu")
        assert ta.metas == b["jasm"].metas
        got = convert.sumfac_assembler_arrays(ta)
        for k, v in arrs["ctx"].items():
            assert (v is None) == (got["ctx"][k] is None), k
        r = ta.residual_vector(FORMS[b["key"]][1], torch.as_tensor(b["U"]))
        assert rel(r, b["r"]) <= 1e-12


def test_to_casts_the_assembler(built):
    """``to(float32)`` casts ctx, scale and tables and keeps the windows;
    the f32 residual within 1e-5 of the f64 one."""
    b = built["periodic"]
    a32 = b["tasm"].to(torch.float32)
    assert a32.scale.dtype == torch.float32
    assert a32.ctx.DF.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in a32.tabs[0])
    assert a32.idxs[0][0] is b["tasm"].idxs[0][0]
    r32 = a32.residual_vector(t_poisson, torch.as_tensor(b["U"],
                                                         dtype=torch.float32))
    assert r32.dtype == torch.float32 and rel(r32, b["r"]) <= 1e-5


# -- NURBS control meshes, entry points ------------------------------------------


def test_nurbs_control_mesh_matches_jax(built):
    """NURBSControlMesh's homogeneous_points (dir 0 fastest) equal JAX's on
    the quarter annulus and the distorted patch; the .dat path raises."""
    jmesh = JNURBS(*j_annulus(1.0, 2.5))
    tmesh = TNURBS(*t_annulus(1.0, 2.5))
    assert np.array_equal(tmesh.homogeneous_points(),
                          jmesh.homogeneous_points())
    assert tmesh.nsd == jmesh.nsd == 2
    jsp, tsp = built["nurbs"]["jsp"], built["nurbs"]["tsp"]
    assert np.array_equal(tsp.bnet, np.asarray(jsp.bnet))
    with pytest.raises(NotImplementedError, match="A7b"):
        TNURBS("geometry.dat")
    with pytest.raises(ValueError):
        TNURBS([2, 2], [t_knots(2, 0., 1., 2)] * 2, np.zeros((3, 4, 3)))


def test_make_sumfac_assembler_refuses_and_defaults_to_the_card(
        built, monkeypatch):
    """Without a card the entry points raise unless the caller asks for
    the CPU; a spline on the CPU gives an assembler on the CPU; the JAX
    package's ValueErrors for non-tensor-product fields."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cm = TMesh([2, 2], [t_knots(2, 0., 1., 3)] * 2)
    basis = cm.scalar_basis()
    with pytest.raises(RuntimeError):
        tsf.sumfac_geometry(basis, cm.homogeneous_points(), 4)
    with pytest.raises(RuntimeError):
        TSpline(TEqualOrder(1, cm), quad_degree=4)
    arrs = convert.sumfac_assembler_arrays(built["reduced"]["jasm"])
    with pytest.raises(RuntimeError):
        convert.sumfac_assembler_from_numpy(arrs)
    asm = tsf.make_sumfac_assembler(TSpline(TEqualOrder(1, cm),
                                            quad_degree=4, device="cpu"))
    assert asm.scale.device.type == "cpu" and asm.nq_total == 81
    sp = TSpline(TEqualOrder(1, cm), quad_degree=4, device="cpu")
    sp.space.fields[0] = object()
    with pytest.raises(ValueError, match="tensor-product B-spline fields"):
        tsf.make_sumfac_assembler(sp)
