"""tigar_tpu_torch's smoothed-aggregation path of the generic solver
(``control_point_aggregates``, ``TwoLevelSA``, ``MultilevelSA.from_spline``
and ``linear_solver="sa_cg"``) against tigar_tpu's on the same Poisson
splines (CPU), and the entry points' default device.

Tolerances: aggregate labels equal; TwoLevelSA.from_coo's arrays (dinv, P,
Ac_inv, omega) 1e-12 relative (the same host numpy on the same coo
input, cast to float32 by both); the plain two-level cycle on identical
arrays 1e-5 (float32, scatter-adds in another order); its ELL form with
the first sweep fused equal to the unfused one, and kernel K11's sliced
layout of the ELL operator 1e-14 of the carried arrays (f64); sa_cg
solutions 1e-8 of the direct solve (tests/test_aggregation.py's bound).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tigar_tpu.solvers import aggregation as jagg

from tigar_tpu_torch import convert
from tigar_tpu_torch.solvers import aggregation as tagg

from torch_parity import rel, scalar_forms as forms, scalar_spline as spline


@pytest.fixture(scope="module")
def pair():
    return spline("jax", 2, 12), spline("torch", 2, 12)


@pytest.mark.parametrize("coarsen", [2.0, 3.0, 4.5])
def test_control_point_aggregates_match_jax(pair, coarsen):
    js, ts = pair
    lj = jagg.control_point_aggregates(js, coarsen=coarsen)
    lt = tagg.control_point_aggregates(ts, coarsen=coarsen)
    assert np.array_equal(lt, lj)


@pytest.fixture(scope="module")
def twolevel(pair):
    """Both packages' TwoLevelSA.from_coo on one coo input (the port's
    sparse tangent)."""
    _, ts = pair
    M = ts.assemble_sparse(forms("torch")["a"])
    idx, vals = M.indices().numpy(), M.values().numpy()
    lbl = tagg.control_point_aggregates(ts)
    m_h = ts.mask.numpy()
    lbl_dof = np.where(m_h > 0, lbl, -1)
    args = (idx[0], idx[1], vals, ts.ndof, lbl_dof, m_h)
    return (jagg.TwoLevelSA.from_coo(*args),
            tagg.TwoLevelSA.from_coo(*args, device="cpu"))


@pytest.mark.parametrize("what", ["dinv", "P", "Ac_inv", "omega", "coo"])
def test_twolevel_from_coo_matches_jax(twolevel, what):
    jpre, tpre = twolevel
    if what == "omega":
        assert abs(tpre._omega - jpre._omega) <= 1e-12 * abs(jpre._omega)
    elif what == "coo":
        for k in ("_rows", "_cols"):
            assert np.array_equal(getattr(tpre, k).numpy(),
                                  np.asarray(getattr(jpre, k)))
        assert rel(tpre._vals, jpre._vals) <= 1e-12
    else:
        t, j = getattr(tpre, "_" + what), getattr(jpre, "_" + what)
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        assert rel(t, j) <= 1e-12


def test_twolevel_plain_cycle_matches_jax(twolevel):
    """The port's plain cycle (coo scatter SpMV) and its ELL form (K11's
    plain version) on the JAX package's arrays against JAX's cycle."""
    jpre, _ = twolevel
    tpre = convert.twolevel_sa_from_numpy(convert.twolevel_sa_arrays(jpre),
                                          "cpu")
    r = np.random.default_rng(7).normal(size=jpre._ndof)
    yj = jpre(jnp.asarray(r))
    rt = torch.as_tensor(r)
    assert rel(tpre(rt), yj) <= 1e-5
    ell = tagg.twolevel_apply_ell(tpre._ell_op, tpre._om_dinv, tpre._P,
                                  tpre._Ac_inv, rt.float(), tpre._n_smooth)
    assert rel(ell, yj) <= 1e-5


@pytest.mark.parametrize("what", ["fused", "sliced"])
def test_twolevel_ell_cycle_pieces(twolevel, what):
    """The two-level cycle's ELL form with the first sweep fused
    ("jacobi0") against the unfused composition (x = om_dinv r, then the
    Jacobi sweeps): equal on the CPU; kernel K11's sliced layout of its
    ELL operator (f64), through its plain version, against the carried
    arrays in every square mode: 1e-14."""
    from tigar_tpu_torch.ops import sparse
    _, tpre = twolevel
    cols, vals, om = tpre._ell_cols, tpre._ell_vals, tpre._om_dinv
    r = torch.as_tensor(np.random.default_rng(9).normal(size=tpre._ndof),
                        dtype=torch.float32)
    if what == "fused":
        x = om * r
        for _ in range(tpre._n_smooth - 1):
            x = sparse.ell_spmv_ref(cols, vals, x, r, om, "jacobi")
        d = sparse.ell_spmv_ref(cols, vals, x, r, mode="residual")
        x = x + tpre._P @ (tpre._Ac_inv @ (d @ tpre._P))
        for _ in range(tpre._n_smooth):
            x = sparse.ell_spmv_ref(cols, vals, x, r, om, "jacobi")
        assert tpre._n_smooth >= 2
        assert torch.equal(tagg.twolevel_apply_ell(
            sparse.EllOperator(cols, vals, tpre._ndof), om, tpre._P,
            tpre._Ac_inv, r, tpre._n_smooth), x)
        return
    v64, om64, r64 = vals.double(), om.double(), r.double()
    sl = sparse.sliced_ell(cols, v64, tpre._ndof)
    x = torch.as_tensor(np.random.default_rng(10).normal(size=tpre._ndof))
    for mode in sparse.ELL_MODES:
        xm = None if mode == "jacobi0" else x
        assert rel(sparse.sliced_ell_ref(sl, xm, r64, om64, mode),
                   sparse.ell_spmv_ref(cols, v64, xm, r64, om64,
                                       mode)) <= 1e-14


@pytest.mark.parametrize("levels", [2, 4])
def test_sa_cg_matches_direct(levels):
    out = {}
    for pkg in ("jax", "torch"):
        f = forms(pkg)
        res = {}
        for method in ("direct", "sa_cg"):
            s = spline(pkg, 2, 12)
            s.set_solver_options(linear_solver=method, sa_levels=levels,
                                 sa_coarse_size=20)
            res[method] = s.solve_linear_variational_problem(
                f["a"], rhs_form=f["L"])
        out[pkg] = res
    assert rel(out["torch"]["sa_cg"], out["torch"]["direct"]) <= 1e-8
    assert rel(out["torch"]["sa_cg"], out["jax"]["sa_cg"]) <= 1e-8


def test_multilevel_from_spline_matches_jax(pair):
    js, ts = pair
    jpre, _ = jagg.MultilevelSA.from_spline(js, forms("jax")["a"],
                                            coarse_size=20)
    tpre, _ = tagg.MultilevelSA.from_spline(ts, forms("torch")["a"],
                                            coarse_size=20)
    assert tpre.level_sizes == jpre.level_sizes
    r = np.random.default_rng(8).normal(size=js.ndof)
    assert rel(tpre(torch.as_tensor(r)), jpre(jnp.asarray(r))) <= 1e-5


@pytest.mark.parametrize("entry", ["spline", "twolevel", "layouts"])
def test_entry_points_default_to_the_card(twolevel, entry, monkeypatch):
    """Without a card the constructors raise unless the caller asks for
    the CPU; they never drop to the CPU by themselves."""
    from tigar_tpu_torch.models.extracted import ExtractedSpline
    _, tpre = twolevel
    space = spline("torch", 2, 4).space
    arrays = convert.twolevel_sa_arrays(tpre)
    a = np.zeros((18, 4), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "spline":
            ExtractedSpline(space, quad_degree=4)
        elif entry == "twolevel":
            convert.twolevel_sa_from_numpy(arrays)
        else:
            convert.laplace_layouts_from_numpy(a, a,
                                               np.zeros((9, 4), np.int32))
