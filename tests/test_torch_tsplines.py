"""tigar_tpu_torch's T-spline module (models/tsplines.py), the shell
assembly on masked bicubic extraction elements and the star-T-spline shell
point (demos/star_tspline_shell.py) against tigar_tpu's, f64, on two
spaces:

  - the valence-3 star of ``make_star_extraction(3, 4)`` (48 elements, 127
    control points, every element 16 functions);
  - the ragged file of tests/test_tsplines.py:144 (a 6x6 bi-cubic patch
    with a 2x2 block of interior control points merged: max_nshl 16, fewer
    functions on some elements, so the padding mask is not all ones).

Checked: the extraction data equal; the written Rhino text byte-identical,
and each package reads the other's file; ``tabulate(4, 2)`` within 1e-14;
the boundary edges and DoFs equal sets; ``evaluate`` within 1e-14; the
SVK residual and the BC-masked element matrices at U = 1e-3 N(0, 1)
(numpy seed 0) within 1e-12 relative, through each package's own
pipeline and through ``convert.assembler_arrays`` (the padding mask
carried across); SANewton on the star shell with the bench's options plus
coarse_size=50 (steps within 1 of JAX's, rel64 <= 1e-10, U within 1e-8);
sa_cg on the star Poisson against JAX's direct solve (1e-8, as
tests/test_aggregation.py:77); the refusals of the kernels' Python checks.
"""

import contextlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.models import tsplines as jts
from tigar_tpu_torch.models import tsplines as tts
from tigar_tpu_torch import convert

from torch_parity import rel

E_MOD, NU, H_TH, Q = 3.0e4, 0.3, 0.03, 0.4


# -- the two spaces, built by either package ---------------------------------


def _ragged_data(ts, TensorBSplineBasis, uniform_knots, tmp_path, tag,
                 nel=6):
    """tests/test_tsplines.py's make_ragged_file with the functions of the
    package ``ts``: (bnet, nodes_list, ops_list) of the merged patch."""
    basis = TensorBSplineBasis([3, 3], [uniform_knots(3, 0.0, 1.0, nel)] * 2)
    gp = basis.greville_points()
    bnet = np.zeros((basis.ncp, 4))
    bnet[:, 0], bnet[:, 1] = gp[:, 0], gp[:, 1]
    bnet[:, 2] = 0.05 * gp[:, 0] * (1.0 - gp[:, 0])
    bnet[:, 3] = 1.0
    fname0 = str(tmp_path / f"regular_{tag}.iga")
    ts.bspline_to_rhino_extraction(basis, bnet, fname0)
    bnet_h, nodes_list, ops_list = ts._parse_tspline_file(fname0)
    M = basis.kvs[0].ncp
    block = [2 * M + 2, 2 * M + 3, 3 * M + 2, 3 * M + 3]
    node_map = {block[1]: block[0], block[2]: block[0], block[3]: block[0]}
    nodes_list, ops_list, _, used = ts.merge_extraction_nodes(
        nodes_list, ops_list, node_map)
    bnet_new = bnet_h[used]
    bnet_new[used.index(block[0])] = bnet_h[block].mean(axis=0)
    return bnet_new, nodes_list, ops_list


def _data(pkg, case, tmp_path):
    if pkg == "jax":
        from tigar_tpu.models.bspline import TensorBSplineBasis
        from tigar_tpu.ops.knots import uniform_knots
        ts = jts
    else:
        from tigar_tpu_torch.models.bspline import TensorBSplineBasis
        from tigar_tpu_torch.ops.knots import uniform_knots
        ts = tts
    if case == "star":
        return ts.make_star_extraction(3, 4)
    return _ragged_data(ts, TensorBSplineBasis, uniform_knots, tmp_path, pkg)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{case: {pkg: (data, path of the file that package wrote)}}."""
    tmp = tmp_path_factory.mktemp("tsplines")
    out = {}
    for case in ("star", "ragged"):
        out[case] = {}
        for pkg, ts in (("jax", jts), ("torch", tts)):
            data = _data(pkg, case, tmp)
            path = str(tmp / f"{case}_{pkg}.iga")
            ts.write_rhino_extraction(path, *data)
            out[case][pkg] = (data, path)
    return out


CASES = ["star", "ragged"]


@pytest.mark.parametrize("case", CASES)
def test_extraction_data_match_jax(files, case):
    (bj, nj, oj), _ = files[case]["jax"]
    (bt, nt, ot), _ = files[case]["torch"]
    assert np.array_equal(bj, bt)
    assert len(nj) == len(nt)
    assert all(np.array_equal(a, b) for a, b in zip(nj, nt))
    assert all(np.array_equal(a, b) for a, b in zip(oj, ot))
    nshl = {len(n) for n in nt}
    if case == "star":
        assert bt.shape[0] == 127 and len(nt) == 48 and nshl == {16}
    else:
        assert max(nshl) == 16 and len(nshl) > 1


@pytest.mark.parametrize("case", CASES)
def test_rhino_text_identical_and_cross_read(files, case):
    _, pj = files[case]["jax"]
    _, pt = files[case]["torch"]
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    # each package reads the other's file
    cj = jts.RhinoTSplineControlMesh(pt)
    ct = tts.RhinoTSplineControlMesh(pj)
    assert np.array_equal(cj.homogeneous_points(), ct.homogeneous_points())
    bj, bt = cj.scalar_basis(), ct.scalar_basis()
    assert (bj.ncp, bj.nel, bj.max_nshl) == (bt.ncp, bt.nel, bt.max_nshl)
    for k in ("C", "conn", "mask"):
        assert np.array_equal(getattr(bj, k), getattr(bt, k)), k
    assert ct.nsd == 3


def _bases(files, case):
    _, pt = files[case]["torch"]
    return (jts.RhinoTSplineControlMesh(pt).scalar_basis(),
            tts.RhinoTSplineControlMesh(pt).scalar_basis())


@pytest.mark.parametrize("case", CASES)
def test_tabulate_matches_jax(files, case):
    bj, bt = _bases(files, case)
    tj, tt = bj.tabulate(4, 2), bt.tabulate(4, 2)
    for k in ("N", "dN", "d2N", "mask", "qp", "qw"):
        a, b = np.asarray(getattr(tt, k)), np.asarray(getattr(tj, k))
        assert a.shape == b.shape and np.max(np.abs(a - b)) <= 1e-14, k
    assert np.array_equal(np.asarray(tt.conn), np.asarray(tj.conn))
    assert tt.ncp == tj.ncp and tt.dim == tj.dim == 2
    if case == "ragged":
        assert float(np.min(tt.mask)) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_boundary_topology_matches_jax(files, case):
    bj, bt = _bases(files, case)
    assert set(bt.boundary_edges()) == set(bj.boundary_edges())
    for layers in (1, 2):
        assert set(bt.boundary_dofs(layers).tolist()) == \
            set(bj.boundary_dofs(layers).tolist()), layers
    with pytest.raises(ValueError):
        bt.boundary_dofs(3)


@pytest.mark.parametrize("case", CASES)
def test_tspline_arrays_carry_the_jax_basis(files, case):
    """The port's basis built from the JAX basis's extraction and control
    net through convert.tspline_arrays / tspline_from_numpy: the padded
    arrays, tabulate(4, 2) and the boundary DoFs as the JAX basis's."""
    _, pt = files[case]["torch"]
    cj = jts.RhinoTSplineControlMesh(pt)
    bj = cj.scalar_basis()
    bt, bnet = convert.tspline_from_numpy(
        convert.tspline_arrays(bj, cj.homogeneous_points()))
    assert isinstance(bt, tts.TSplineBasis)
    assert np.array_equal(bnet, cj.homogeneous_points())
    for k in ("C", "conn", "mask"):
        assert np.array_equal(getattr(bt, k), getattr(bj, k)), k
    tj, tt = bj.tabulate(4, 2), bt.tabulate(4, 2)
    for k in ("N", "dN", "d2N", "mask"):
        a, b = np.asarray(getattr(tt, k)), np.asarray(getattr(tj, k))
        assert a.shape == b.shape and np.max(np.abs(a - b)) <= 1e-14, k
    for layers in (1, 2):
        assert set(bt.boundary_dofs(layers).tolist()) == \
            set(bj.boundary_dofs(layers).tolist()), layers


def test_evaluate_matches_jax(files):
    bj, bt = _bases(files, "ragged")
    c = np.random.default_rng(3).normal(size=bt.ncp)
    xi = np.asarray([[0.3, -0.2], [1.0, 1.0], [-0.7, 0.55]])
    for e in (0, 4, 14, bt.nel - 1):
        a, b = bt.evaluate(c, xi, element=e), bj.evaluate(c, xi, element=e)
        assert np.max(np.abs(a - b)) <= 1e-14, e


def test_boundary_tabulations_raise():
    from tigar_tpu_torch.ops.basis import bernstein_basis_ders
    from tigar_tpu.ops.basis import bernstein_basis_ders as jbern
    u = np.linspace(-1.0, 1.0, 7)
    assert np.max(np.abs(bernstein_basis_ders(3, u, 2)
                         - jbern(3, u, 2))) <= 1e-14
    _, nodes_list, ops_list = tts.make_star_extraction(3, 1)
    bt = tts.TSplineBasis(nodes_list=nodes_list, ops_list=ops_list)
    with pytest.raises(NotImplementedError, match="A6b"):
        bt.tabulate_boundary(4, 1, 0, 0)
    with pytest.raises(NotImplementedError, match="A6b"):
        bt.tabulate_whole_boundary(4, 1)


# -- the SVK shell on masked bicubic extraction elements ----------------------


def _jax_density():
    from tigar_tpu.models.shell import svk_shell_adjoint

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_MOD, NU, H_TH)
        return F._replace(val=F.val.at[2].add(-Q))
    return res_adj


def _torch_density():
    from tigar_tpu_torch.models.shell import SVKShellAdjoint
    return SVKShellAdjoint(E_MOD, NU, H_TH, load=(0.0, 0.0, -Q))


def _shell_splines(path):
    """The clamped 3-field shell spline on the file at ``path``, built by
    each package (quadrature degree 6, nders 2)."""
    from tigar_tpu.models.space import EqualOrderSpline as JE
    from tigar_tpu.models.extracted import ExtractedSpline as JX
    from tigar_tpu.models.shell import precompute_shell_reference as jpre
    from tigar_tpu_torch.models.space import EqualOrderSpline as TE
    from tigar_tpu_torch.models.extracted import ExtractedSpline as TX
    from tigar_tpu_torch.models.shell import precompute_shell_reference as tpre
    out = []
    for ts, E, X, pre, kw in ((jts, JE, JX, jpre, {}),
                              (tts, TE, TX, tpre, {"device": "cpu"})):
        cm = ts.RhinoTSplineControlMesh(path)
        sp = E(3, cm)
        bd = cm.scalar_basis().boundary_dofs(1)
        for i in range(3):
            sp.add_zero_dofs(i, bd)
        out.append(pre(X(sp, quad_degree=6, nders=2, **kw)))
    return out


@pytest.fixture(scope="module")
def shell_ref(files):
    """{case: (port spline, JAX assembler arrays, U, JAX residual, JAX
    masked element matrices, me)} at U = 1e-3 N(0, 1), numpy seed 0."""
    dens = _jax_density()
    res = jax.jit(lambda a, U: a.residual_vector_adjoint(dens, U))
    mats = jax.jit(lambda a, U: a.element_matrices_adjoint(dens, U))
    out = {}
    for case in CASES:
        sj, st = _shell_splines(files[case]["torch"][1])
        asm = sj._assembler("dx")
        U = np.random.default_rng(0).normal(size=sj.ndof) * 1e-3
        conn = np.asarray(asm.cat_conn)
        pad = np.concatenate([np.asarray(m) for m in asm.masks], axis=1)
        me = np.asarray(sj.mask)[conn] * pad
        E = np.asarray(mats(asm, jnp.asarray(U))) * me[:, :, None] * \
            me[:, None, :]
        out[case] = (st, convert.assembler_arrays(asm), U,
                     np.asarray(res(asm, jnp.asarray(U))), E, me)
    return out


@pytest.mark.parametrize("carried", [False, True], ids=["own", "carried"])
@pytest.mark.parametrize("case", CASES)
def test_shell_residual_matches_jax(shell_ref, case, carried):
    st, arrays, U, r_j, _, _ = shell_ref[case]
    asm = (convert.assembler_from_numpy(arrays, "cpu") if carried
           else st._assembler("dx"))
    assert asm.nens == (16, 16, 16) and asm.masks[0] is not None
    r = asm.residual_vector_adjoint(_torch_density(), torch.as_tensor(U))
    assert rel(r, r_j) <= 1e-12


@pytest.mark.parametrize("carried", [False, True], ids=["own", "carried"])
@pytest.mark.parametrize("case", CASES)
def test_element_matrices_match_jax(shell_ref, case, carried):
    st, arrays, U, _, E_j, me = shell_ref[case]
    asm = (convert.assembler_from_numpy(arrays, "cpu") if carried
           else st._assembler("dx"))
    E = asm.element_matrices_adjoint(_torch_density(), torch.as_tensor(U),
                                     me=torch.as_tensor(me))
    assert tuple(E.shape) == (asm.nel, 48, 48)
    assert rel(E, E_j) <= 1e-12
    if case == "ragged":
        # padded slots: zero rows and columns
        pad = asm.masks[0].repeat(1, 3) == 0
        assert bool(pad.any()) and float(E[pad].abs().max()) == 0.0


def test_sanewton_element_mask_zeroes_padding(shell_ref):
    """SANewton's element BC mask is the BC mask at the connectivity times
    the padding mask: zero at every padded slot (connectivity 0)."""
    from tigar_tpu_torch.solvers.newton_sa import SANewton
    st, _, _, _, _, me = shell_ref["ragged"]
    ns = SANewton(st, _torch_density(), cg_iters=5)
    assert np.array_equal(ns._me64.numpy(), me)
    assert bool((ns._me64[ns.asm64.masks[0].repeat(1, 3) == 0] == 0).all())


# -- the slice: the star shell solved by SANewton -----------------------------


@pytest.fixture(scope="module")
def star_solve():
    """JAX's SANewton on the star shell at nel=4 with the bench's options
    plus coarse_size=50 (bench.py:392-425)."""
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import precompute_shell_reference
    from tigar_tpu.solvers.newton_sa import SANewton
    from tigar_tpu_torch.demos import star_tspline_shell as demo
    import os
    import tempfile
    bnet, nodes_list, ops_list = jts.make_star_extraction(3, 4)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "star.iga")
        jts.write_rhino_extraction(path, bnet, nodes_list, ops_list)
        cm = jts.RhinoTSplineControlMesh(path)
    gen = EqualOrderSpline(3, cm)
    bd = cm.scalar_basis().boundary_dofs(1)
    for i in range(3):
        gen.add_zero_dofs(i, bd)
    spline = precompute_shell_reference(
        ExtractedSpline(gen, quad_degree=6, nders=2))
    opts = dict(demo.SA_OPTS)
    opts["sa_kwargs"] = {**opts["sa_kwargs"], "coarse_size": 50}
    ns = SANewton(spline, _jax_density(), **opts)
    U, rel64, nit, dU_rel = ns.solve(rtol=1e-10)
    return dict(U=np.asarray(U), rel=rel64, nit=nit, dU=dU_rel,
                levels=ns._sa.level_sizes)


@contextlib.contextmanager
def _one_thread():
    """The port's nel=4 solve is tens of thousands of tiny CPU ops: one
    intra-op thread runs them faster than many do beside the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_star_sanewton_matches_jax(star_solve):
    from tigar_tpu_torch.demos import star_tspline_shell as demo
    ns = demo.build(4, "cpu", sa_kwargs={"coarse_size": 50})
    assert ns.spline.ndof == 381 and ns.asm_b64.nq == 9 and ns.asm64.nq == 16
    with _one_thread():
        U, rel64, nit, dU_rel = ns.solve(rtol=demo.RTOL)
    assert ns._sa.level_sizes == star_solve["levels"]
    assert abs(nit - star_solve["nit"]) <= 1, (nit, star_solve["nit"])
    assert rel64 <= 1e-10
    assert rel(U, star_solve["U"]) <= 1e-8
    cpu_rel, _, f64_ok = demo.certify(ns, U, rel64, dU_rel)
    assert f64_ok and cpu_rel <= 1e-10


def test_sa_cg_star_poisson_matches_jax_direct(tmp_path):
    """tests/test_aggregation.py:77: sa_cg on the valence-3 star Poisson
    (nel=4, clamped by boundary_dofs(1)) against JAX's dense direct
    solve."""
    from tigar_tpu.models.space import EqualOrderSpline as JE
    from tigar_tpu.models.extracted import ExtractedSpline as JX
    from tigar_tpu_torch.models.space import EqualOrderSpline as TE
    from tigar_tpu_torch.models.extracted import ExtractedSpline as TX
    path = str(tmp_path / "star_sa.iga")
    tts.write_rhino_extraction(path, *tts.make_star_extraction(3, 4))
    splines = []
    for ts, E, X, kw in ((jts, JE, JX, {}), (tts, TE, TX, {"device": "cpu"})):
        cm = ts.RhinoTSplineControlMesh(path)
        sp = E(1, cm)
        sp.add_zero_dofs(0, cm.scalar_basis().boundary_dofs(1))
        splines.append(X(sp, quad_degree=6, **kw))
    sj, st = splines

    def aj(ctx, u, v):
        return jnp.sum(ctx.grad(u) * ctx.grad(v))

    def Lj(ctx, v):
        return (1.0 + ctx.x[0] + jnp.sin(2.0 * ctx.x[1])) * v.val

    def at(ctx, u, v):
        return torch.sum(ctx.grad(u) * ctx.grad(v))

    def Lt(ctx, v):
        return (1.0 + ctx.x[0] + torch.sin(2.0 * ctx.x[1])) * v.val

    U_dir = np.asarray(sj.solve_linear_variational_problem(aj, rhs_form=Lj))
    st.set_solver_options(linear_solver="sa_cg", linear_tol=1e-12,
                          linear_max_iter=400)
    U_sa = st.solve_linear_variational_problem(at, rhs_form=Lt)
    assert rel(U_sa, U_dir) <= 1e-8


# -- what the kernels' Python checks refuse, named by shape ------------------


def test_shell_kernel_checks_refuse_other_shapes(shell_ref):
    from tigar_tpu_torch.ops.assembly import (element_matrices_cuda,
                                              shell_kernel_args)
    from tigar_tpu_torch.ops.stencil import build_stencil_cuda
    dens = _torch_density()
    st = shell_ref["ragged"][0]
    asm = st._assembler("dx")
    U = torch.zeros(asm.ndof, dtype=torch.float64)
    # NEN 16 with its padding mask passes every shape check: only the
    # device is refused here
    with pytest.raises(ValueError, match="CUDA tensors"):
        shell_kernel_args(asm, dens, U)
    bad = asm._map_tensors(lambda x: x)
    bad.masks = [asm.masks[0][:, :9]] * 3
    with pytest.raises(ValueError, match=r"padding mask shape \(36, 9\)"):
        shell_kernel_args(bad, dens, U)
    bad.masks = [asm.masks[0], None, None]
    with pytest.raises(ValueError, match="shared by all fields"):
        shell_kernel_args(bad, dens, U)
    wide = asm._map_tensors(lambda x: x)
    wide.nens = (25, 25, 25)
    with pytest.raises(ValueError, match=r"\(25, 25, 25\)"):
        shell_kernel_args(wide, dens, U)
    with pytest.raises(ValueError, match=r"me must be \[36, 48\].*\(36, 27\)"):
        element_matrices_cuda(asm, dens, U, me=torch.ones(36, 27,
                                                          dtype=U.dtype))
    fine = st._assembler("dx", quad_degree=8)          # 25 points
    with pytest.raises(ValueError, match="at most 16 quadrature points, "
                                         "got 25"):
        element_matrices_cuda(fine, dens, U)
    with pytest.raises(ValueError, match="9 local functions a field\\); "
                                         "got 16"):
        build_stencil_cuda(asm, dens, U, None, 3)
