"""tigar_tpu_torch's penalty self-contact (contact.py, ops/contact.py)
against tigar_tpu on the CPU, mirroring tests/test_contact.py:1-80 and
:203.

The same inputs (numpy, seeded) go through both packages: the contact
state each package builds itself and, through convert.py, the JAX
package's state handed to the port.  On CPU tensors the port runs the
plain versions of K13/K14 (torch.func derivatives of the row-blocked pair
energy); the kernels themselves are held to them on the card
(tests/test_torch_kernels_cuda.py).  The reef-knot demo's step is
tests/test_torch_reef_knot.py.

The Newton solves with contact (the last three tests, mirroring
tests/test_contact.py:81-200): the nonlinear variational solve, the
combined manual Newton with a dense tangent, and the matrix-free
combined Newton (shell JVP plus contact HVP inside Jacobi CG): the same
iteration count and U within 1e-10 of the JAX package; the matrix-free
Newton within 1e-6 of the port's dense one.  The port's AD shell tangent
action takes 60-150 ms a call on a CPU with one torch thread (torch.func's
nested transforms), so the Krylov loop that applies it runs 20 CG
iterations (tests/test_contact.py:141 runs 400); both packages run the
same count, and on these small problems (108-147 unknowns) the solves are
near exact at it.

Tolerances: index arrays and the mask equal, floats 1e-14 (the same host
numpy); residual, tangent action and energy 1e-12 in float64 and 1e-5 in
float32 (every array cast, as the demo's ``contact32``), relative to the
largest entry.
"""

import contextlib
import io

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tigar_tpu.contact import PointContact as JContact
from tigar_tpu.forms import deriv as jderiv
from tigar_tpu.models.shell import svk_psi_surface as jpsi
from tigar_tpu.solvers import linear as jlin

from tigar_tpu_torch import convert
from tigar_tpu_torch.contact import PointContact
from tigar_tpu_torch.forms import deriv
from tigar_tpu_torch.models.shell import svk_psi_surface
from tigar_tpu_torch.ops import contact as ops_contact
from tigar_tpu_torch.solvers.linear import (cg_fixed_iters,
                                            jacobi_preconditioner)

from torch_parity import contact_strip, jax_f32, rel

F32 = torch.float32
ARRAYS = ("conn", "vals", "X", "w_ctrl", "quad_w", "pair_mask")


# -- the contact itself ------------------------------------------------------

ACTIVE = dict(k=1e4, r_max=0.3, r_self=0.05)     # tests/test_contact.py:29


@pytest.fixture(scope="module")
def active():
    """Both packages' contact on the strip at the active parameters, the
    port's copy of the JAX state, and U = 0.01 N(0, 1), W ~ N(0, 1) from
    numpy seed 0."""
    js, ts = contact_strip("jax"), contact_strip("torch")
    jc, tc = JContact(js, **ACTIVE), PointContact(ts, **ACTIVE)
    conv = convert.point_contact_from_numpy(
        convert.point_contact_arrays(jc, k=ACTIVE["k"]), ts, "cpu")
    rng = np.random.default_rng(0)
    U = rng.normal(size=js.ndof) * 0.01
    W = rng.normal(size=js.ndof)
    return dict(js=js, ts=ts, jc=jc, tc=tc, conv=conv, U=U, W=W)


@pytest.mark.parametrize("name", ARRAYS)
def test_contact_setup_matches_jax(active, name):
    a = np.asarray(getattr(active["jc"], name))
    b = getattr(active["tc"], name).numpy()
    assert a.shape == b.shape
    if name in ("conn", "pair_mask"):
        assert np.array_equal(a, b)
    else:
        assert np.max(np.abs(a - b)) <= 1e-14 * max(1.0, np.max(np.abs(a)))
    if name == "pair_mask":
        assert np.array_equal(b, b.T)          # the kernels rely on it
        assert not b.diagonal().any()


def _eval(pkg, c, what, U, W, dtype):
    if pkg == "jax":
        U, W = jnp.asarray(U, dtype=dtype), jnp.asarray(W, dtype=dtype)
    else:
        U, W = torch.as_tensor(U).to(dtype), torch.as_tensor(W).to(dtype)
    if what == "residual":
        return c.residual(U)
    if what == "tangent":
        return c.tangent_action(U, W)
    e = c.energy(U)
    return e.reshape(1) if pkg == "torch" else np.atleast_1d(np.asarray(e))


@pytest.mark.parametrize("source", ["own", "converted"])
@pytest.mark.parametrize("what", ["residual", "tangent", "energy"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_contact_matches_jax(active, source, what, dtype):
    """The port's residual, tangent action and energy against JAX's jitted
    grad / jvp and energy, at test_contact.py's active state."""
    jc = active["jc"] if dtype == "f64" else jax_f32(active["jc"])
    tc = active["tc" if source == "own" else "conv"]
    jdt, tdt, tol = ((jnp.float64, torch.float64, 1e-12) if dtype == "f64"
                     else (jnp.float32, F32, 1e-5))
    if dtype == "f32":
        tc = tc.astype(F32)
    yj = _eval("jax", jc, what, active["U"], active["W"], jdt)
    yt = _eval("torch", tc, what, active["U"], active["W"], tdt)
    assert yt.dtype == tdt
    assert float(np.max(np.abs(np.asarray(yj)))) > 0.0
    assert rel(yt, yj) <= tol


def test_contact_force_fd_and_closed_form(active):
    """tests/test_contact.py:26-77 on the port: the residual against a
    central difference of the energy, and one point's gradient against
    the closed-form pair force sum_j C phi'(r) rhat."""
    tc, ts = active["tc"], active["ts"]
    rng = np.random.default_rng(0)
    U = torch.as_tensor(rng.normal(size=ts.ndof) * 0.01)
    r = tc.residual(U)
    v = torch.as_tensor(rng.normal(size=ts.ndof))
    h = 1e-6
    fd = (float(tc.energy(U + h * v)) - float(tc.energy(U - h * v))) / (2 * h)
    assert np.isclose(float(torch.dot(r, v)), fd, rtol=1e-6)

    x = tc.positions(U).numpy()
    Cw, M = tc.quad_w.numpy(), tc.pair_mask.numpy()
    k, r_max = ACTIVE["k"], ACTIVE["r_max"]
    d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    ii, _ = np.where(M & (d < r_max) & (d > 1e-6))
    assert len(ii) > 0
    i = int(ii[0])
    g = ops_contact.contact_forces_ref(torch.as_tensor(x), tc.quad_w,
                                       tc.pair_mask, tc.phi, r_max).numpy()
    expected = np.zeros(3)
    for j in range(len(x)):
        if M[i, j] and d[i, j] < r_max:
            rhat = (x[j] - x[i]) / d[i, j]
            expected -= Cw[i] * Cw[j] * (-k * (r_max - d[i, j])) * rhat
    assert np.allclose(g[i], expected, rtol=1e-10)


def test_contact_inactive_when_far():
    """tests/test_contact.py:78."""
    ts = contact_strip("torch")
    c = PointContact(ts, k=1e4, r_max=0.01, r_self=0.02)
    U = torch.zeros(ts.ndof, dtype=torch.float64)
    assert float(c.energy(U)) == 0.0
    assert float(c.residual(U).abs().max()) == 0.0
    assert float(c.tangent_action(U, U + 1.0).abs().max()) == 0.0


@pytest.fixture(scope="module")
def chunked():
    """tests/test_contact.py:203: nel=8 (n=100), reference distances in
    (r_self, r_max) active at U=0, row_chunk 7 (not a divisor of n)."""
    ts, js = contact_strip("torch", nel=8), contact_strip("jax", nel=8)
    kw = dict(k=1e5, r_max=0.18, r_self=0.1)
    rng = np.random.default_rng(5)
    U, W = rng.normal(size=ts.ndof) * 0.05, rng.normal(size=ts.ndof)
    return (PointContact(ts, **kw), PointContact(ts, row_chunk=7, **kw),
            JContact(js, **kw), U, W)


@pytest.mark.parametrize("what", ["energy", "residual", "tangent"])
def test_row_chunked_contact_matches_unchunked(chunked, what):
    full, chunk, jc, U, W = chunked
    a = _eval("torch", full, what, U, W, torch.float64)
    b = _eval("torch", chunk, what, U, W, torch.float64)
    assert float(a.abs().max()) > 0.0
    assert rel(b, a) <= 1e-12
    assert rel(b, _eval("jax", jc, what, U, W, jnp.float64)) <= 1e-12


def _unpack_bits(bits, n):
    """The bool [n, n] mask that PairBits.words hold."""
    b = (bits.words[:, :, None].long() >> torch.arange(32)) & 1
    return b.permute(1, 0, 2).reshape(n, -1)[:, :n].bool()


@pytest.mark.parametrize("fixture", ["active", "chunked"])
def test_pair_bits_match_the_bool_mask(request, fixture):
    """The kernels' bits (n = 36 and 100, not multiples of 32) hold the
    bool mask bit for bit, zero beyond n, with tiles marking exactly the
    tile pairs that hold a live pair; ``astype`` shares them."""
    f = request.getfixturevalue(fixture)
    c = f["tc"] if fixture == "active" else f[0]
    n = c.X.shape[0]
    bits = c.pair_bits
    nt = -(-n // 32)
    assert bits.words.shape == (nt, n) and bits.words.dtype == torch.int32
    assert torch.equal(_unpack_bits(bits, n), c.pair_mask)
    live = torch.zeros((nt * 32, nt * 32), dtype=torch.bool)
    live[:n, :n] = c.pair_mask
    tiles = live.view(nt, 32, nt, 32).any(3).any(1)
    assert torch.equal(bits.tiles.bool(), tiles)
    c32 = c.astype(F32)
    assert c32.pair_bits.words is bits.words
    assert c32.pair_bits.tiles is bits.tiles


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, F32])
def test_culled_tile_pairs_hold_no_interacting_pair(chunked, seed, dtype):
    """The plain twin of the kernels' cull (ops/contact.culled_tile_pairs)
    at seeded states of the n = 100 strip: no skipped tile pair holds a
    live pair closer than r_max (distances in float64), and the cull
    skips some tile pairs and keeps others."""
    c = chunked[0]
    rng = np.random.default_rng(seed)
    U = torch.as_tensor(rng.normal(size=c.spline.ndof) * 0.05)
    x = c.positions(U)
    culled = ops_contact.culled_tile_pairs(x.to(dtype), c.pair_bits,
                                           c.r_max)
    n, nt = x.shape[0], culled.shape[0]
    r2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    hit = torch.zeros((nt * 32, nt * 32), dtype=torch.bool)
    hit[:n, :n] = c.pair_mask & (r2 < c.r_max ** 2)
    hit_tiles = hit.view(nt, 32, nt, 32).any(3).any(1)
    assert not bool((culled & hit_tiles).any())
    assert bool(culled.any()) and not bool(culled.all())


def test_custom_potential_runs_the_plain_version_on_cpu(active):
    """A custom phi (here the default formula written out) runs the plain
    versions on CPU tensors and gives the default potential's results."""
    k, r_max = ACTIVE["k"], ACTIVE["r_max"]

    def phi(r):
        return torch.where(r < r_max, 0.5 * k * (r_max - r) ** 2,
                           torch.zeros_like(r))

    c = PointContact(active["ts"], phi=phi, **ACTIVE)
    U, W = torch.as_tensor(active["U"]), torch.as_tensor(active["W"])
    assert rel(c.residual(U), active["tc"].residual(U)) <= 1e-14
    assert rel(c.tangent_action(U, W),
               active["tc"].tangent_action(U, W)) <= 1e-14


# -- Newton solves with contact (tests/test_contact.py:81-200) ---------------

CG_ITERS = 20           # the matrix-free Newton's CG (module docstring)
E_MOD, NU, H_TH, Q = 1e5, 0.3, 0.05, -2.0


def jres(ctx, u, v):
    return jderiv(lambda y: jpsi(ctx, y, E_MOD, NU, H_TH), u, v) \
        - Q * v.val[2]


def tres(ctx, u, v):
    return deriv(lambda y: svk_psi_surface(ctx, y, E_MOD, NU, H_TH), u, v) \
        - Q * v.val[2]


def _newton(pkg, spline, contact, solve_lin, rtol, max_iters=50):
    """The manual combined Newton loop of tests/test_contact.py:117-139:
    (U, iterations)."""
    xp = jnp if pkg == "jax" else torch
    U = (jnp.zeros(spline.ndof) if pkg == "jax"
         else torch.zeros(spline.ndof, dtype=torch.float64))
    res = jres if pkg == "jax" else tres
    n0 = None
    for it in range(max_iters):
        r = spline.assemble_vector(res, U=U) \
            + spline.mask * contact.residual(U)
        nrm = float(xp.linalg.norm(r))
        n0 = nrm if n0 is None else n0
        if nrm / n0 < rtol:
            return U, it
        U = U - solve_lin(U, r)
    raise AssertionError("combined Newton failed to converge")


def _dense_solver(pkg, spline, contact):
    res = jres if pkg == "jax" else tres
    mask = spline.mask

    def solve(U, r):
        A = spline.assemble_matrix(res, U=U)
        if pkg == "jax":
            Kc = jax.jacfwd(lambda uu: mask * contact.residual(uu))(U)
            return jnp.linalg.solve(A + Kc, r)
        Kc = torch.func.jacfwd(lambda uu: mask * contact.residual(uu))(U)
        return torch.linalg.solve(A + Kc, r)
    return solve


def _matfree_solver(pkg, spline, contact):
    res = jres if pkg == "jax" else tres
    mask = spline.mask
    cg = jlin.cg_fixed_iters if pkg == "jax" else cg_fixed_iters
    jac = jlin.jacobi_preconditioner if pkg == "jax" \
        else jacobi_preconditioner

    def cg_solve(U, r, diag):
        def A_op(W):
            return (spline.tangent_action(res, U, W)
                    + mask * contact.tangent_action(U, mask * W))
        return cg(A_op, r, CG_ITERS, M=jac(diag))[0]

    if pkg == "jax":
        # one compile for every Newton iteration (cg_fixed_iters' fori_loop
        # would otherwise compile its body again at each call)
        cg_solve = jax.jit(cg_solve)

    def solve(U, r):
        return cg_solve(U, r, spline.assemble_diagonal(res, U=U))
    return solve


@pytest.fixture(scope="module")
def membrane():
    """tests/test_contact.py:81-139's clamped membrane (nel=4): the pure
    elastic Newton solve (r_self=1e9 disables every pair) through
    solve_nonlinear_variational_problem, its log counting the iterates,
    and the combined manual Newton with a dense tangent, in both
    packages."""
    out = {}
    for pkg in ("jax", "torch"):
        sp = contact_strip(pkg, clamp=True)
        sp.set_solver_options(max_iters=50, relative_tolerance=1e-6)
        C = JContact if pkg == "jax" else PointContact
        c0 = C(sp, k=1e8, r_max=0.05, r_self=1e9)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            U_noc = sp.solve_nonlinear_variational_problem(
                jres if pkg == "jax" else tres, log=True)
        c2 = C(sp, k=1e6, r_max=0.04, r_self=0.3)
        U, its = _newton(pkg, sp, c2, _dense_solver(pkg, sp, c2), 1e-6)
        out[pkg] = dict(U_noc=U_noc, e_noc=float(c0.energy(U_noc)),
                        log=log.getvalue().splitlines(), U=U, its=its)
    return out


def test_nonlinear_solve_matches_jax(membrane):
    j, t = membrane["jax"], membrane["torch"]
    assert t["e_noc"] == 0.0 == j["e_noc"]
    assert len(t["log"]) == len(j["log"]) > 1
    assert rel(t["U_noc"], j["U_noc"]) <= 1e-10


def test_combined_dense_newton_matches_jax(membrane):
    j, t = membrane["jax"], membrane["torch"]
    assert t["its"] == j["its"]
    assert rel(t["U"], j["U"]) <= 1e-10
    assert bool(torch.isfinite(t["U"]).all())


def test_matrix_free_combined_newton_matches_jax():
    """tests/test_contact.py:141 (nel=5): the combined tangent only as an
    action (shell JVP + contact HVP) inside Jacobi CG, against the same
    loop in the JAX package and against the port's dense Newton."""
    out = {}
    for pkg in ("jax", "torch"):
        sp = contact_strip(pkg, nel=5, clamp=True)
        C = JContact if pkg == "jax" else PointContact
        c = C(sp, k=1e6, r_max=0.04, r_self=0.3)
        out[pkg] = _newton(pkg, sp, c, _matfree_solver(pkg, sp, c), 1e-9)
        if pkg == "torch":
            U_dense, _ = _newton(pkg, sp, c, _dense_solver(pkg, sp, c), 1e-9)
    (Uj, nj), (Ut, nt) = out["jax"], out["torch"]
    assert nt == nj
    assert rel(Ut, Uj) <= 1e-10
    assert rel(Ut, U_dense) <= 1e-6
