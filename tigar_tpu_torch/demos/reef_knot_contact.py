"""Shell dynamics with nonlocal self-contact (port of
demos/kl_shell_svk/reef_knot_contact.py): a clamped SVK membrane under a
dead load, damped backward-Euler-style dynamics, and all-pairs penalty
self-contact with reference-configuration exclusion (contact.py, kernels
K13 and K14 on the card).

Each time step is a hand-written Newton loop on the combined residual
(the shell form plus the masked contact residual).  The tangent is only
applied, never assembled: the shell JVP plus the masked contact HVP,
inside a fixed-count CG.  With ``mixed`` the CG runs in float32 inside the
float64 Newton loop; with ``mg`` it is preconditioned by a geometric
V-cycle over nested shell splines (nel, nel/2, ... down to 6), built from
the shell form at the zero state (contact stays out of it), with 40 CG
iterations; without, Jacobi and max(200, 12 nel) iterations.  The
reference workload class is nel = 96 with mg: 28,812 DoFs and 9,604
collocation points.

On the card each shell tangent action at a fixed state runs as a CUDA
graph captured once: the V-cycle's level
actions at setup, the fine one at each Newton iterate.  Eagerly, one such
action is a few thousand small kernels, each dispatched through
torch.func's nested transforms on the host; the JAX demo compiles each
action into one program for the same reason.  The contact terms (K13,
K14) run eagerly, so every launch of theirs is counted.

    U, history, energy = run(96, 1)        # on the card

``run`` writes no files (the JAX demo's VTK output waits for the port of
io.py).
"""

from __future__ import annotations

import time

import torch

from ..contact import PointContact
from ..forms import deriv
from ..models.bspline import ExplicitBSplineControlMesh
from ..models.extracted import ExtractedSpline
from ..models.shell import svk_psi_surface
from ..models.space import EqualOrderSpline
from ..ops.knots import uniform_knots
from ..solvers.linear import (cg_device_iters, cg_fixed_iters,
                              jacobi_preconditioner)
from ..solvers.multigrid import Multigrid
from ..solvers.newton import NewtonError

E_MOD, NU, H_TH = 1.0e5, 0.3, 0.03
DENS = 1.0
DAMP = 5.0            # mass-proportional damping
DELTA_T = 2.0e-3
LOAD = -8.0           # dead load pressing the membrane down
CONTACT = dict(k=1e7, r_max=0.06, r_self=0.25)
MAX_ITERS, REL_TOL = 60, 1e-4
MG_CG_ITERS = 40
F32 = torch.float32


def build_spline(nel, device="cuda"):
    """The unit square, p=2, nel^2 elements, a 3-field displacement with
    every side clamped (one layer), quadrature degree 4."""
    mesh = ExplicitBSplineControlMesh(
        [2, 2], [uniform_knots(2, 0.0, 1.0, nel)] * 2, extra_dim=1)
    gen = EqualOrderSpline(3, mesh)
    basis = mesh.scalar_basis()
    for d in (0, 1):
        for s in (0, 1):
            dofs = basis.side_dofs(d, s)
            for i in range(3):
                gen.add_zero_dofs(i, dofs)
    return ExtractedSpline(gen, quad_degree=4, nders=2, device=device)


def res(ctx, s, v):
    """The step residual: SVK membrane and bending, mass-proportional
    damping of (u - u_old) / dt, and the dead load."""
    u, uo = s["u"], s["u_old"]
    udot = (u - uo) * (1.0 / DELTA_T)
    dWint = deriv(lambda y: svk_psi_surface(ctx, y, E_MOD, NU, H_TH), u, v)
    dWdamp = DENS * DAMP * H_TH * torch.sum(udot.val * v.val)
    dWext = -LOAD * v.val[2]
    return dWint + dWdamp + dWext


class GraphedAction:
    """W -> fn(W) replayed from a CUDA graph captured once on a static
    input buffer.  ``fn`` must be a fixed map on the card with no host
    synchronisation; its caches are filled by a warm-up call before the
    capture.  Each call copies W in and returns a copy of the output.
    ``fn`` is kept: the graph reads the tensors its closure holds (the
    state, the spline's arrays), which must outlive every replay."""

    def __init__(self, fn, n, dtype, device):
        self._fn = fn
        self._W = torch.zeros(n, dtype=dtype, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(self._W)
        torch.cuda.current_stream(device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._out = fn(self._W)

    def __call__(self, W):
        self._W.copy_(W)
        self._graph.replay()
        return self._out.clone()


def mg_sizes(nel):
    """nel, nel/2, ... while the size stays >= 6 and the last one is even."""
    sizes = []
    n = nel
    while n >= 6 and (not sizes or sizes[-1] % 2 == 0):
        sizes.append(n)
        n //= 2
    return sizes


class ReefKnot:
    """The demo's state: the spline, the contact, the CG and its
    preconditioner.  ``setup_seconds`` is the construction's wall time;
    ``levels`` the hierarchy's sizes (empty without mg)."""

    def __init__(self, nel, mixed=True, mg=True, cg_iters=None,
                 device="cuda"):
        t0 = time.perf_counter()
        self.mixed, self.mg = bool(mixed), bool(mg)
        self.spline = spline = build_spline(nel, device)
        spline.set_solver_options(max_iters=MAX_ITERS,
                                  relative_tolerance=REL_TOL)
        self.cg_iters = (MG_CG_ITERS if mg else max(200, 12 * nel)) \
            if cg_iters is None else int(cg_iters)
        self.contact = PointContact(spline, **CONTACT)
        self.mask = spline.mask
        if mixed:
            self.contact32 = self.contact.astype(F32)
            self.mask32 = self.mask.to(F32)
        self.levels, self.M = [], None
        if mg:
            self.levels = mg_sizes(nel)
            splines = [spline] + [build_spline(s, device)
                                  for s in self.levels[1:]]
            zero_states = [{"u": s._zeros(), "u_old": s._zeros()}
                           for s in splines]
            if mixed:
                A_c = splines[-1].assemble_matrix(res, U=zero_states[-1])
                self.M = Multigrid.from_level_data(
                    [[s.space.fields[0]] * 3 for s in splines],
                    [self._shell_action32(s) for s in splines],
                    [s.assemble_diagonal(res, U=st).to(F32)
                     for s, st in zip(splines, zero_states)],
                    [s.mask.to(F32) for s in splines], A_c, dtype=F32,
                    device=device)
            else:
                self.M = Multigrid(splines, res, states=zero_states)
        if spline.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_seconds = time.perf_counter() - t0

    @staticmethod
    def _graphed(fn, s, dtype):
        """``fn`` on the spline ``s``'s DoFs, as a CUDA graph on the
        card."""
        return GraphedAction(fn, s.ndof, dtype, s.device) \
            if s.device.type == "cuda" else fn

    def _shell_action32(self, s):
        """The f32 shell tangent action of a level at the zero state."""
        z = torch.zeros(s.ndof, dtype=F32, device=s.device)
        state = {"u": z, "u_old": z}
        return self._graphed(
            lambda W: s.tangent_action(res, state, W, dtype=F32), s, F32)

    def residual(self, Ui, U_old):
        """The combined residual at the iterate Ui."""
        state = {"u": Ui, "u_old": U_old}
        return (self.spline.assemble_vector(res, U=state)
                + self.mask * self.contact.residual(Ui))

    def operator(self, Ui, U_old):
        """(A, M, rhs type): the combined tangent action (shell JVP, BC'd
        with unit diagonal, plus the masked contact HVP) and the
        preconditioner, in the CG's precision."""
        sp = self.spline
        state = {"u": Ui, "u_old": U_old}
        dt = F32 if self.mixed else sp.dtype
        if self.mg:
            M = self.M
        else:
            M = jacobi_preconditioner(
                sp.assemble_diagonal(res, U=state).to(dt))
        if self.mixed:
            state32 = {k: v.to(F32) for k, v in state.items()}
            Ui32, c32, m32 = Ui.to(F32), self.contact32, self.mask32
            shell = self._graphed(
                lambda W: sp.tangent_action(res, state32, W, dtype=F32),
                sp, F32)

            def A(W):
                return shell(W) + m32 * c32.tangent_action(Ui32, m32 * W)
        else:
            shell = self._graphed(
                lambda W: sp.tangent_action(res, state, W), sp, sp.dtype)

            def A(W):
                return shell(W) + self.mask * self.contact.tangent_action(
                    Ui, self.mask * W)
        return A, M, dt

    def correction(self, Ui, U_old, r):
        """The Newton correction: the CG solve of A dU = r (cg_device_iters
        with the V-cycle, cg_fixed_iters with Jacobi)."""
        A, M, dt = self.operator(Ui, U_old)
        cg = cg_device_iters if self.mg else cg_fixed_iters
        dU, _ = cg(A, r.to(dt), self.cg_iters, M=M)
        return dU.to(self.spline.dtype)

    def step(self, U, U_old, log=None):
        """One time step from U: Newton to ``REL_TOL`` in at most
        ``MAX_ITERS`` iterations.  Returns (U_new, [(rel, seconds)] of each
        iteration); raises NewtonError without convergence."""
        sp = self.spline
        Ui, n0, hist = U, None, []
        for it in range(sp.max_iters):
            t0 = time.perf_counter()
            r = self.residual(Ui, U_old)
            nrm = float(torch.linalg.norm(r))
            n0 = nrm if n0 is None else n0
            rel = nrm / n0 if n0 > 0 else 0.0
            if rel < sp.relative_tolerance:
                hist.append((rel, time.perf_counter() - t0))
                if log:
                    log(f"  Newton iteration {it}, relative norm {rel:.3e}")
                return Ui, hist
            Ui = Ui - self.correction(Ui, U_old, r)
            float(Ui[0])                    # the iteration's work is done
            hist.append((rel, time.perf_counter() - t0))
            if log:
                log(f"  Newton iteration {it}, relative norm {rel:.3e} "
                    f"({hist[-1][1]:.3f} s)")
        raise NewtonError("Newton failed to converge")


def run(nel, n_steps, mixed=True, mg=True, cg_iters=None, device="cuda",
        log=None):
    """The demo: ``n_steps`` time steps at nel^2 elements.  Returns (U,
    the Newton history of each step as lists of relative norms, the
    final contact energy)."""
    rk = ReefKnot(nel, mixed=mixed, mg=mg, cg_iters=cg_iters, device=device)
    if log:
        log(f"{rk.spline.ndof} DoFs, {rk.contact.X.shape[0]} collocation "
            f"points; multigrid levels {rk.levels}; setup "
            f"{rk.setup_seconds:.3f} s")
    U = rk.spline._zeros()
    U_old = U
    histories = []
    for step in range(n_steps):
        t0 = time.perf_counter()
        Ui, hist = rk.step(U, U_old, log=log)
        U_old, U = U, Ui
        histories.append([h[0] for h in hist])
        if log:
            log(f"step {step + 1}: {len(hist) - 1} Newton iterations, "
                f"{time.perf_counter() - t0:.3f} s")
    return U, histories, float(rk.contact.energy(U))
