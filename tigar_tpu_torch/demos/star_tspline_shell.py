"""The clamped SVK shell on a star T-spline, solved by SANewton (port of
the problem of bench.py's ``_tspline_point``, bench.py:366-455).

The space is the valence-3 extraordinary-point T-spline of
``models.tsplines.make_star_extraction(3, nel)``: three bi-cubic patches
of nel x nel elements meeting at a star vertex inside a regular hexagon
(flat, z = 0), written to a Rhino extraction file and read back, as the
bench does.  Three displacement fields, clamped by ``boundary_dofs(1)``,
E = 3e4, nu = 0.3, h = 0.03, a load q = 0.4 on the third field;
quadrature degree 6 (16 residual points an element), nders 2.  No
tensor-product structure exists, so the solver is the space-agnostic
tier: element-batch tangents (kernel K2's element mode at 48 local
functions, K10) and a multilevel smoothed-aggregation V-cycle built on
the host (K11), with the bench's options.  f64 residuals run on the card
(kernel K1 at 16 points); the bench's host-CPU polish residual is a TPU
workaround and is not ported.

    out = run(48)              # on the card: 6,912 elements, 22,953 DoFs

``ragged_spline`` builds the same shell on a ragged extraction (elements
with fewer than 16 functions: the padding-mask path of the kernels).

``run`` returns the best of 2 warm f32 steps, the solve (time, steps, f64
relative residual, |dU|/|U|, and the host seconds of each SA setup it
ran), the best of 2 warm polish steps at the
solution, the floor certificate of bench._solve_and_certify (the final
f64 residual against K1's plain version on the CPU at the same state) and
each kernel's launches in the solve.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from ..models.bspline import TensorBSplineBasis
from ..models.extracted import ExtractedSpline
from ..models.shell import SVKShellAdjoint, precompute_shell_reference
from ..models.space import EqualOrderSpline
from ..models.tsplines import (RhinoTSplineControlMesh, _parse_tspline_file,
                               bspline_to_rhino_extraction,
                               make_star_extraction, merge_extraction_nodes,
                               write_rhino_extraction)
from ..ops import cuda_ext
from ..ops.knots import uniform_knots
from ..ops.assembly import residual_vector_adjoint_ref
from ..solvers.newton_sa import SANewton

E_MOD, NU, H_TH, Q = 3.0e4, 0.3, 0.03, 0.4
N_SECTORS = 3
QUAD_DEGREE = 6
# SANewton's options at bench.py:418-425 (without the host-CPU polish
# residual)
SA_OPTS = dict(cg_iters=120, polish_cg_iters=160, polish_tangent="f64",
               build_quad_degree=4, rebuild_rel=0.1,
               sa_kwargs={"near_kernel": "linear"})
RTOL = 1e-10
FLOOR_REL = 1e-8


def shell_spline(path, device="cuda"):
    """The 3-field shell spline on the Rhino extraction file at ``path``,
    clamped by ``boundary_dofs(1)`` on every field (bench.py:400-404)."""
    cm = RhinoTSplineControlMesh(path)
    gen = EqualOrderSpline(3, cm)
    bd = cm.scalar_basis().boundary_dofs(1)
    for i in range(3):
        gen.add_zero_dofs(i, bd)
    return precompute_shell_reference(
        ExtractedSpline(gen, quad_degree=QUAD_DEGREE, nders=2,
                        device=device))


def star_spline(nel, device="cuda"):
    """The shell spline on the star T-spline: the extraction written to a
    Rhino file and read back (bench.py:392-404)."""
    bnet, nodes_list, ops_list = make_star_extraction(N_SECTORS, nel)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "star.iga")
        write_rhino_extraction(path, bnet, nodes_list, ops_list)
        return shell_spline(path, device)


def ragged_spline(device="cuda", nel=6):
    """The shell spline on a ragged extraction (tests/test_tsplines.py:144):
    a nel x nel bi-cubic patch exported with ``bspline_to_rhino_extraction``
    and read back, a 2x2 block of interior control points merged into one
    node (``merge_extraction_nodes``: fewer functions on the elements that
    held the block, so the padding mask is not all ones), written and read
    again."""
    basis = TensorBSplineBasis([3, 3], [uniform_knots(3, 0.0, 1.0, nel)] * 2)
    gp = basis.greville_points()
    bnet = np.zeros((basis.ncp, 4))
    bnet[:, :2] = gp
    bnet[:, 2] = 0.05 * gp[:, 0] * (1.0 - gp[:, 0])
    bnet[:, 3] = 1.0
    M = basis.kvs[0].ncp
    block = [2 * M + 2, 2 * M + 3, 3 * M + 2, 3 * M + 3]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "regular.iga")
        bspline_to_rhino_extraction(basis, bnet, path)
        bnet_h, nodes_list, ops_list = _parse_tspline_file(path)
        nodes_list, ops_list, _, used = merge_extraction_nodes(
            nodes_list, ops_list, {n: block[0] for n in block[1:]})
        bnet_m = bnet_h[used]
        bnet_m[used.index(block[0])] = bnet_h[block].mean(axis=0)
        path = os.path.join(d, "ragged.iga")
        write_rhino_extraction(path, bnet_m, nodes_list, ops_list)
        return shell_spline(path, device)


def build(nel, device="cuda", sa_kwargs=None):
    """SANewton on the star shell with the bench's options; ``sa_kwargs``
    entries are added to the bench's (e.g. ``coarse_size`` on a small
    star)."""
    spline = star_spline(nel, device)
    density = SVKShellAdjoint(E_MOD, NU, H_TH, load=(0.0, 0.0, -Q))
    opts = dict(SA_OPTS)
    opts["sa_kwargs"] = {**SA_OPTS["sa_kwargs"], **(sa_kwargs or {})}
    return SANewton(spline, density, **opts)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def certify(ns, U, rel64, dU_rel, floor_rel=FLOOR_REL):
    """bench._solve_and_certify's floor certificate: the final f64
    residual against K1's plain version on the CPU at the same state
    (rel64 <= 3 cpu_rel, rel64 <= floor_rel and |dU|/|U| <= 1e-10), or
    rel64 <= 1e-10.  Returns (cpu_rel, floor_certified, f64_accurate)."""
    r0 = ns.true_rel_residual(torch.zeros_like(U))
    r_cpu = ns.mask64.cpu() * residual_vector_adjoint_ref(
        ns.asm64.to("cpu"), ns.adjoint, U.cpu())
    cpu_rel = float(torch.linalg.norm(r_cpu)) / r0
    floor = bool(rel64 <= 3.0 * max(cpu_rel, 1e-16) and rel64 <= floor_rel
                 and dU_rel <= 1e-10)
    return cpu_rel, floor, bool(rel64 <= RTOL) or floor


def run(nel=48, device="cuda", log=None, ns=None):
    """The bench point at nel elements a sector edge (see the module
    docstring); ``ns`` reuses a solver from ``build`` (reset first, so the
    run starts from the solver's initial state).  Every kernel launch
    count is reset just before the solve and read just after."""
    t0 = time.perf_counter()
    if ns is None:
        ns = build(nel, device)
    ns.reset()
    spline = ns.spline
    dev = spline.device
    _sync(dev)
    setup_s = time.perf_counter() - t0
    if log:
        log(f"star T-spline setup: {setup_s:.3f} s; {spline.ndof} DoFs, "
            f"{ns.asm64.nel} elements, {ns.asm64.nloc} local functions")

    # the best of 2 warm f32 steps (bench._time_step, reps=2)
    U0 = torch.zeros(spline.ndof, dtype=torch.float64, device=dev)
    Ui, rn, _ = ns.step(U0)                   # warm-up (builds the SA)
    float(rn)
    step32_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        Ui, rn, _ = ns.step(Ui)
        float(torch.dot(Ui, Ui))
        step32_s = min(step32_s, time.perf_counter() - t0)

    # the solve keeps the SA hierarchy the warm-up built at the zero state
    # (its first step would build the same one), as the bench's does
    _sync(dev)
    cuda_ext.reset_counts()
    n_setups = len(ns.sa_setup_s)
    t0 = time.perf_counter()
    U, rel64, nsteps, dU_rel = ns.solve(rtol=RTOL, log=log)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    launches = cuda_ext.counts()
    sa_setup_s = ns.sa_setup_s[n_setups:]
    cpu_rel, floor, f64_ok = certify(ns, U, rel64, dU_rel)

    # the best of 2 warm polish steps at the solution (frozen tangents)
    ns.polish_step(U, rebuild=False)
    polish_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        _, rn, _ = ns.polish_step(U, rebuild=False)
        float(rn)
        polish_s = min(polish_s, time.perf_counter() - t0)
    out = dict(ndof=spline.ndof, nel=ns.asm64.nel, setup_s=setup_s,
               step32_s=step32_s, polish_step_s=polish_s, solve_s=solve_s,
               steps=nsteps, rel64=rel64, dU_rel=dU_rel,
               sa_setup_s=sa_setup_s, cpu_rel=cpu_rel,
               floor_certified=floor, f64_accurate=f64_ok,
               launches=launches, levels=getattr(ns._sa, "level_sizes",
                                                  None), U=U)
    if log:
        log(f"star T-spline: f32 step {step32_s * 1e3:.3f} ms, polish step "
            f"{polish_s * 1e3:.3f} ms, solve {solve_s:.3f} s / {nsteps} "
            f"steps, rel64 {rel64:.3e}, |dU|/|U| {dU_rel:.3e}, CPU plain "
            f"rel {cpu_rel:.3e}: floor_certified={floor}, "
            f"f64_accurate={f64_ok}")
        log(f"star T-spline solve: {len(sa_setup_s)} host SA setups, "
            f"{sum(sa_setup_s):.3f} s ({sum(sa_setup_s) / solve_s:.4f} of "
            f"the solve): " + ", ".join(f"{t:.3f}" for t in sa_setup_s))
    return out
