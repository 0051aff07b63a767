#!/usr/bin/env python3
"""GPU smoke run of tigar_tpu_torch on one NVIDIA card: the production
Newton path of the clamped SVK Kirchhoff-Love shell (stencil multigrid,
and the space-agnostic smoothed-aggregation tier, also on a star
T-spline), the two-patch coupled shells, the matrix-free 3D Poisson multigrid path, the generic form
path (2D Poisson through user-written densities, mixed-precision
refinement, smoothed-aggregation CG), the shell with nonlocal penalty
self-contact (the reef-knot demo) and sum-factorized assembly of arbitrary
forms (the shell and a reduced-continuity 3D Poisson).

    python3 chip_smoke.py

Shell problem (as tigar_tpu's bench._build_solver): 128x128 biquadratic
elements, 3 displacement fields, 3*130^2 = 50,700 DoFs, load q=100,
E=1e7, nu=0.3, h=0.03, multigrid levels 64^2, 32^2, 16^2, 8^2; options
cg_iters=15, build_quad_degree=2, rebuild_rel=0.1, polish_tangent="cast".

Poisson problem (as demos/poisson/poisson_large_3d.py): -lap u = f on the
unit cube, u = sin(pi x) sin(pi y) sin(pi z), homogeneous Dirichlet on
every side, p=2, 96^3 elements, 98^3 = 941,192 DoFs, quadrature degree 4;
f64 CG, 20 iterations, preconditioned by an f32 V-cycle over 96/48/24/12/6
with Jacobi V(2,2) smoothing, every operator apply sum-factorized.

Phases, each fatal on failure (nothing is caught):
  1. build the CUDA kernels from tigar_tpu_torch/csrc, then one refused
     call per check site of every binding, each in a child process
     (tigar_tpu_torch.ops.refusals): every one must raise RuntimeError;
  2. per kernel, at the main paths' shapes and seeded inputs: kernel
     against its plain PyTorch twin on the card (max relative error;
     tolerance f64 1e-12, f32 1e-4 on K2's stencils and element
     matrices and 1e-5 elsewhere), both times by CUDA events, the
     kernel's device time per launch by the profiler (taken after phase
     5), and its bound (bytes over 3.35 TB/s or operations over the peak
     rate of the type, the larger); K3 on every grid the V-cycle smooths
     (130^2, 66^2, 34^2, 18^2), every mode, f32 and f64, timed in f32
     and in the f64 fine apply; K4 also on each coarser grid of the
     Poisson V-cycle (48^3 ... 6^3, f32) and at a small periodic 3D and
     a small 2D p=3 case; the library yardsticks of K3's f32 apply (every
     level) and K4 (f32 and f64, 96^3): the same BC'd operator as one
     torch.sparse CSR matrix, CUDA events of the call alone and, later,
     its profiler device time (recorded only where sessions of 10 and of
     all the timed calls record the same whole number of events a call);
  3. the shell main path: one production step after a warm-up (best of
     3), then the full solve to rtol=1e-10 with every launch count reset
     just before it and read just after (K3's also by grid; K2's by
     type and point count, and K4's by grid and type, on every path);
  4. the floor certificate: the final f64 residual against the CPU twin of
     the residual kernel on the same state (rel64 <= 3 cpu_rel,
     rel64 <= 1e-8, |dU|/|U| <= 1e-10; or rel64 <= 1e-10);
  5. the Poisson main path with every launch count reset: setup, the
     96^3 MG-CG solve (cold, then warm), relative residual <= 1e-10, the
     L2 error and K4's launches (21 f64 + 21 x 16 f32);
  6. the shell's small-input reference (nel=8, card against CPU twins) and
     where the shell step's time goes (torch.profiler);
  7. the Poisson solve at 48^3 (rel <= 1e-10, L2 rate log2(e48/e96) >
     2.7), the mixed-precision refinement branch at 96^3, the 12^3
     solve on the card against the CPU twins (U within 1e-10) and where
     the 96^3 solve's time goes.
  8. the two-patch coupled shell (as tigar_tpu's bench._two_patch_point
     with BENCH_TP_NEL=64, BENCH_TP_COUPLING=penalty): the clamped SVK
     plate of the shell path split at x=0 into two non-matching patches
     (64x128 and 64x132 elements, 52,272 DoFs), displacement + rotation
     penalty coupling (pd = 1e2 E h / h_el, pr = 1e2 E h^3 / h_el per
     level), MultiPatchStencilNewton over (64,128,132), (32,64,66),
     (16,32,33) with cg_iters=15, polish_cg_iters=40, polish_tangent="f64",
     build_quad_degree=2, rebuild_rel=0.1.  K1 over the concatenated
     patches, K2 on each patch's element range (f32 and f64), K3's patch
     mode (every mode, f32 and f64; f32 also on the smoothed coarse
     level), K5-K7 against their plain versions at
     these shapes (K5 timed as the call alone, accumulating into one
     buffer; torch.mv on the pre-gathered vector its yardstick, CUDA
     events and profiler device time); the best of 3 warm f32 steps; the
     full solve
     (start_polish, as the bench) with every launch count reset just
     before it and read just after; the
     floor certificate (the final f64 residual within 3x of the CPU plain
     versions of K1 and of the interface residual, and rel64 <= 1e-6 with
     |dU|/|U| <= 1e-10, or rel64 <= 1e-10); the small-input reference at
     the size of tests/test_newton_mp.py (card against CPU plain versions:
     steps within 1, U within 1e-7).
  9. the two-patch shell with the consistent (symmetric Nitsche) coupling,
     bench.py's default two-patch point (BENCH_TP_COUPLING=nitsche): the
     same splines and solver options, EnergyNitscheCoupling on the SVK
     energy per level with beta_d = 10 (D/h_el^3 + E h/h_el), beta_r =
     10 D/h_el.  K8/K9 against their plain versions (f32 and f64, on the
     interface of every level: 768, 384 and 192 points), bounded by the
     operations their function needs (tigar_tpu_torch/csrc/
     nitsche_opcount.cpp, built with the host compiler); the best of 3
     warm f32
     steps; the full solve with the f32 phase first (as the bench) with
     every launch count reset just before it and read just after; the
     floor certificate with the bench's Nitsche guard floor_rel = 1e-8;
     the small-input reference on the Nitsche plate of
     tests/test_newton_mp.py:132 (card against CPU plain versions: steps
     within 1, U within 1e-7).
 10. the shell of phase 3 solved by SANewton, the space-agnostic tier
     (element-batch tangents, a multilevel smoothed-aggregation V-cycle
     built on the host), with the options bench._tspline_point gives it
     (bench.py:418-425: cg_iters=120, polish_cg_iters=160,
     polish_tangent="f64", rebuild_rel=0.1, near_kernel "linear",
     coarse_size 800) and two changes: build_quad_degree=2, as the
     headline shell uses, and f64 residuals on the card (the bench routes
     the polish residual to the host CPU, a TPU workaround).  K2's element
     mode (f32 and f64) with the asymmetry max |E - E^T| / max |E| of
     its matrices (K10 reads their upper triangles), K10 (apply, BC'd
     apply, diagonal; f32 and f64) and K11 (A, P and P^T of every SA
     level on their sliced layouts, every mode each takes: apply,
     residual, the Jacobi sweep, the first sweep from x = 0 and the
     correction b + A x; f32; fill, nonzero and layout bounds) against
     their plain
     versions, K10/K11 also against torch.sparse CSR products; the SA
     level sizes and the host setup seconds; the best of 3 warm f32
     steps; the full solve with every launch count reset just before it
     and read just after; its floor certificate as in phase 4 and its U
     within 1e-7 of phase 3's StencilNewton solution; the small-input
     reference on tests/test_newton_sa.py's 8x8 plate (card against CPU
     plain versions: steps within 1, U within 1e-8).
 11. the generic form path (FEniCS-like densities through ExtractedSpline)
     on tests/test_refinement.py's Poisson at the size of
     tigar_tpu/ops/fastpath.py's measurement: p=2, 256^2 elements, 66,564
     DoFs, quadrature degree 4.  K12 on the element matrices that
     make_laplace_operator builds, against its plain version (2D p=2
     256^2, 2D p=3 32^2, 3D p=2 16^3; f32, 1e-6 of the largest entry: f32
     atomics) and against the f64 AD tangent action (2e-6, as
     tests/test_fastpath.py), its bound beside the JAX layouts' bound, the
     f32 torch.sparse CSR product as its library yardstick (CUDA events
     and profiler device time); the f64 solve with the default options (Jacobi CG
     of the AD tangent action); refine_solve with K12 and f32 Jacobi
     inside (120 inner iterations) to rel < 1e-12 and within 1e-8 of it,
     with every launch count reset just before it and read just after;
     the L2 errors at 128^2 and 256^2 (rate > 2.7); two-level sa_cg at
     128^2 (TwoLevelSA through K11, held to its plain coo cycle at 1e-5;
     within 1e-8 of the 128^2 CG solution) and multilevel sa_cg at 256^2
     (sa_levels=4, within 1e-8), counts reset around each solve; the nel=8
     card-vs-CPU reference (direct, cg, refine_solve, sa_cg: U within
     1e-10); the profile of one refinement sweep.
 12. penalty self-contact: demos/kl_shell_svk/reef_knot_contact.py at its
     reference workload class (NEL=96 MG=1 MIXED=1: p=2, 96^2 elements,
     28,812 DoFs, 9,604 collocation points, k=1e7, r_max=0.06,
     r_self=0.25, Newton to rel 1e-4 with 40 f32 CG iterations under a
     5-level f32 V-cycle of AD shell actions).  With phase 2, before any
     other profiler session: K13/K14 (contact residual and tangent
     action, f32 and f64) against their plain versions on the 96^2
     points at tests/test_contact.py's active state (k=1e4, r_max=0.3,
     r_self=0.05; U = 0.01 N(0, 1), numpy seed 0), f64 1e-12 and f32 1e-5
     of the largest entry, their pair counts, bounds and device times.
     After the other phases' profiles (so that their sessions run before
     any CUDA graph exists): one time step through the demo's entry
     point
     (tigar_tpu_torch.demos.reef_knot_contact.run) with every launch
     count reset just before it and read just after, converging to rel <
     1e-4 within one Newton iteration of the JAX demo's count; K13/K14 at
     the demo's own contact at the state after the step (no profiler);
     the card against the CPU plain versions at NEL=6 (MG=0) and NEL=12
     (MG=1, the form-based V-cycle), f64 CG of 10 iterations (the same
     Newton count, U within 1e-10); the profile of 5 iterations of a
     Newton correction's CG.
 13. sum-factorized forms (make_sumfac_assembler -> residual_vector /
     tangent_action): with phase 2, K15 (jets) and K16 (their transpose)
     against their plain versions, f64 1e-12 and f32 1e-5 of the largest
     entry, on the 128^2 shell's three fields and its control net at
     nders 2, the 24^3 continuity_drop=1 Poisson field at nders 1, a
     small periodic (gather) field and the small RT pair (K16: its two
     launches, element-local window slots then their sums a coefficient),
     with CUDA-event and device times and byte bounds, and, at the shell's
     fields and the
     24^3 field (f64, f32), their library yardstick: the same linear jet
     map as one torch.sparse CSR matrix J (K15: J @ W; K16: J^T @ F),
     built by probing the plain version in colors, CUDA events and
     profiler device time; after phase 11 the main path of
     scripts/bench_shell_sumfac.py (the 128^2 shell, E=1e7, nu=0.3,
     h=0.03, q=1e-2, U = 1e-4 N(0, 1) from numpy seed 0, the shell
     reference on the sumfac ctx): the sumfac residual and tangent action
     (f64) with K15/K16's counts reset just before and read just after,
     each within 1e-9 of the generic assembler's, best of 3 warm times of
     both assemblers' residual and the sumfac tangent action (f32, f64),
     and the 24^3 reduced-continuity Poisson residual (p=2, quadrature
     degree 4, 117,649 DoFs) against the generic one (1e-12), both timed;
     with the small-input references, the card against the CPU plain
     versions at tests/test_sumfac_forms.py's sizes (shell nel=5, 3D
     nel=3; 1e-12).
 14. the star-T-spline shell point of bench._tspline_point at its default
     size (tigar_tpu_torch/demos/star_tspline_shell.py): the valence-3
     star of make_star_extraction(3, 48), written to a Rhino file and read
     back, 6,912 bicubic extraction elements, 22,953 DoFs, clamped by
     boundary_dofs(1), E=3e4, nu=0.3, h=0.03, q=0.4, quadrature degree 6
     (16 points), SANewton with cg_iters=120, polish_cg_iters=160,
     polish_tangent="f64", build_quad_degree=4 (9 points), rebuild_rel=0.1,
     near_kernel "linear", f64 residuals on the card.  With phase 2 (device
     times right away): K2's element mode at 48 local functions (f64, f32;
     9 and 16 points), K10 at nloc 48 and K11 on the star's SA levels, K1
     at 16 points (f64, f32), all against their plain versions at the
     star's shapes, and K1 / K2 also on a ragged extraction (the file of
     tests/test_tsplines.py:144, built with the port's
     bspline_to_rhino_extraction and merge_extraction_nodes: padded
     elements, whose rows of E must be zero).  After phase 13: the demo's
     run(48) (best of 2 warm f32 steps, the solve with every launch count
     reset just before it and read just after, the floor certificate of
     bench._solve_and_certify, the best of 2 warm polish steps); with the
     small-input references, build(4) on the card against the CPU plain
     versions (coarse_size 50: steps within 1, U within 1e-8).
The next-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script raises.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

E_MOD, NU, H_TH, Q = 1.0e7, 0.3, 0.03, 100.0
NEL = 128
TOL = {"f64": 1e-12, "f32": 1e-5, "f32_stencil": 1e-4}

# Poisson path (demos/poisson/poisson_large_3d.py)
P3, NEL3, QD3, MG_ITERS = 2, 96, 4, 20

# the card's published rates (NVIDIA H100 SXM data sheet, 700 W): memory,
# and the fastest arithmetic of each type at its full precision (f32
# outside the tensor cores; f64 on the tensor cores, twice its vector rate)
MEM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}

CARD = None


def say(msg):
    """A result line, tagged with the card's name and power limit."""
    print(f"[{CARD}] {msg}", flush=True)


def build_spline(nel, device, p=2):
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu_torch.models.space import EqualOrderSpline
    from tigar_tpu_torch.models.extracted import ExtractedSpline
    from tigar_tpu_torch.models.shell import precompute_shell_reference

    kvecs = [uniform_knots(p, -1.0, 1.0, nel)] * 2
    cm = ExplicitBSplineControlMesh([p, p], kvecs, extra_dim=1)
    sp = EqualOrderSpline(3, cm)
    basis = cm.scalar_basis()
    for side in (0, 1):
        for direction in (0, 1):
            dofs = basis.side_dofs(direction, side, n_layers=2)
            for i in range(3):
                sp.add_zero_dofs(i, dofs)
    return precompute_shell_reference(
        ExtractedSpline(sp, quad_degree=2 * p, nders=2, device=device))


def build_solver(nel, device, cg_iters=15):
    from tigar_tpu_torch.models.shell import SVKShellAdjoint
    from tigar_tpu_torch.solvers.newton_stencil import StencilNewton

    spline = build_spline(nel, device)
    mg_sizes = []
    n = nel // 2
    while n >= 8 or not mg_sizes:
        mg_sizes.append(n)
        n //= 2
    mg = [build_spline(s, device) for s in mg_sizes]
    density = SVKShellAdjoint(E_MOD, NU, H_TH, load=(0.0, 0.0, -Q))
    ns = StencilNewton(spline, density, mg_splines=mg, cg_iters=cg_iters,
                       polish_tangent="cast", build_quad_degree=2,
                       rebuild_rel=0.1)
    return ns, mg_sizes


def smooth_state(ns, seed=0, amp=0.1):
    """A smooth displacement ~amp: seeded coarsest-level coefficients
    prolonged exactly (knot insertion, f64) to the fine space, BC-masked."""
    from tigar_tpu_torch.solvers.newton_stencil import TensorProlong
    g = torch.Generator().manual_seed(seed)
    coarsest = ns.mg_splines[-1]
    U = amp * torch.randn(coarsest.ndof, generator=g, dtype=torch.float64)
    U = U.to(ns.mask64.device)
    for P in reversed(ns._Ps):
        P64 = TensorProlong([x.double() for x in P.Ps], P.nf, P.shape_f,
                            P.shape_c)
        U = P64.up(U)
    return ns.mask64 * U


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps, match, per_call=1):
    """Device time per call of the kernels whose name contains ``match``
    over ``reps`` calls (torch.profiler, device-side events only), and
    the launches the session recorded per call.  A call launches
    ``per_call`` such kernels; a session that records another number is
    not a measurement (later sessions of this script recorded 0.05-0.9 of
    the launches on an H100, and sessions of short kernels 0.94-0.98),
    so up to three sessions run until one records every launch; the time
    is None when none does."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and match in e.key
              and e.self_device_time_total > 0]
        recorded = sum(e.count for e in ev) / reps
        if recorded == per_call:
            return (sum(e.self_device_time_total for e in ev) / 1e3 / reps,
                    recorded)
    return None, recorded


def library_device_ms(fn, reps):
    """Device time per call of every kernel, copy and memset that ``fn``
    runs (torch.profiler, device-side events), and the events recorded per
    call in sessions of 10 and of ``reps`` calls: the time is None unless
    both record the same whole number of events a call (the library's own
    launches, whatever their names)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity

    def session(n):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
        return (sum(e.count for e in ev) / n,
                sum(e.self_device_time_total for e in ev) / 1e3 / n)

    few, _ = session(10)
    got, t = session(reps)
    if few == 0 or few != int(few) or got != few:
        return None, got, few
    return t, got, few


def kernel_device_times(rec):
    """Device time per launch of the timed kernel phases, and per call of
    their library yardsticks (torch.profiler), taken after the main paths
    so that no profiler session precedes their timing."""
    for phases in rec.values():
        for p in phases:
            if "probe" in p:
                probe_device_time(p)
            if "library_probe" in p:
                fn, reps = p.pop("library_probe")
                p["library_dev_ms"], got, few = library_device_ms(fn, reps)
                dev = (f"not measured (sessions of 10 and {reps} calls "
                       f"recorded {few:g} and {got:g} events a call)"
                       if p["library_dev_ms"] is None
                       else f"{p['library_dev_ms']:.4f} ms ({got:g} events "
                            f"a call)")
                say(f"{p['name']}: library device time per call {dev}")


def probe_device_time(p):
    """Takes the profiler's device time of the phase record ``p``."""
    fn, reps, match, per_call = p.pop("probe")
    p["dev_ms"], recorded = device_ms(fn, reps, match, per_call)
    dev = (f"not measured (the session recorded {recorded:g} of "
           f"{per_call} launches a call)" if p["dev_ms"] is None
           else f"{p['dev_ms']:.4f} ms")
    say(f"{p['name']}: device time per call ({match}, {per_call} "
        f"launches a call) {dev}")


def bound(nbytes, flops, dtype):
    """(least time in ms, "bytes" or "operations"): each input read once
    and each output written once at MEM_BPS, against ``flops`` at the
    type's peak rate."""
    t_mem = nbytes / MEM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, kernel, twin, tol, reps, twin_reps, record, match=None,
            work=None, per_call=1, timed=None):
    """Kernel against twin on the same inputs: errors, times, the gate.
    ``match`` names the kernel for the profiler's device time (taken later
    by ``kernel_device_times``), which a call launches ``per_call``
    times; ``work`` = (bytes, flops,
    dtype) gives its bound; ``twin_reps`` 0 leaves the twin untimed;
    ``timed`` (default ``kernel``) is the call that the CUDA events and
    the profiler time."""
    yk = kernel()
    yt = twin()
    torch.cuda.synchronize()
    if tuple(yk.shape) != tuple(yt.shape) or not bool(
            torch.isfinite(yk).all()):
        raise SystemExit(f"{name}: kernel output is not finite or has the "
                         f"wrong shape {tuple(yk.shape)}")
    abs_err = float((yk - yt).abs().max())
    rel = abs_err / float(yt.abs().max())
    timed = kernel if timed is None else timed
    ms = cuda_ms(timed, reps)
    plain_ms = cuda_ms(twin, twin_reps) if twin_reps else None
    twin_txt = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
    say(f"phase {name}: max rel err {rel:.3e} (tol {tol:g}), max abs err "
        f"{abs_err:.3e}, kernel {ms:.4f} ms, twin {twin_txt}")
    if not rel <= tol:
        raise SystemExit(f"phase {name} FAILED: rel err {rel:.3e} > {tol:g}")
    entry = dict(name=name, rel=rel, abs=abs_err, ms=ms, plain_ms=plain_ms)
    if match is not None:
        entry["probe"] = (timed, reps, match, per_call)
    if work is not None:
        entry["bound_ms"], entry["bound_by"] = bound(*work)
        say(f"    bound {entry['bound_ms']:.4f} ms by {entry['bound_by']} "
            f"({work[0] / 1e6:.2f} MB, {work[1] / 1e9:.4f} GFLOP)")
    record.append(entry)


def csr_rows(keep, vals, cols, dtype=torch.float32):
    """One torch.sparse CSR matrix of ``dtype`` from row-major candidates:
    ``keep``, ``vals`` and ``cols`` [n, k], each row's columns
    ascending."""
    n = keep.shape[0]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=keep.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(
        crow.to(torch.int32), cols[keep].to(torch.int32),
        vals[keep].to(dtype), (n, n), check_invariants=True)


def stencil_csr(st, mask, dtype=torch.float32):
    """K3's apply mode with a mask, mask A (mask x) + (1 - mask) x, as one
    CSR matrix of ``dtype``: row (f, iy, ix) holds column (g, iy + oy,
    ix + ox) of S[f, g, oy, ox, iy, ix] (zero padding, as K3), masked-out
    entries
    dropped, 1 - mask added on the diagonal."""
    S = st.S.to(torch.float64)
    nf, (ny, nx), (py, px) = st.nf, st.grid_shape, st.degrees
    n, dev = ny * nx, S.device
    oy = torch.arange(-py, py + 1, device=dev)
    ox = torch.arange(-px, px + 1, device=dev)
    jy = torch.arange(ny, device=dev)[:, None, None, None] + oy[:, None]
    jx = torch.arange(nx, device=dev)[None, :, None, None] + ox[None, :]
    ok = (jy >= 0) & (jy < ny) & (jx >= 0) & (jx < nx)  # [ny, nx, ky, kx]
    pos = (jy * nx + jx).clamp(0, n - 1)
    g = torch.arange(nf, device=dev)[:, None, None]
    cols = g * n + pos[:, :, None]                       # [ny, nx, g, ky, kx]
    m = mask.to(torch.float64)
    vals = S.permute(0, 4, 5, 1, 2, 3) * m.view(nf, ny, nx, 1, 1, 1) \
        * m[cols][None]                                  # [f, ny, nx, ...]
    diag = torch.zeros_like(vals, dtype=torch.bool)
    for f in range(nf):
        diag[f, :, :, f, py, px] = True
    vals = vals + diag * (1.0 - m).view(nf, ny, nx, 1, 1, 1)
    keep = ok[None, :, :, None] & ((vals != 0) | diag)
    k = nf * (2 * py + 1) * (2 * px + 1)
    return csr_rows(keep.reshape(nf * n, k), vals.reshape(nf * n, k),
                   cols[None].expand(nf, -1, -1, -1, -1, -1)
                   .reshape(nf * n, k), dtype)


def shell_certificate(ns, Usol, rel64, dU_rel, label="shell"):
    """The CPU twin of K1 on the final state: rel64 <= 3 cpu_rel,
    rel64 <= 1e-8 and |dU|/|U| <= 1e-10; or rel64 <= 1e-10."""
    from tigar_tpu_torch.ops.assembly import residual_vector_adjoint_ref
    r0_64 = ns.true_rel_residual(torch.zeros_like(Usol))
    r_cpu = ns.mask64.cpu() * residual_vector_adjoint_ref(
        ns.asm64.to("cpu"), ns.adjoint, Usol.cpu())
    cpu_rel = float(torch.linalg.norm(r_cpu)) / r0_64
    floor_ok = bool(rel64 <= 3.0 * max(cpu_rel, 1e-16) and rel64 <= 1e-8
                    and dU_rel <= 1e-10)
    f64_ok = bool(rel64 <= 1e-10) or floor_ok
    say(f"{label} floor certificate: rel64 {rel64:.3e}, CPU-twin f64 rel "
        f"{cpu_rel:.3e}, |dU|/|U| {dU_rel:.3e}: floor_certified={floor_ok}, "
        f"f64_accurate={f64_ok}")
    if not f64_ok:
        raise SystemExit(f"{label} floor certificate FAILED")


# K2's stencil mode, operations a point: the 18x18 pointwise Jacobian with
# each of 27 local functions in 6 jet slots, and E's symmetric half
K2_STENCIL_OPS = 2.0 * (18 * 27 * 6 + 27 * 28 // 2 * 6)


def kernel_phases(ns):
    from tigar_tpu_torch.ops.assembly import (residual_vector_adjoint_ref,
                                              shell_kernel_args)
    from tigar_tpu_torch.ops.stencil import (build_stencil,
                                             build_stencil_ref,
                                             stencil_apply, stencil_apply_ref)

    dens = ns.adjoint
    U64 = smooth_state(ns)
    U32 = U64.float()
    say(f"kernel-phase state: max |U| {float(U64.abs().max()):.4f}")
    rec = {"shell_residual": [], "tangent_stencil": [], "stencil_apply": []}

    for tag, asm, U, tol in (("f64", ns.asm64, U64, TOL["f64"]),
                             ("f32", ns.asm32, U32, TOL["f32"])):
        # K1 reads U and the per-point data once and writes r; operations:
        # at least the jet contractions, 2 x 189 multiply-adds per point
        args = shell_kernel_args(asm, dens, U)
        work = (nbytes(U, U, *args), 756.0 * asm.nel * asm.nq, U.dtype)
        compare(f"K1 shell_residual {tag} nq={asm.nq}",
                lambda a=asm, u=U: a.residual_vector_adjoint(dens, u),
                lambda a=asm, u=U: residual_vector_adjoint_ref(a, dens, u),
                tol, 20, 3, rec["shell_residual"],
                match="shell_residual_kernel", work=work)

    basis = ns.basis
    for asm in (ns.asm_b32, ns.asm32):
        # K2 reads all but N and writes S; operations: at least the
        # element matrix of the 18x18 pointwise Jacobian with each local
        # function in 6 jet slots, E's symmetric half only,
        # 2 (18*27*6 + 27*28/2*6) per point
        args = shell_kernel_args(asm, dens, U32)
        S_bytes = 225 * ns.mask32.numel() // 3 * 4
        work = (nbytes(U32, *args[:1], *args[2:]) + S_bytes,
                K2_STENCIL_OPS * asm.nel * asm.nq, torch.float32)
        compare(f"K2 tangent_stencil f32 nq={asm.nq}",
                lambda a=asm: build_stencil(a, dens, U32, basis, 3).S,
                lambda a=asm: build_stencil_ref(a, dens, U32, basis, 3).S,
                TOL["f32_stencil"], 5, 1, rec["tangent_stencil"],
                match="tangent_stencil", per_call=2, work=work)

    # K3 on every smoothed level of the V-cycle (the fine grid and the
    # coarse grids but the last, whose dense inverse is the coarse solve),
    # every mode, f32 as the V-cycle runs it and f64 as the polish's fine
    # apply; times of the f32 rows and the f64 fine apply, the library
    # yardstick of each f32 apply
    st_fine = build_stencil(ns.asm_b32, dens, U32, basis, 3)
    levels = [("fine", st_fine, ns.mask32)] + [
        (f"level {l}", st, m) for l, (st, m) in enumerate(
            zip(ns._coarse_sts[:-1], ns._coarse_masks[:-1]), 1)]
    g = torch.Generator().manual_seed(1)
    for lname, st32, m32 in levels:
        n = st32.ndof
        for tag, dt, tol in (("f32", torch.float32, TOL["f32"]),
                             ("f64", torch.float64, TOL["f64"])):
            st = st32.astype(dt)
            m = m32.to(dt)
            x, b = (torch.randn(n, generator=g, dtype=torch.float64)
                    .to(m.device, dt) for _ in range(2))
            dinv = 1.0 / (m * st.diagonal() + (1.0 - m))
            for mode in ("apply", "residual", "jacobi"):
                kw = dict(mask=m, b=b, dinv=dinv, omega=0.7, mode=mode)
                timed = tag == "f32" or (lname, mode) == ("fine", "apply")
                compare(f"K3 stencil_apply {mode} {tag} {lname} "
                        f"grid={st.grid_shape}",
                        lambda s=st, kw=kw, x=x: stencil_apply(s, x, **kw),
                        lambda s=st, kw=kw, x=x: stencil_apply_ref(s, x,
                                                                   **kw),
                        tol, 50, 10, rec["stencil_apply"],
                        match="stencil_apply_kernel" if timed else None,
                        work=stencil_work(st, mode))
                if mode == "apply" and (tag == "f32" or lname == "fine"):
                    stencil_library(st, m, x, rec["stencil_apply"][-1])
    return rec


def stencil_work(st, mode):
    """K3's work for ``bound`` on the grid of ``st`` (alone or as a patch):
    it reads S once and the grid's 3 fields of x, the mask (and b, and
    dinv, by mode), and writes y there; 225 multiply-adds a grid point."""
    n = int(np.prod(st.grid_shape))
    nvec = {"apply": 3, "residual": 4, "jacobi": 5}[mode]
    return (nbytes(st.S) + nvec * 3 * n * st.S.element_size(), 450.0 * n,
            st.S.dtype)


def stencil_library(st, m, x, entry, patch=None):
    """The library yardstick of K3's apply mode: the same BC'd operator as
    one torch.sparse CSR matrix of the stencil's type applied with ``@``
    (CUDA events of the call alone; the profiler's device time later).  In
    patch mode (``patch`` = (base, field stride)) the matrix has the
    patch's rows and its columns at the patch's positions in x."""
    from tigar_tpu_torch.ops.stencil import stencil_apply
    if patch is None:
        A = stencil_csr(st, m, st.S.dtype)
        ref = stencil_apply(st, x, mask=m)
    else:
        n = int(np.prod(st.grid_shape))
        pos = torch.cat([torch.arange(n, device=x.device) + patch[0]
                         + f * patch[1] for f in range(st.nf)])
        Ap = stencil_csr(st, m[pos], st.S.dtype)
        A = torch.sparse_csr_tensor(
            Ap.crow_indices(), pos[Ap.col_indices().long()].to(torch.int32),
            Ap.values(), (Ap.shape[0], x.numel()))
        ref = stencil_apply(st, x, mask=m, out=torch.zeros_like(x),
                            base=patch[0], fstride=patch[1])[pos]
    err = rel_diff(torch.mv(A, x), ref)
    entry["library_ms"] = cuda_ms(lambda A=A, x=x: torch.mv(A, x), 50)
    entry["library_probe"] = (lambda A=A, x=x: torch.mv(A, x), 50)
    say(f"    library yardstick torch.sparse CSR {x.dtype} @ x "
        f"({A._nnz()} entries, {A.shape[0]} rows): "
        f"{entry['library_ms']:.4f} ms, rel diff {err:.1e}")


# -- the Poisson path ---------------------------------------------------------


def poisson_levels(nel):
    """Multigrid bases [nel, nel/2, ...] down to 6 elements per direction
    (as the demo), each with its homogeneous Dirichlet mask."""
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import TensorBSplineBasis
    sizes = []
    n = nel
    while n >= 6 and (not sizes or sizes[-1] % 2 == 0):
        sizes.append(n)
        n //= 2
    bases = [TensorBSplineBasis([P3] * 3,
                                [uniform_knots(P3, 0.0, 1.0, s)] * 3)
             for s in sizes]
    masks = []
    for bs in bases:
        m = np.ones(bs.ncp)
        for d in range(3):
            for side in (0, 1):
                m[bs.side_dofs(d, side)] = 0.0
        masks.append(m)
    return bases, masks


def soln(x, y, z):
    return torch.sin(torch.pi * x) * torch.sin(torch.pi * y) \
        * torch.sin(torch.pi * z)


def f_rhs(x, y, z):
    return 3.0 * torch.pi ** 2 * soln(x, y, z)


def poisson_setup(nel, device):
    """Right-hand side, the f64 operator and the f32 V-cycle (as the demo)."""
    from tigar_tpu_torch.ops.sumfac import (make_sumfac_identity_operator,
                                            sumfac_linear_form)
    from tigar_tpu_torch.solvers.multigrid import identity_poisson_multigrid
    bases, masks = poisson_levels(nel)
    mask64 = torch.as_tensor(masks[0], device=device)
    b = sumfac_linear_form(bases[0], QD3, f_rhs, device=device) * mask64
    op64 = make_sumfac_identity_operator(bases[0], QD3, mask=mask64,
                                         device=device)
    mg32 = identity_poisson_multigrid(bases, QD3, masks,
                                      dtype=torch.float32, device=device)
    return dict(bases=bases, mask64=mask64, b=b, op64=op64,
                M=lambda r: mg32(r.to(torch.float32)).to(r.dtype))


def poisson_solve(pb):
    """The MG-CG solve: (U, relative residual)."""
    from tigar_tpu_torch.solvers.linear import cg_fixed_iters
    U, r = cg_fixed_iters(pb["op64"], pb["b"], MG_ITERS, M=pb["M"])
    rel = float(torch.linalg.norm(r)) / float(torch.linalg.norm(pb["b"]))
    if tuple(U.shape) != (pb["b"].numel(),) or not bool(
            torch.isfinite(U).all()):
        raise SystemExit("Poisson solution is not finite or has the wrong "
                         "shape")
    return U, rel


def l2_error(pb, U):
    from tigar_tpu_torch.ops.sumfac import sumfac_l2_error
    return float(sumfac_l2_error(pb["bases"][0], QD3, U, soln))


def sumfac_flops(data):
    """Operations of one K4 apply: per element the forward and the
    transposed contraction chains (2 Q P1^3 + 3 Q^2 P1^2 + 4 Q^3 P1
    multiply-adds each way in 3D, 2 Q P1^2 + 3 Q^2 P1 in 2D) plus one
    weight product per field and point."""
    P1, Q, dim = data.degrees[0] + 1, data.nq, data.dim
    if dim == 3:
        ma = 2 * Q * P1 ** 3 + 3 * Q ** 2 * P1 ** 2 + 4 * Q ** 3 * P1
    else:
        ma = 2 * Q * P1 ** 2 + 3 * Q ** 2 * P1
    nel = int(np.prod(data.nel_d))
    return float(nel * (2 * 2 * ma + (dim + 1) * Q ** dim))


def sumfac_csr(data, mask, dtype=torch.float32):
    """K4's identity-geometry stiffness apply (ck = 1, cm = 0) with a mask
    as one CSR matrix of ``dtype``: A = sum_c kron_d T_d^(c), T_d^(c) the 1D
    stiffness matrix of direction d when d = c, else its mass matrix;
    mask A mask + diag(1 - mask), masked-out entries dropped.  Rows in
    K4's order (direction 0 fastest); open knot vectors."""
    dev, dim = mask.device, data.dim
    wins = data.windows()
    shape = tuple(data.ncp_d[::-1])
    n_all = int(np.prod(shape))
    stride = [int(np.prod(data.ncp_d[:d])) for d in range(dim)]
    bands, oks, offs = [], [], []
    for d in range(dim):
        n, p = data.ncp_d[d], data.degrees[d]
        o = torch.arange(-p, p + 1, device=dev)
        j = torch.arange(n, device=dev)[:, None] + o
        ok = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        w = data.w[d].to(torch.float64)
        idx = (wins[d][:, :, None] * n + wins[d][:, None, :]).reshape(-1)
        pair = []
        for X in (data.B[d], data.D[d]):
            X = X.to(torch.float64)
            T = torch.zeros(n * n, dtype=torch.float64, device=dev)
            T.index_add_(0, idx, torch.einsum("eq,eqa,eqb->eab", w, X,
                                              X).reshape(-1))
            pair.append(torch.where(ok, T.view(n, n)[torch.arange(
                n, device=dev)[:, None], jc], 0.0))
        # the band [n_d, 2 p_d + 1] broadcast over (i_{dim-1}..i_0,
        # o_{dim-1}..o_0)
        view = [1] * (2 * dim)
        view[dim - 1 - d], view[2 * dim - 1 - d] = n, 2 * p + 1
        bands.append([b.view(view) for b in pair])    # (mass, stiffness)
        oks.append(ok.view(view))
        ov = [1] * (2 * dim)
        ov[2 * dim - 1 - d] = 2 * p + 1
        offs.append((o * stride[d]).view(ov))
    vals = 0.0
    for c in range(dim):
        term = 1.0
        for d in range(dim):
            term = term * bands[d][1 if d == c else 0]
        vals = vals + term
    ok = oks[0]
    off = offs[0]
    for d in range(1, dim):
        ok, off = ok & oks[d], off + offs[d]
    k = int(np.prod([2 * p + 1 for p in data.degrees]))
    vals = vals.expand(shape + vals.shape[dim:]).reshape(n_all, k)
    ok = ok.expand(shape + ok.shape[dim:]).reshape(n_all, k)
    rows = torch.arange(n_all, device=dev)[:, None]
    cols = (rows + off.reshape(1, k)).clamp(0, n_all - 1)
    m = mask.to(torch.float64)
    vals = vals * m[:, None] * m[cols]
    vals[:, k // 2] += 1.0 - m
    keep = ok & (vals != 0)
    keep[:, k // 2] = True
    return csr_rows(keep, vals, cols, dtype)


def sumfac_phases(device):
    """K4 against its plain version: at the Poisson path's fine level in
    f64 and f32, at each coarser grid of its V-cycle in f32, and once at a
    small periodic 3D and a small 2D p=3 case."""
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import TensorBSplineBasis
    from tigar_tpu_torch.ops.sumfac import (build_sumfac_data, sumfac_apply,
                                            sumfac_apply_ref)
    bases, masks = poisson_levels(NEL3)
    rng = np.random.default_rng(2)
    W64 = torch.as_tensor(rng.normal(size=bases[0].ncp), device=device)
    rec = []
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
        data = build_sumfac_data(bases[0], None, QD3, device, dt)
        W, m = W64.to(dt), torch.as_tensor(masks[0], device=device).to(dt)
        tables = data.B + data.D + data.w + data.starts
        work = (nbytes(W, m, W, *tables), sumfac_flops(data), dt)
        compare(f"K4 sumfac_apply {tag} {NEL3}^3 p={P3}",
                lambda d=data, w=W, m=m: sumfac_apply(d, w, 1.0, 0.0, m),
                lambda d=data, w=W, m=m: sumfac_apply_ref(d, w, 1.0, 0.0, m),
                TOL[tag], 50, 3, rec, match="sumfac", work=work,
                per_call=2)
        # the library yardstick: the same BC'd operator as one
        # torch.sparse CSR matrix of the same type applied with ``@``
        A = sumfac_csr(data, m, dt)
        err = rel_diff(torch.mv(A, W), sumfac_apply(data, W, 1.0, 0.0, m))
        rec[-1]["library_ms"] = cuda_ms(lambda A=A, x=W: torch.mv(A, x), 50)
        rec[-1]["library_probe"] = (lambda A=A, x=W: torch.mv(A, x), 50)
        say(f"    library yardstick torch.sparse CSR {tag} @ W "
            f"({A._nnz()} entries): {rec[-1]['library_ms']:.4f} ms, "
            f"rel diff {err:.1e}")

    # the V-cycle's coarser grids, in its type
    for basis, mask in zip(bases[1:], masks[1:]):
        data = build_sumfac_data(basis, None, QD3, device, torch.float32)
        W = torch.as_tensor(rng.normal(size=basis.ncp), device=device,
                            dtype=torch.float32)
        m = torch.as_tensor(mask, device=device, dtype=torch.float32)
        tables = data.B + data.D + data.w + data.starts
        n = basis.nel_per_dir[0]
        compare(f"K4 sumfac_apply f32 {n}^3 p={P3}",
                lambda d=data, w=W, m=m: sumfac_apply(d, w, 1.0, 0.0, m),
                lambda d=data, w=W, m=m: sumfac_apply_ref(d, w, 1.0, 0.0, m),
                TOL["f32"], 50, 1, rec, match="sumfac",
                work=(nbytes(W, m, W, *tables), sumfac_flops(data),
                      torch.float32), per_call=2)

    small = (("periodic 3D nel=8 p=2", 3, 2, 8, True),
             ("2D nel=64 p=3", 2, 3, 64, False))
    for label, dim, p, nel, per in small:
        basis = TensorBSplineBasis([p] * dim, [uniform_knots(
            p, 0.0, 1.0, nel, periodic=per)] * dim)
        Ws = torch.as_tensor(rng.normal(size=basis.ncp), device=device)
        for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
            data = build_sumfac_data(basis, None, 2 * p, device, dt)
            compare(f"K4 sumfac_apply {tag} {label}",
                    lambda d=data, w=Ws.to(dt): sumfac_apply(d, w, 1.0, 0.7),
                    lambda d=data, w=Ws.to(dt): sumfac_apply_ref(d, w, 1.0,
                                                                 0.7),
                    TOL[tag], 10, 3, rec)
    return rec


def k3_levels(label):
    """K3's launches by grid since the last count reset, printed (None
    from a tree whose wrapper keeps no tally by grid)."""
    from tigar_tpu_torch.ops import cuda_ext
    by = getattr(cuda_ext, "counts_by", None)
    if by is None:
        return None
    lv = {f"{g[0]}x{g[1]}": c
          for g, c in sorted(by("stencil_apply").items(), reverse=True)}
    say(f"{label} K3 launches by grid: {lv}")
    return lv


# K2's launches by type and point count (and local functions, element
# mode), K4's by grid and type, per path: filled by ``tally``
TALLIES = {}


def tally(path, names):
    """The launches of kernels ``names`` by the key their wrappers give
    (``cuda_ext.counts_by``) since the last count reset, printed and kept
    in TALLIES[path] (empty from a tree whose wrappers give no key)."""
    from tigar_tpu_torch.ops import cuda_ext
    got = {n: {str(k): c for k, c in sorted(cuda_ext.counts_by(n).items(),
                                            key=str)} for n in names}
    TALLIES[path] = got
    say(f"{path} launches by key: {got}")
    return got


def best_of_3(fn):
    best = np.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def profile_steps(ns, U, step_s):
    """torch.profiler trace of the steps named in ``step_s`` (a production
    step, a polish step) at state U; prints device time by kernel and the
    device's busy share of the un-profiled step wall time ``step_s``, and
    returns the busy shares by label.
    Only device-side events
    (kernels, copies, memsets) are summed: the CPU op rows of key_averages
    carry the device time of the kernels they launch, which appear as rows
    of their own (the rule of the profiler's own table footer)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    runs = {"production step": lambda: ns.step(U),
            "polish step": lambda: ns.polish_step(U)}
    busy = {}
    for label in step_s:
        fn = runs[label]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation
                and e.self_device_time_total > 0]
        dev_ms = sum(r[2] for r in rows) / 1e3
        if not rows:
            say(f"profile {label}: no device time recorded (not measured)")
            continue
        ref = step_s[label] * 1e3
        busy[label] = dev_ms / ref
        say(f"profile {label}: device busy {dev_ms:.3f} ms of {ref:.3f} ms "
            f"un-profiled wall (busy share {dev_ms / ref:.3f}); "
            f"profiled wall {wall * 1e3:.3f} ms; {sum(r[1] for r in rows)} "
            f"device ops")
        for key, count, us in sorted(rows, key=lambda r: -r[2])[:10]:
            say(f"    {us / 1e3:9.3f} ms  {us / 1e3 / dev_ms:6.3f} of busy  "
                f"{count:6d} x  {key[:90]}")
    return busy


def poisson_main_path(device):
    """Setup and the 96^3 MG-CG solve with every launch count reset:
    returns the problem, U, and K4's launches in the cold solve."""
    from tigar_tpu_torch.ops import cuda_ext
    t0 = time.perf_counter()
    pb = poisson_setup(NEL3, device)
    torch.cuda.synchronize()
    say(f"poisson setup + RHS: {time.perf_counter() - t0:.3f} s; "
        f"ndof={pb['b'].numel()}, nel={NEL3}^3, mg levels="
        f"{[b.nel_per_dir[0] for b in pb['bases']]}")
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    U, rel = poisson_solve(pb)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = cuda_ext.counts()["sumfac_apply"]
    tally("poisson", ("sumfac_apply",))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    _, rel_w = poisson_solve(pb)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    err = l2_error(pb, U)
    nlev = len(pb["bases"])
    expected = (MG_ITERS + 1) * (1 + 4 * (nlev - 1))
    say(f"poisson MG-CG solve ({nlev} levels, {MG_ITERS} iterations): cold "
        f"{t_cold:.3f} s, warm {t_warm:.3f} s; relative residual {rel:.3e} "
        f"(warm {rel_w:.3e}); L2 error {err:.4e}; K4 launches {launches} "
        f"(expected {MG_ITERS + 1} f64 + {MG_ITERS + 1} x "
        f"{4 * (nlev - 1)} f32 = {expected}); peak device memory "
        f"{peak_gb:.3f} GiB")
    if not (rel <= 1e-10 and rel_w <= 1e-10):
        raise SystemExit(f"Poisson MG-CG FAILED: rel {rel:.3e} > 1e-10")
    if launches != expected:
        raise SystemExit(f"Poisson main path launched K4 {launches} times, "
                         f"expected {expected}")
    return pb, U, err, launches


def poisson_checks(device, pb, err96):
    """48^3 (h-independence and the L2 rate), the refinement branch, the
    12^3 reference against the CPU twins, and the 96^3 solve's profile."""
    from tigar_tpu_torch.ops.sumfac import make_sumfac_identity_operator
    from tigar_tpu_torch.solvers.refinement import refine_solve

    pb48 = poisson_setup(NEL3 // 2, device)
    U48, rel48 = poisson_solve(pb48)
    err48 = l2_error(pb48, U48)
    rate = float(np.log2(err48 / err96))
    say(f"poisson {NEL3 // 2}^3: relative residual {rel48:.3e}, L2 error "
        f"{err48:.4e}; L2 rate log2(e{NEL3 // 2}/e{NEL3}) = {rate:.4f}")
    if not (rel48 <= 1e-10 and rate > 2.7):
        raise SystemExit("Poisson h-independence / L2 rate FAILED")

    op32 = make_sumfac_identity_operator(
        pb["bases"][0], QD3, mask=pb["mask64"].to(torch.float32),
        dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Ur, sweeps, rel_r = refine_solve(pb["op64"], op32, pb["b"], tol=1e-12,
                                     max_sweeps=30, inner_iters=50)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    say(f"poisson {NEL3}^3 mixed-precision refinement: {t_ref:.3f} s, "
        f"{sweeps} sweeps, relative residual {rel_r:.3e}, L2 error "
        f"{l2_error(pb, Ur):.4e}")
    if not rel_r < 1e-12:
        raise SystemExit("Poisson refinement did not reach 1e-12")

    pg, pc = poisson_setup(12, device), poisson_setup(12, "cpu")
    (Ug, relg), (Uc, relc) = poisson_solve(pg), poisson_solve(pc)
    diff = float((Ug.cpu() - Uc).abs().max() / Uc.abs().max())
    say(f"poisson small-input reference (12^3): card rel {relg:.3e}, CPU "
        f"twins rel {relc:.3e}, max rel diff of U {diff:.3e}")
    if not (diff <= 1e-10 and relg <= 1e-10):
        raise SystemExit("Poisson small-input reference FAILED")

    profile_poisson(pb)


def profile_poisson(pb):
    """torch.profiler over one warm 96^3 MG-CG solve: device busy time
    against the un-profiled wall, and the largest kernels; returns the
    busy and wall ms, the busy share and K4's device ms (None where
    nothing was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poisson_solve(pb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        poisson_solve(pb)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]
    if not rows:
        say("profile poisson solve: no device time recorded (not measured)")
        return None
    dev_ms = sum(r[2] for r in rows) / 1e3
    say(f"profile poisson solve: device busy {dev_ms:.3f} ms of "
        f"{wall * 1e3:.3f} ms un-profiled wall (busy share "
        f"{dev_ms / wall / 1e3:.3f}); {sum(r[1] for r in rows)} device ops")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:10]:
        say(f"    {us / 1e3:9.3f} ms  {us / 1e3 / dev_ms:6.3f} of busy  "
            f"{count:6d} x  {key[:90]}")
    return dict(busy_ms=dev_ms, wall_ms=wall * 1e3,
                busy=dev_ms / wall / 1e3,
                k4_ms=sum(r[2] for r in rows if "sumfac" in r[0]) / 1e3,
                k4_launches=sum(r[1] for r in rows if "sumfac" in r[0]))


# -- the two-patch coupled shell path -------------------------------------------

TP_NEL = 64                       # bench.py's BENCH_TP_NEL default
TP_FLOOR_REL = 1e-6               # bench.py's penalty-mode floor_rel
TP_NITSCHE_FLOOR_REL = 1e-8       # bench.py's Nitsche-mode floor_rel
TP_REF = dict(E=1.0e7, h=0.05, q=0.05, nel=8)   # tests/test_newton_mp.py



def nitsche_ops():
    """Operations a point and side of K8/K9's function, from the host
    counting program tigar_tpu_torch/csrc/nitsche_opcount.cpp, built here
    with the host compiler: the reference geometry (geom), the jets
    (jets), the reverse-mode gradient (grad) and the forward-over-reverse
    Hessian and flux Jacobian (hess) of the side's flux pairing, and the
    kernels' own first- and second-order flux passes (pass1, pass2).  The
    program checks its derivatives against the kernels' passes and exits
    1 if they disagree."""
    src = os.path.join(ROOT, "tigar_tpu_torch", "csrc",
                       "nitsche_opcount.cpp")
    exe = os.path.join(ROOT, "build", "nitsche_opcount")
    os.makedirs(os.path.dirname(exe), exist_ok=True)
    subprocess.run([os.environ.get("CXX", "c++"), "-std=c++17", "-O1",
                    "-o", exe, src], check=True)
    out = subprocess.run([exe], capture_output=True, text=True,
                         check=True).stdout
    rep = json.loads(out.strip().splitlines()[-1])
    say(f"Nitsche operation count a point and side (nitsche_opcount): "
        f"{rep['per_side']}, derivative checks {rep['rel_err']}")
    return rep["per_side"]


def two_patch_spline(nx, nay, nby, device, bench=True):
    """Two biquadratic patches A (nx x nay) and B (nx x nby) meeting at a
    non-matching interface.  ``bench``: bench._two_patch_point's plate,
    [-1,0] x [-1,1] and [0,1] x [-1,1], every outer side clamped;
    otherwise tests/test_newton_mp.py's, [0,1]^2 and [1,2] x [0,1],
    clamped at x = 0."""
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import TensorBSplineBasis
    from tigar_tpu_torch.models.multipatch import (MultiPatchBSplineBasis,
                                                   MultiPatchControlMesh)
    from tigar_tpu_torch.models.space import EqualOrderSpline
    from tigar_tpu_torch.models.extracted import ExtractedSpline
    from tigar_tpu_torch.models.shell import precompute_shell_reference
    basis = MultiPatchBSplineBasis([
        TensorBSplineBasis([2, 2], [uniform_knots(2, 0.0, 1.0, nx),
                                    uniform_knots(2, 0.0, 1.0, ny)])
        for ny in (nay, nby)])

    def bnet(patch, x_off):
        g = patch.greville_points()
        B = np.zeros((g.shape[0], 4))
        B[:, 0] = g[:, 0] + x_off
        B[:, 1] = 2.0 * g[:, 1] - 1.0 if bench else g[:, 1]
        B[:, 3] = 1.0
        return B

    offs = (-1.0, 0.0) if bench else (0.0, 1.0)
    cm = MultiPatchControlMesh(basis, [bnet(pt, o) for pt, o in
                                       zip(basis.patches, offs)])
    sp = EqualOrderSpline(3, cm)
    clamps = [(0, 0, 0)]
    if bench:
        clamps += [(1, 0, 1), (0, 1, 0), (0, 1, 1), (1, 1, 0), (1, 1, 1)]
    for patch, direction, side in clamps:
        dofs = basis.patch_side_dofs(patch, direction, side, n_layers=2)
        for i in range(3):
            sp.add_zero_dofs(i, dofs)
    return precompute_shell_reference(
        ExtractedSpline(sp, quad_degree=4, nders=2, device=device))


def nitsche_coupling(sp, nx, E, h):
    """bench._two_patch_point's consistent coupling on a level with nx
    elements across: EnergyNitscheCoupling on the SVK energy, beta_d =
    10 (D/h_el^3 + E h/h_el), beta_r = 10 D/h_el."""
    from tigar_tpu_torch.interface import EnergyNitscheCoupling
    from tigar_tpu_torch.models.shell import svk_shell_energy
    D, h_el = E * h ** 3 / 12.0 / (1 - NU ** 2), 1.0 / nx
    return EnergyNitscheCoupling(
        sp, 0, (0, 1), 1, (0, 0), svk_shell_energy,
        beta_d=10.0 * (D / h_el ** 3 + E * h / h_el), beta_r=10.0 * D / h_el,
        w_order=2, params={"E": E, "nu": NU, "h": h})


def build_two_patch(device, nel=TP_NEL, bench=True, coupling="penalty",
                    splines=None):
    """MultiPatchStencilNewton as bench._two_patch_point builds it
    (``bench``), or at tests/test_newton_mp.py's size and options, with
    the displacement + rotation penalty or the consistent Nitsche
    ``coupling``; ``splines`` reuses the levels of an earlier build:
    (solver, coupling, level sizes)."""
    from tigar_tpu_torch.coupling import ShellInterfaceCoupling
    from tigar_tpu_torch.models.shell import SVKShellAdjoint
    from tigar_tpu_torch.solvers.newton_stencil_mp import (
        MultiPatchStencilNewton)
    E, h, q = (E_MOD, H_TH, Q) if bench else (TP_REF["E"], TP_REF["h"],
                                              TP_REF["q"])
    if bench:
        sizes, (nx, ay, by) = [], (nel, 2 * nel, 2 * nel + 4)
        while nx >= 16:
            sizes.append((nx, ay, by))
            nx, ay, by = nx // 2, ay // 2, by // 2
    else:
        sizes = [(2 * nel, 2 * nel, 2 * nel + 4), (nel, nel, nel + 2),
                 (nel // 2, nel // 2, nel // 2 + 1)]
    if splines is None:
        splines = [two_patch_spline(nx, ay, by, device, bench)
                   for nx, ay, by in sizes]
    couplings = []
    for sp, (nx, ay, by) in zip(splines, sizes):
        if coupling == "nitsche":
            couplings.append(nitsche_coupling(sp, nx, E, h))
            continue
        h_el = 1.0 / (nx if bench else nel)
        couplings.append(ShellInterfaceCoupling(
            sp, 0, (0, 1), 1, (0, 0), penalty_disp=1e2 * E * h / h_el,
            penalty_rot=1e2 * E * h ** 3 / h_el))
    dens = SVKShellAdjoint(E, NU, h, load=(0.0, 0.0, -q))
    opts = (dict(cg_iters=15, polish_cg_iters=40, polish_tangent="f64",
                 build_quad_degree=2, rebuild_rel=0.1) if bench
            else dict(cg_iters=25, polish_cg_iters=40))
    ns = MultiPatchStencilNewton(splines[0], dens, couplings[0],
                                 mg_splines=splines[1:],
                                 mg_couplings=couplings[1:], **opts)
    return ns, couplings[0], sizes


def mp_smooth_state(ns, seed=0, amp=0.01):
    """Seeded coarsest-level coefficients prolonged to the fine level
    (per-patch knot insertion in f64), BC-masked."""
    g = torch.Generator().manual_seed(seed)
    U = amp * torch.randn(ns.mg_splines[-1].ndof, generator=g,
                          dtype=torch.float64).to(ns.mask64.device)
    for P in reversed(ns._Ps):
        U = P.up(U)
    return ns.mask64 * U


def iface_kernel_phases(ns, cpl, rec):
    """K1 over the concatenated patches, K2 on each patch's element range,
    K3's patch mode, K5, K6 and K7 against their plain versions at the
    two-patch path's full shapes and a seeded smooth state."""
    from tigar_tpu_torch.interface import (iform_residual_ref,
                                           iform_tangent_block_ref)
    from tigar_tpu_torch.ops.assembly import (residual_vector_adjoint_ref,
                                              shell_kernel_args)
    from tigar_tpu_torch.ops.stencil import (build_stencil,
                                             build_stencil_ref,
                                             stencil_apply, stencil_apply_ref)
    from tigar_tpu_torch.solvers.newton_stencil_mp import (
        iface_block_apply, iface_block_apply_ref)
    U64 = mp_smooth_state(ns)
    U32 = U64.float()
    dens = ns.adjoint
    idx, pos_a, pos_b = cpl.support_positions()
    il = idx.long()
    m, nq = idx.numel(), cpl.wq.numel()
    say(f"two-patch kernel state: max |U| {float(U64.abs().max()):.4f}; "
        f"interface: {nq} points, support m={m}")
    for name in ("iface_block", "shell_iface_residual",
                 "shell_iface_tangent"):
        rec.setdefault(name, [])

    # K1 over the concatenated two-patch assembler (work as in
    # kernel_phases)
    for tag, asm, U, tol in (("f64", ns.asm64, U64, TOL["f64"]),
                             ("f32", ns.asm32, U32, TOL["f32"])):
        args = shell_kernel_args(asm, dens, U)
        compare(f"K1 shell_residual {tag} two-patch nel={asm.nel} "
                f"nq={asm.nq}",
                lambda a=asm, u=U: a.residual_vector_adjoint(dens, u),
                lambda a=asm, u=U: residual_vector_adjoint_ref(a, dens, u),
                tol, 10, 2, rec["shell_residual"],
                work=(nbytes(U, U, *args), 756.0 * asm.nel * asm.nq,
                      U.dtype))

    # K2 on each patch's element range of the build assembler (global
    # connectivity, fold position within the patch), f32 and f64 as the
    # path's f32 builds and f64 polish tangents take it
    e0 = 0
    for p, pt in enumerate(ns.basis.patches):
        for tag, asm, U, tol in (("f32", ns.asm_b32, U32,
                                  TOL["f32_stencil"]),
                                 ("f64", ns.asm_b64, U64, TOL["f64"])):
            sub = asm.elements(e0, e0 + pt.nel)
            args = shell_kernel_args(sub, dens, U)
            S_bytes = 225 * pt.ncp * U.element_size()
            compare(f"K2 tangent_stencil {tag} two-patch patch {'AB'[p]} "
                    f"nel={pt.nel} nq={sub.nq}",
                    lambda a=sub, u=U, b=pt: build_stencil(a, dens, u, b,
                                                           3).S,
                    lambda a=sub, u=U, b=pt: build_stencil_ref(a, dens, u,
                                                               b, 3).S,
                    tol, 3, 1, rec["tangent_stencil"],
                    work=(nbytes(U, *args[:1], *args[2:]) + S_bytes,
                          K2_STENCIL_OPS * sub.nel * sub.nq, U.dtype))
        e0 += pt.nel

    for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
        c = cpl.astype(dt)
        U = U64.to(dt)
        es = U.element_size()
        tol = TOL["f64"] if dt == torch.float64 else TOL["f32"]
        tabs = [t for sd in (c.side_a, c.side_b)
                for t in (sd.R0, sd.R1, sd.qp.DF)]
        conns = [c.side_a.conn, c.side_b.conn]
        # K6 reads U at the support (m values, gathered through both
        # sides' conn), the side tables and wq, and writes all of r; it
        # moves about 1 MB (launch-bound); operations: the jets and the
        # contraction, 2 x 2 x 27 x 3 multiply-adds per point
        compare(f"K6 shell_iface_residual {tag} nq={nq}",
                lambda c=c, u=U: c.residual(u),
                lambda c=c, u=U: iform_residual_ref(c, u), tol, 50, 3,
                rec["shell_iface_residual"],
                match="shell_iface_residual_kernel",
                work=(m * es + U.numel() * es
                      + nbytes(c.wq, *conns, *tabs), 648.0 * nq, dt))
        # K7 reads the support's values, pos_a/pos_b, the side tables and
        # wq (not conn) and writes K [m, m] (zeroed first); operations:
        # 54 x 54 entries of 9 products with the rows per point
        us = U[il]
        compare(f"K7 shell_iface_tangent {tag} nq={nq} m={m}",
                lambda c=c, us=us: c.tangent_block_cuda(us, pos_a, pos_b,
                                                        c.params),
                lambda c=c, us=us: iform_tangent_block_ref(
                    c, us, pos_a, pos_b, c.params),
                tol, 20, 2, rec["shell_iface_tangent"],
                match="shell_iface_tangent_kernel",
                work=(nbytes(us, pos_a, pos_b, c.wq, *tabs) + m * m * es,
                      54.0 * 54 * 36 * nq, dt))

    # K5 on the fine operator's interface block in both types: the kernel
    # call alone is timed, accumulating into one buffer (the comparison
    # starts from a copy of ``base``); the library yardstick is torch.mv
    # on the same block (the product alone, on a pre-gathered vector)
    op32 = ns._build(ns.asm_b32, U64.float())
    op64 = ns._build(ns.asm_b64, U64)
    g = torch.Generator().manual_seed(3)
    for tag, op, dt in (("f64", op64, torch.float64),
                        ("f32", op32, torch.float32)):
        B = op.ifaces[0].K
        v = torch.randn(ns.spline.ndof, generator=g,
                        dtype=torch.float64).to(B.device, dt)
        base = torch.randn(ns.spline.ndof, generator=g,
                           dtype=torch.float64).to(B.device, dt)
        mk = ns.mask64.to(dt)
        buf_k, buf_t = torch.empty_like(base), torch.empty_like(base)
        acc = base.clone()
        tol = TOL["f64"] if dt == torch.float64 else 1e-6
        # reads B, idx, mask and v at the support, reads and writes out
        # there; 2 m^2 operations
        compare(f"K5 iface_block {tag} m={m}",
                lambda B=B, v=v, b=base, o=buf_k, mk=mk: iface_block_apply(
                    B, idx, v, o.copy_(b), mk, 1.0),
                lambda B=B, v=v, b=base, o=buf_t, mk=mk:
                iface_block_apply_ref(B, idx, v, o.copy_(b), mk, 1.0),
                tol, 200, 20, rec["iface_block"], match="tigar::iface_",
                work=(nbytes(B, idx) + 5 * m * B.element_size(),
                      2.0 * m * m, dt),
                timed=lambda B=B, v=v, o=acc, mk=mk: iface_block_apply(
                    B, idx, v, o, mk, 1.0))
        vs = v[il]
        lib = rec["iface_block"][-1]
        lib["library_ms"] = cuda_ms(lambda B=B, vs=vs: torch.mv(B, vs), 200)
        lib["library_probe"] = (lambda B=B, vs=vs: torch.mv(B, vs), 200)
        say(f"    library yardstick torch.mv(K, v[idx]) {tag}: "
            f"{lib['library_ms']:.4f} ms")

    # K3 reading and writing each patch in place, every mode, f32 (the
    # V-cycle) and f64 (the polish operator), at the operators' own
    # diagonals, on the fine level and (f32) on the coarse level the
    # V-cycle smooths (the last is its dense coarse solve)
    ops = [("", op32, ns.mask32, TOL["f32"]),
           ("", op64, ns.mask64, TOL["f64"])] + [
        (f" level {l}", op, mk, TOL["f32"]) for l, (op, mk) in enumerate(
            zip(ns._coarse_sts[:-1], ns._coarse_masks[:-1]), 1)]
    for lname, op, mk, tol in ops:
        tag = "f64" if mk.dtype == torch.float64 else "f32"
        x, b = (torch.randn(op.ndof, generator=g, dtype=torch.float64)
                .to(mk.device, mk.dtype) for _ in range(2))
        dinv = 1.0 / (mk * op.diagonal() + (1.0 - mk))
        for p, st in enumerate(op.sts):
            for mode in ("apply", "residual", "jacobi"):
                kw = dict(mask=mk, b=b, dinv=dinv, omega=0.7, mode=mode,
                          base=op.doffsets[p], fstride=op.doffsets[-1])
                oa, ob = torch.zeros_like(x), torch.zeros_like(x)
                compare(f"K3 stencil_apply {mode} {tag}{lname} patch "
                        f"{'AB'[p]} grid={st.grid_shape}",
                        lambda s=st, kw=kw, o=oa, x=x: stencil_apply(
                            s, x, out=o, **kw),
                        lambda s=st, kw=kw, o=ob, x=x: stencil_apply_ref(
                            s, x, out=o, **kw),
                        tol, 10, 3, rec["stencil_apply"],
                        work=stencil_work(st, mode))
                if mode == "apply":
                    stencil_library(st, mk, x, rec["stencil_apply"][-1],
                                    (op.doffsets[p], op.doffsets[-1]))


def two_patch_main_path(ns, cpl, sizes, setup_s):
    """The best of 3 warm f32 steps, then the full solve with every launch
    count reset just before it and read just after: its diagnostics,
    launch counts and times (step ms, solve s, steps)."""
    from tigar_tpu_torch.ops import cuda_ext
    ndof = ns.spline.ndof
    U0 = torch.zeros(ndof, dtype=torch.float64, device=ns.mask64.device)
    U1, rn, _ = ns.step(U0)                    # warm-up
    float(rn)
    best = best_of_3(lambda: ns.step(U1))
    say(f"two-patch production (f32) newton step: best of 3 "
        f"{best * 1e3:.3f} ms ({ndof / best:.4e} DoF/s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    Usol, rel64, nsteps, dU_rel = ns.solve(rtol=1e-10, log=say,
                                           start_polish=True)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = cuda_ext.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"two-patch full solve (start_polish, as the bench's penalty "
        f"point): {t_solve:.3f} s, {nsteps} steps, f64 rel "
        f"|r| = {rel64:.3e}, |dU|/|U| = {dU_rel:.3e}; interface jump_norm "
        f"{float(cpl.jump_norm(Usol)):.4e}, rotation_jump_norm "
        f"{float(cpl.rotation_jump_norm(Usol)):.4e}; peak device memory "
        f"{peak_gb:.3f} GiB (setup {setup_s:.2f} s, ndof={ndof}, levels "
        f"{sizes})")
    say(f"two-patch main-path kernel launches: {launches}")
    levels = k3_levels("two-patch main path")
    tally("two_patch", ("tangent_stencil",))
    if tuple(Usol.shape) != (ndof,) or not bool(torch.isfinite(Usol).all()):
        raise SystemExit("two-patch solution is not finite or has the wrong "
                         "shape")
    need = ("shell_residual", "tangent_stencil", "stencil_apply",
            "iface_block", "shell_iface_residual", "shell_iface_tangent")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise SystemExit(f"two-patch main path never launched {missing}")
    times = dict(step_ms=best * 1e3, solve_s=t_solve, steps=nsteps,
                 k3_by_grid=levels)
    return Usol, rel64, dU_rel, launches, times


def two_patch_certificate(ns, cpl, Usol, rel64, dU_rel,
                          floor_rel=TP_FLOOR_REL, label="two-patch"):
    """The final f64 residual within 3x of the CPU plain versions (K1's
    and the interface residual's, the form carried to the CPU with its
    own density) on the same state, and rel64 <= floor_rel with
    |dU|/|U| <= 1e-10, or rel64 <= 1e-10."""
    from tigar_tpu_torch import convert
    from tigar_tpu_torch.ops.assembly import residual_vector_adjoint_ref
    r0_64 = ns.true_rel_residual(torch.zeros_like(Usol))
    Uc = Usol.cpu()
    cpl_cpu = convert.interface_from_numpy(
        convert.interface_arrays(cpl), type(cpl), cpl.density,
        ns.spline.ndof, device="cpu")
    r_cpu = ns.mask64.cpu() * (residual_vector_adjoint_ref(
        ns.asm64.to("cpu"), ns.adjoint, Uc) + cpl_cpu.residual(Uc))
    cpu_rel = float(torch.linalg.norm(r_cpu)) / r0_64
    agree = max(rel64, cpu_rel) <= 3.0 * max(min(rel64, cpu_rel), 1e-300)
    ok = agree and ((rel64 <= floor_rel and dU_rel <= 1e-10)
                    or rel64 <= 1e-10)
    say(f"{label} floor certificate: rel64 {rel64:.3e}, CPU plain f64 "
        f"rel {cpu_rel:.3e} (within 3x: {agree}), |dU|/|U| {dU_rel:.3e}, "
        f"floor_rel {floor_rel:g}: certified={ok}")
    if not ok:
        raise SystemExit(f"{label} floor certificate FAILED")


def two_patch_reference(device, coupling="penalty"):
    """tests/test_newton_mp.py's size and options (its penalty plate, or
    its Nitsche plate of :132), solved on the card and through the plain
    versions on the CPU."""
    (ns_g, _, _), (ns_c, _, _) = (build_two_patch(d, TP_REF["nel"],
                                                  bench=False,
                                                  coupling=coupling)
                                  for d in (device, "cpu"))
    Ug, relg, itg, _ = ns_g.solve(rtol=1e-10, max_iters=25)
    Uc, relc, itc, _ = ns_c.solve(rtol=1e-10, max_iters=25)
    err = float(torch.linalg.norm(Ug.cpu() - Uc) / torch.linalg.norm(Uc))
    say(f"two-patch {coupling} small-input reference ({ns_g.spline.ndof} "
        f"DoFs): card {itg} steps rel {relg:.3e}, CPU plain {itc} steps "
        f"rel {relc:.3e}, |U_card - U_cpu| / |U_cpu| {err:.3e}")
    if not (err <= 1e-7 and abs(itg - itc) <= 1):
        raise SystemExit(f"two-patch {coupling} small-input reference "
                         "FAILED")


def nitsche_kernel_phases(ns, rec):
    """K8 and K9 against their plain versions, f64 and f32, at seeded
    states, on the fine interface (768 points, timed) and on the
    (32,64,66) and (16,32,33) levels' (384 and 192 points).  The bound
    counts the operations the function needs (``nitsche_ops``), not the
    kernels' own passes."""
    from tigar_tpu_torch.interface import (iform_residual_ref,
                                           iform_tangent_block_ref)
    from tigar_tpu_torch.ops import cuda_ext
    ops = nitsche_ops()
    need8 = 2 * (ops["geom"] + ops["jets"] + ops["grad"])
    need9 = 2 * (ops["geom"] + ops["jets"] + ops["hess"])
    own8 = 2 * ops["geom"] + 54 * ops["pass1"]
    own9 = own8 + 756 * ops["pass2"]
    say(f"Nitsche operations a point: K8 needs {need8}, runs {own8} "
        f"({own8 / need8:.1f}x); K9 needs {need9}, runs {own9} "
        f"({own9 / need9:.1f}x)")
    levels = [("fine", ns.couplings[0], mp_smooth_state(ns))]
    for i, (sp, cl) in enumerate(zip(ns.mg_splines, ns.mg_couplings)):
        g = torch.Generator().manual_seed(5 + i)
        U = 0.01 * torch.randn(sp.ndof, generator=g, dtype=torch.float64)
        levels.append((f"level {i + 1}", cl[0],
                       sp.mask * U.to(ns.mask64.device)))
    for name in ("nitsche_iface_residual", "nitsche_iface_tangent"):
        rec.setdefault(name, [])
    for level, cpl, U64 in levels:
        idx, pos_a, pos_b = cpl.support_positions()
        m, nq = idx.numel(), cpl.wq.numel()
        say(f"Nitsche {level} interface: {nq} points, support m={m}")
        for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
            c = cpl.astype(dt)
            U = U64.to(dt)
            es = U.element_size()
            tol = TOL[tag]
            tabs = [t for sd in (c.side_a, c.side_b)
                    for t in (sd.R0, sd.R1, sd.R2, sd.R3, sd.qp.DF,
                              sd.qp.d2F, sd.qp.d3F, sd.qp.pinv,
                              sd.qp.nu_flat)]
            conns = [c.side_a.conn, c.side_b.conn]
            timed = level == "fine"
            # K8 reads U at the support (m values), the side tables, wq
            # and surfJ, and writes all of r
            compare(f"K8 nitsche_iface_residual {tag} nq={nq}",
                    lambda c=c, u=U: c.residual(u),
                    lambda c=c, u=U: iform_residual_ref(c, u), tol,
                    20 if timed else 3, 1 if timed else 0,
                    rec["nitsche_iface_residual"],
                    match="nitsche_residual_kernel" if timed else None,
                    work=(m * es + U.numel() * es
                          + nbytes(c.wq, c.surfJ, *conns, *tabs),
                          float(nq * need8), dt))
            # K9 reads the support's values, pos_a/pos_b, the side tables
            # (not conn), wq and surfJ, and writes K [m, m] (zeroed first)
            us = U[idx.long()]
            # the level's own positions bound now: the timed probe runs
            # again after this loop has moved on to the coarser levels
            k9 = (lambda c=c, us=us, pa=pos_a, pb=pos_b:
                  c.tangent_block_cuda(us, pa, pb, c.params))
            if timed and tag == "f64":
                # the local memory the context reserves for K9 f64's stack
                lim0 = cuda_ext.load().stack_limit()
                free0, total = torch.cuda.mem_get_info()
                out0 = total - free0 - torch.cuda.memory_reserved()
                k9()
                torch.cuda.synchronize()
                free1, _ = torch.cuda.mem_get_info()
                out1 = total - free1 - torch.cuda.memory_reserved()
                say(f"K9 f64 first launch: stack limit {lim0} -> "
                    f"{cuda_ext.load().stack_limit()} bytes a thread; "
                    f"device memory outside torch's allocator "
                    f"{out0 / 2 ** 30:.3f} -> {out1 / 2 ** 30:.3f} GiB")
            compare(f"K9 nitsche_iface_tangent {tag} nq={nq} m={m}", k9,
                    lambda c=c, us=us, pa=pos_a, pb=pos_b:
                    iform_tangent_block_ref(c, us, pa, pb, c.params),
                    tol, 10 if timed else 2, 1 if timed else 0,
                    rec["nitsche_iface_tangent"],
                    match="nitsche_tangent_kernel" if timed else None,
                    work=(nbytes(us, pos_a, pos_b, c.wq, c.surfJ, *tabs)
                          + m * m * es, float(nq * need9), dt))


def two_patch_nitsche_main_path(ns, cpl, sizes, setup_s):
    """The best of 3 warm f32 steps, then the full solve with the f32
    phase first (as bench.py's Nitsche point), every launch count reset
    just before it and read just after; returns as
    ``two_patch_main_path``."""
    from tigar_tpu_torch.ops import cuda_ext
    ndof = ns.spline.ndof
    U0 = torch.zeros(ndof, dtype=torch.float64, device=ns.mask64.device)
    U1, rn, _ = ns.step(U0)                    # warm-up
    float(rn)
    best = best_of_3(lambda: ns.step(U1))
    say(f"two-patch Nitsche production (f32) newton step: best of 3 "
        f"{best * 1e3:.3f} ms ({ndof / best:.4e} DoF/s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    Usol, rel64, nsteps, dU_rel = ns.solve(rtol=1e-10, log=say)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = cuda_ext.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    free, total = torch.cuda.mem_get_info()
    outside = (total - free - torch.cuda.memory_reserved()) / 2 ** 30
    say(f"two-patch Nitsche full solve (f32 phase first, as the bench): "
        f"{t_solve:.3f} s, {nsteps} steps, f64 rel |r| = {rel64:.3e}, "
        f"|dU|/|U| = {dU_rel:.3e}; interface jump_norm "
        f"{float(cpl.jump_norm(Usol)):.4e}, grad_jump_norm "
        f"{float(cpl.grad_jump_norm(Usol)):.4e}; peak device memory "
        f"{peak_gb:.3f} GiB in torch's allocator, {outside:.3f} GiB outside "
        f"it (context and the kernels' stack reservation, stack limit "
        f"{cuda_ext.load().stack_limit()} bytes a thread) "
        f"(setup {setup_s:.2f} s, ndof={ndof}, levels "
        f"{sizes}, beta_d={cpl.params['beta_d']:g}, "
        f"beta_r={cpl.params['beta_r']:g})")
    say(f"two-patch Nitsche main-path kernel launches: {launches}")
    levels = k3_levels("two-patch Nitsche main path")
    tally("two_patch_nitsche", ("tangent_stencil",))
    if tuple(Usol.shape) != (ndof,) or not bool(torch.isfinite(Usol).all()):
        raise SystemExit("two-patch Nitsche solution is not finite or has "
                         "the wrong shape")
    need = ("shell_residual", "tangent_stencil", "stencil_apply",
            "iface_block", "nitsche_iface_residual", "nitsche_iface_tangent")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise SystemExit(f"two-patch Nitsche main path never launched "
                         f"{missing}")
    times = dict(step_ms=best * 1e3, solve_s=t_solve, steps=nsteps,
                 k3_by_grid=levels)
    return Usol, rel64, dU_rel, launches, times


# -- the SANewton path: element tangents and smoothed aggregation ------------

# bench._tspline_point's SANewton options (bench.py:418-425), with the
# headline shell's build_quad_degree=2 and f64 residuals on the card
SA_OPTS = dict(cg_iters=120, polish_cg_iters=160, polish_tangent="f64",
               build_quad_degree=2, rebuild_rel=0.1,
               sa_kwargs={"near_kernel": "linear"})
SA_REF = dict(cg_iters=60, polish_cg_iters=80,
              sa_kwargs={"coarse_size": 100})     # tests/test_newton_sa.py


def sa_solver(spline, density, opts=SA_OPTS):
    from tigar_tpu_torch.solvers.newton_sa import SANewton
    return SANewton(spline, density, **opts)


def csr_of(rows, cols, vals, shape):
    """The same matrix as one torch.sparse CSR tensor (duplicates summed):
    the library yardstick of K10 / K11."""
    A = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                vals, shape).coalesce()
    return A.to_sparse_csr()


def elem_csr(st, m):
    """K10's BC'd operator, the masked element matrices of the ElemTangent
    ``st`` plus the unit diagonal at the constrained DoFs (mask ``m``), as
    one torch.sparse CSR matrix: K10's library yardstick."""
    n = m.numel()
    nloc = st.conn.shape[1]
    ar = torch.arange(n, device=m.device, dtype=torch.int32)
    rows = torch.cat([st.conn[:, :, None].expand(-1, -1, nloc).reshape(-1),
                      ar])
    cols = torch.cat([st.conn[:, None, :].expand(-1, nloc, -1).reshape(-1),
                      ar])
    return csr_of(rows, cols, torch.cat([st.E.reshape(-1), 1.0 - m]),
                  (n, n))


def elem_work(st, masked=True):
    """K10's work for ``bound``: it reads E's upper triangle (E is
    symmetric), conn, x (and the mask) and writes y; 2 nloc^2 operations
    an element."""
    nel, nloc = st.conn.shape
    es = st.E.element_size()
    n = st.ndof
    return (nel * nloc * (nloc + 1) // 2 * es + nbytes(st.conn)
            + (3 if masked else 2) * n * es, 2.0 * nel * nloc * nloc,
            st.E.dtype)


SA_KEYS = ("tangent_elements", "elem_tangent_apply", "ell_spmv")
# K11's modes on each op of an SA level: the square ones on A
ELL_OP_MODES = {"A": ("apply", "residual", "jacobi", "jacobi0", "add"),
                "P": ("apply", "residual", "add"),
                "Pt": ("apply", "residual", "add")}
ELL_VECTORS = {"apply": (1, 1), "residual": (1, 2), "jacobi": (0, 4),
               "jacobi0": (0, 3), "add": (1, 2)}


# K11's modes that one PyTorch call computes, on the CSR matrix A
ELL_LIBRARY = {
    "apply": lambda A, x, b: A @ x,
    "residual": lambda A, x, b: torch.addmv(b, A, x, alpha=-1.0),
    "add": lambda A, x, b: torch.addmv(b, A, x)}


def ell_work(op, mode, layout=False):
    """K11's work for ``bound`` on the EllOperator ``op``: its nonzeros
    (with ``layout``, every slot of its sliced layout and the tile table)
    read once as (column, value) pairs, the gathered vector read once and
    the mode's row vectors read and y written (``ELL_VECTORS``: vectors of
    ncols and of n entries; "jacobi" and "jacobi0" gather a row vector);
    2 operations a nonzero."""
    sl = op.card
    es = sl.vals.element_size()
    nnz, slots = sl.fill()
    pairs = (slots * (4 + es) + nbytes(sl.tiles, sl.starts) if layout
             else nnz * (4 + es))
    per_col, per_row = ELL_VECTORS[mode]
    return (pairs + (per_col * op.ncols + per_row * op.n) * es,
            2.0 * nnz, sl.vals.dtype)


def ell_phases(ops, om_dinv, label, g, record, probe=False):
    """K11 on one SA level's (A, P, Pt) ``EllOperator``s in every mode their
    shapes take (``ELL_OP_MODES``), f32 as the cycle runs, against the
    carried arrays' plain version, with the nonzero and layout bounds, the
    fill (nonzeros / layout slots) and, in each mode that one PyTorch call
    computes, that call on the same matrix as a torch.sparse CSR tensor
    (``ELL_LIBRARY``: ``@`` for apply, ``torch.addmv`` for residual and
    add; the Jacobi modes have none)."""
    from tigar_tpu_torch.ops import sparse
    for name, op in zip(("A", "P", "Pt"), ops):
        A = None
        nnz, slots = op.card.fill()
        K = int(op.card.width.max())
        for mode in ELL_OP_MODES[name]:
            x, b = (torch.randn(k, generator=g, dtype=torch.float64)
                    .to(op.vals.device, op.vals.dtype)
                    for k in (op.ncols, op.n))
            a = (None if mode == "jacobi0" else x, b,
                 om_dinv if mode in ("jacobi", "jacobi0") else None, mode)
            compare(f"K11 ell_spmv {name} {mode} f32 {label} n={op.n} "
                    f"K={K} fill={nnz / max(slots, 1):.3f}",
                    lambda a=a, op=op: op(*a),
                    lambda a=a, op=op: sparse.ell_spmv_ref(op.cols, op.vals,
                                                           *a),
                    TOL["f32"], 50, 5, record, match="ell_sliced_kernel",
                    work=ell_work(op, mode))
            e = record[-1]
            e.update(n=op.n, K=K, nnz=nnz, slots=slots, op=name, mode=mode,
                     level=label)
            e["bound_layout_ms"] = bound(*ell_work(op, mode, True))[0]
            if probe:
                probe_device_time(e)
            lib = ELL_LIBRARY.get(mode)
            if lib is not None:
                if A is None:
                    rr = torch.arange(op.n, device=x.device)
                    rr = rr[:, None].expand_as(op.cols).reshape(-1)
                    A = csr_of(rr, op.cols.reshape(-1), op.vals.reshape(-1),
                               (op.n, op.ncols))
                e["library_ms"] = cuda_ms(
                    lambda A=A, x=x, b=b, lib=lib: lib(A, x, b), 50)


def residual_work(asm, dens, U):
    """K1's work for ``bound``: it reads U, the per-point data and the
    padding mask once and writes r; operations: at least the jet
    contractions, 2 x 2 x 7 nloc per point (7 jet slots of each of the nloc
    local functions, gathered and contracted back)."""
    from tigar_tpu_torch.ops.assembly import (shell_kernel_args,
                                              shell_padding_mask)
    args = shell_kernel_args(asm, dens, U)
    m = shell_padding_mask(asm)
    return (nbytes(U, U, *args, *([] if m is None else [m])),
            28.0 * asm.nloc * asm.nel * asm.nq, U.dtype)


def elements_work(asm, dens, U, me):
    """K2's element mode's work for ``bound``: it reads what K2 reads (not
    N), me and the padding mask, and writes E; operations: at least the
    element matrix of the 18x18 pointwise Jacobian with each local
    function in 6 jet slots, E's symmetric half only,
    2 (18 nloc 6 + nloc (nloc + 1) / 2 6) per point."""
    from tigar_tpu_torch.ops.assembly import (shell_kernel_args,
                                              shell_padding_mask)
    args = shell_kernel_args(asm, dens, U)
    m = shell_padding_mask(asm)
    return (nbytes(U, *args[:1], *args[2:], me, *([] if m is None else [m]))
            + asm.nel * asm.nloc ** 2 * U.element_size(),
            12.0 * (18 * asm.nloc + asm.nloc * (asm.nloc + 1) / 2)
            * asm.nel * asm.nq,
            U.dtype)


def sa_kernel_phases(ns, U64, rec, keys=SA_KEYS, label="", probe=False):
    """K2's element mode (f32 at the build rule, f64 for the polish
    tangent), K10 (apply, BC'd apply, diagonal; f32 and f64) and K11 (A,
    P and P^T of every SA level in every mode each takes, ``ell_phases``;
    f32, as the cycle runs) against their plain versions at the SANewton
    path's shapes, at a seeded smooth state.  K10's and K11's library
    yardstick is the same matrix as a torch.sparse CSR tensor applied with
    ``@``.  The records go to ``rec[k]`` for the three names of ``keys``;
    ``probe`` takes each profiler device time right away (else later, in
    ``kernel_device_times``).  Returns the host seconds of one SA hierarchy
    setup."""
    from tigar_tpu_torch.ops import sparse
    from tigar_tpu_torch.ops.assembly import element_matrices_adjoint_ref
    k_te, k_et, k_ell = keys
    for name in keys:
        rec.setdefault(name, [])
    label = f" {label}" if label else ""

    def done(key):
        if probe:
            probe_device_time(rec[key][-1])
    dens = ns.adjoint
    me64 = ns._me64
    sts = {}
    # K2's f32 tolerance (TOL["f32_stencil"]): the entries sum products of
    # the f32 jet-Jacobians, formed by dual numbers in the kernel and by
    # jacfwd in the plain version; both are held to the f64 plain matrices
    # below, to show the difference is f32 rounding
    E64 = element_matrices_adjoint_ref(ns.asm_b64, dens, U64, me64)
    for tag, asm, U, tol in (
            ("f64", ns.asm_b64, U64, TOL["f64"]),
            ("f32", ns.asm_b32, U64.float(), TOL["f32_stencil"])):
        me = me64.to(U.dtype)
        compare(f"K2 tangent_elements {tag} nq={asm.nq}{label}",
                lambda a=asm, u=U, me=me: a.element_matrices_adjoint(
                    dens, u, me=me),
                lambda a=asm, u=U, me=me: element_matrices_adjoint_ref(
                    a, dens, u, me), tol, 5, 1, rec[k_te],
                match="tangent_stencil_kernel",
                work=elements_work(asm, dens, U, me))
        done(k_te)
        kern = (lambda a=asm, u=U, me=me: a.element_matrices_adjoint(
            dens, u, me=me))
        plain = (lambda a=asm, u=U, me=me: element_matrices_adjoint_ref(
            a, dens, u, me))
        if tag == "f32":
            scale = float(E64.abs().max())
            say(f"    f32 rounding: max |E - E_f64 plain| / max |E_f64|: "
                f"kernel {float((kern() - E64).abs().max()) / scale:.3e}, "
                f"plain {float((plain() - E64).abs().max()) / scale:.3e}")
        sts[tag] = ns._build(asm, U)
        # K10 reads E's upper triangle: how far from symmetric E is
        E = sts[tag].E
        asym = float((E - E.transpose(1, 2)).abs().max() / E.abs().max())
        say(f"    E {tag}{label}: max |E - E^T| / max |E| {asym:.3e}")

    n = ns.spline.ndof
    g = torch.Generator().manual_seed(11)
    for tag in ("f32", "f64"):
        st = sts[tag]
        dt = st.E.dtype
        x = torch.randn(n, generator=g, dtype=torch.float64).to(U64.device,
                                                                   dt)
        m = ns.mask64.to(dt)
        es = st.E.element_size()
        nel, nloc = st.conn.shape
        for what in ("apply", "masked", "diagonal"):
            if what == "diagonal":
                kern = (lambda st=st: sparse.elem_tangent_diagonal(
                    st.conn, st.E, n))
                plain = (lambda st=st: sparse.elem_tangent_diagonal_ref(
                    st.conn, st.E, n))
                # reads the diagonals of E and conn, writes d
                work = (nel * nloc * (es + 4) + n * es, float(nel * nloc),
                        dt)
            else:
                mk = m if what == "masked" else None
                kern = (lambda st=st, x=x, mk=mk: sparse.elem_tangent_apply(
                    st.conn, st.E, x, mk))
                plain = (lambda st=st, x=x, mk=mk:
                         sparse.elem_tangent_apply_ref(st.conn, st.E, x, mk))
                work = elem_work(st, mk is not None)
            compare(f"K10 elem_tangent {what} {tag} nel={nel} nloc={nloc}"
                    f"{label}", kern, plain, TOL[tag], 50, 5, rec[k_et],
                    match="elem_", work=work,
                    per_call=1 if what == "diagonal" else 2)
            done(k_et)
            if what == "masked":
                A = elem_csr(st, m)
                yk = kern()
                lib_err = float((A @ x - yk).abs().max() / yk.abs().max())
                rec[k_et][-1]["library_ms"] = cuda_ms(
                    lambda A=A, x=x: A @ x, 50)
                say(f"    library yardstick torch.sparse CSR @ x ({A._nnz()} "
                    f"entries) {tag}: "
                    f"{rec[k_et][-1]['library_ms']:.4f} ms, "
                    f"rel diff {lib_err:.1e}")

    # the SA hierarchy of the f32 tangent (host setup timed on its own)
    ns.reset()
    t0 = time.perf_counter()
    sa = ns._ensure_sa(sts["f32"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    say(f"SA hierarchy: levels {sa.level_sizes}, host setup "
        f"{setup_s:.3f} s (scipy aggregation, QR, Galerkin products)")
    for l, ops in enumerate(sa._ops):
        lv = sa._levels[l]
        if ops[0] is None:      # level 0 runs the fine operator (K10)
            ops = (sparse.EllOperator(lv.A_cols, lv.A_vals,
                                      lv.om_dinv.shape[0], key="A0"),
                   ) + ops[1:]
        ell_phases(ops, lv.om_dinv, f"level {l}{label}", g, rec[k_ell],
                   probe)
    return setup_s


def sa_main_path(ns, U_stencil, setup_s):
    """The best of 3 warm f32 SANewton steps, then the full solve with
    every launch count reset just before it and read just after; its U
    against the StencilNewton solution of the same problem.  Returns U,
    the launch counts and the times."""
    from tigar_tpu_torch.ops import cuda_ext
    ndof = ns.spline.ndof
    U0 = torch.zeros(ndof, dtype=torch.float64, device=ns.mask64.device)
    ns.reset()
    U1, rn, _ = ns.step(U0)                    # warm-up (builds the SA)
    float(rn)
    best = best_of_3(lambda: ns.step(U1))
    say(f"SANewton production (f32) newton step (frozen hierarchy "
        f"{ns._sa.level_sizes}): best of 3 {best * 1e3:.3f} ms "
        f"({ndof / best:.4e} DoF/s); one host SA setup {setup_s:.3f} s")
    ns.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    Usol, rel64, nsteps, dU_rel = ns.solve(rtol=1e-10, log=say)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = cuda_ext.counts()
    say(f"SANewton solve: {len(ns.sa_setup_s)} host SA setups, "
        f"{sum(ns.sa_setup_s):.3f} s ({sum(ns.sa_setup_s) / t_solve:.4f} of "
        f"the solve)")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    err = float((Usol - U_stencil).abs().max() / U_stencil.abs().max())
    say(f"SANewton full solve: {t_solve:.3f} s, {nsteps} steps, f64 rel "
        f"|r| = {rel64:.3e}, |dU|/|U| = {dU_rel:.3e}; peak device memory "
        f"{peak_gb:.3f} GiB; max |U_SA - U_stencil| / max |U_stencil| "
        f"{err:.3e} (bound 1e-7)")
    say(f"SANewton main-path kernel launches: {launches}; K11 by (op, "
        f"mode): {cuda_ext.counts_by('ell_spmv')}")
    tally("sa_newton", ("tangent_elements",))
    if tuple(Usol.shape) != (ndof,) or not bool(torch.isfinite(Usol).all()):
        raise SystemExit("SANewton solution is not finite or has the wrong "
                         "shape")
    need = ("shell_residual", "tangent_elements", "elem_tangent_apply",
            "ell_spmv")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise SystemExit(f"SANewton main path never launched {missing}")
    shell_certificate(ns, Usol, rel64, dU_rel, "SANewton")
    if not err <= 1e-7:
        raise SystemExit("SANewton solution differs from StencilNewton's "
                         f"by {err:.3e} > 1e-7")
    return Usol, launches, dict(step_ms=best * 1e3, solve_s=t_solve,
                                steps=nsteps,
                                sa_setup_s=sum(ns.sa_setup_s))


def sa_reference(device):
    """tests/test_newton_sa.py's 8x8 plate and options (q=100 here),
    solved on the card and through the plain versions on the CPU."""
    from tigar_tpu_torch.models.shell import SVKShellAdjoint
    dens = SVKShellAdjoint(E_MOD, NU, H_TH, load=(0.0, 0.0, -Q))
    ns_g, ns_c = (sa_solver(build_spline(8, d), dens, SA_REF)
                  for d in (device, "cpu"))
    Ug, relg, itg, _ = ns_g.solve(rtol=1e-9)
    Uc, relc, itc, _ = ns_c.solve(rtol=1e-9)
    err = float((Ug.cpu() - Uc).abs().max() / Uc.abs().max())
    say(f"SANewton small-input reference (nel=8, levels "
        f"{ns_g._sa.level_sizes}): card {itg} steps rel {relg:.3e}, CPU "
        f"plain {itc} steps rel {relc:.3e}, max rel diff of U {err:.3e}")
    if not (err <= 1e-8 and relg <= 1e-9 and abs(itg - itc) <= 1):
        raise SystemExit("SANewton small-input reference FAILED")


# -- phase 14: the star-T-spline shell through SANewton ---------------------

# bench._tspline_point at its default size (BENCH_TS_NEL=48): the demo's
# problem and options (tigar_tpu_torch/demos/star_tspline_shell.py)
TS_NEL = 48
TS_KEYS = ("tangent_elements_bicubic", "elem_tangent_apply_nloc48",
           "ell_spmv_star")
TS_REF = {"coarse_size": 50}          # the nel=4 reference, as the CPU test


def ts_kernel_phases(ns, ragged, rec):
    """Phase 14, step 1 (with the other kernel checks, before the main
    paths' profiler sessions): at the star's shapes (6,912 elements, 48
    local functions), K2's element mode (f64, f32) at the build rule's 9
    points, K10 at nloc 48 and K11 on the star's SA levels
    (``sa_kernel_phases``), then K1 (f64, f32; 16 points) and K2's element
    mode at the residual rule's 16 points, and both on the ragged
    extraction (padding mask not all ones) at 9 and 16 points, each
    against its plain version with an immediate profiler device time.
    The state is 1e-3 N(0, 1) on the free DoFs (numpy seed 0).  Returns
    the host seconds of one SA hierarchy setup."""
    from tigar_tpu_torch.ops.assembly import (element_matrices_adjoint_ref,
                                              residual_vector_adjoint_ref)
    rec.setdefault("shell_residual_bicubic", [])
    dens = ns.adjoint
    rng = np.random.default_rng(0)
    U_star = ns.mask64 * torch.as_tensor(
        rng.normal(size=ns.spline.ndof) * 1e-3, device=ns.mask64.device)
    setup_s = sa_kernel_phases(ns, U_star, rec, keys=TS_KEYS, label="star",
                               probe=True)
    for label, sp, U64 in (
            ("star", ns.spline, U_star),
            ("ragged", ragged, ragged.mask * torch.as_tensor(
                rng.normal(size=ragged.ndof) * 1e-3,
                device=ragged.mask.device))):
        a64 = sp._assembler("dx")
        for tag, dt, tol in (("f64", torch.float64, TOL["f64"]),
                             ("f32", torch.float32, TOL["f32"])):
            asm, U = a64.astype(dt), U64.to(dt)
            compare(f"K1 shell_residual {tag} nq={asm.nq} nen=16 {label}",
                    lambda a=asm, u=U: a.residual_vector_adjoint(dens, u),
                    lambda a=asm, u=U: residual_vector_adjoint_ref(a, dens,
                                                                   u),
                    tol, 20, 3, rec["shell_residual_bicubic"],
                    match="shell_residual_kernel",
                    work=residual_work(asm, dens, U))
            probe_device_time(rec["shell_residual_bicubic"][-1])
        pad = a64.masks[0].repeat(1, 3)
        me64 = sp.mask[a64.cat_conn] * pad
        # the build rule's 9 points at the star ran in sa_kernel_phases
        rules = (16,) if label == "star" else (9, 16)
        for nq in rules:
            ab = sp._assembler("dx", quad_degree=4 if nq == 9 else None)
            for tag, dt, tol in (("f64", torch.float64, TOL["f64"]),
                                 ("f32", torch.float32,
                                  TOL["f32_stencil"])):
                asm, U, me = ab.astype(dt), U64.to(dt), me64.to(dt)
                compare(f"K2 tangent_elements {tag} nq={asm.nq} nen=16 "
                        f"{label}",
                        lambda a=asm, u=U, me=me: a.element_matrices_adjoint(
                            dens, u, me=me),
                        lambda a=asm, u=U, me=me:
                        element_matrices_adjoint_ref(a, dens, u, me),
                        tol, 5, 1, rec["tangent_elements_bicubic"],
                        match="tangent_stencil_kernel",
                        work=elements_work(asm, dens, U, me))
                probe_device_time(rec["tangent_elements_bicubic"][-1])
                if label == "ragged":
                    E = asm.element_matrices_adjoint(dens, U, me=me)
                    if float(E[pad == 0].abs().max()) != 0.0:
                        raise SystemExit("K2 element mode: a padded row of "
                                         "the ragged extraction is not zero")
    return setup_s


def ts_main_path(ns, setup_sa_s):
    """Phase 14, step 2: the demo's entry point
    (tigar_tpu_torch.demos.star_tspline_shell.run) on the card at
    nel=48, every launch count reset just before the solve and read just
    after (inside ``run``); fails unless the solve launched K1, K2's
    element mode, K10 and K11, its solution is finite and the f64 floor is
    certified as bench._solve_and_certify certifies it.  Returns the
    run's record, the launch counts and the solution."""
    from tigar_tpu_torch.demos import star_tspline_shell as demo
    out = demo.run(TS_NEL, log=say, ns=ns)
    U, launches = out.pop("U"), out["launches"]
    say(f"star T-spline main path ({out['ndof']} DoFs, {out['nel']} "
        f"elements, SA levels {out['levels']}; one host SA setup "
        f"{setup_sa_s:.3f} s): best of 2 warm f32 steps "
        f"{out['step32_s'] * 1e3:.3f} ms, polish step "
        f"{out['polish_step_s'] * 1e3:.3f} ms; solve {out['solve_s']:.3f} s, "
        f"{out['steps']} steps, rel64 {out['rel64']:.3e}, |dU|/|U| "
        f"{out['dU_rel']:.3e}, CPU plain rel {out['cpu_rel']:.3e}: "
        f"floor_certified={out['floor_certified']}, "
        f"f64_accurate={out['f64_accurate']}; {len(out['sa_setup_s'])} "
        f"host SA setups in the solve, {sum(out['sa_setup_s']):.3f} s "
        f"({sum(out['sa_setup_s']) / out['solve_s']:.4f} of it)")
    from tigar_tpu_torch.ops import cuda_ext
    say(f"star T-spline main-path kernel launches: {launches}; K11 by "
        f"(op, mode): {cuda_ext.counts_by('ell_spmv')}")
    tally("star_tspline", ("tangent_elements",))
    if tuple(U.shape) != (out["ndof"],) or not bool(torch.isfinite(U).all()):
        raise SystemExit("star T-spline solution is not finite or has the "
                         "wrong shape")
    need = ("shell_residual", "tangent_elements", "elem_tangent_apply",
            "ell_spmv")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise SystemExit(f"star T-spline main path never launched {missing}")
    if not out["f64_accurate"]:
        raise SystemExit("star T-spline floor certificate FAILED")
    return out, launches, U


def ts_reference(device):
    """Phase 14, step 3: the star at nel=4 (381 DoFs; the bench's options
    with coarse_size 50, as tests/test_torch_tsplines.py), solved on the
    card and through the plain versions on the CPU: steps within 1, U
    within 1e-8."""
    from tigar_tpu_torch.demos import star_tspline_shell as demo
    ns_g, ns_c = (demo.build(4, d, TS_REF) for d in (device, "cpu"))
    Ug, relg, itg, _ = ns_g.solve(rtol=demo.RTOL)
    Uc, relc, itc, _ = ns_c.solve(rtol=demo.RTOL)
    err = float((Ug.cpu() - Uc).abs().max() / Uc.abs().max())
    say(f"star T-spline small-input reference (nel=4, levels "
        f"{ns_g._sa.level_sizes}): card {itg} steps rel {relg:.3e}, CPU "
        f"plain {itc} steps rel {relc:.3e}, max rel diff of U {err:.3e}")
    if not (err <= 1e-8 and relg <= 1e-10 and abs(itg - itc) <= 1):
        raise SystemExit("star T-spline small-input reference FAILED")


# -- the generic form path: B5 (K12) under refinement, B9b (K11) -------------

# tests/test_refinement.py's Poisson at the size of the fast-path
# measurement (tigar_tpu/ops/fastpath.py:6-13): p=2, 256^2 elements,
# 66,564 DoFs, quadrature degree 4; the two-level SA cycle at 128^2 (its
# dense P refuses 256^2: ndof x m > 2e8)
GP_P, GP_NEL, GP_NEL2 = 2, 256, 128
GP_REFINE_ITERS = 120          # inner f32 CG iterations a sweep
GP_TOL = {"k12": 1e-6, "k12_ad": 2e-6, "solution": 1e-8, "ref": 1e-10}


def gp_spline(nel, device, p=GP_P, dim=2):
    """The unit square (or cube), homogeneous Dirichlet on every side,
    quadrature degree 2p (tests/test_refinement.py)."""
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu_torch.models.space import EqualOrderSpline
    from tigar_tpu_torch.models.extracted import ExtractedSpline
    cm = ExplicitBSplineControlMesh(
        [p] * dim, [uniform_knots(p, 0.0, 1.0, nel)] * dim)
    sp = EqualOrderSpline(1, cm)
    basis = sp.get_scalar_spline()
    for d in range(dim):
        for side in (0, 1):
            sp.add_zero_dofs(0, basis.side_dofs(d, side))
    return ExtractedSpline(sp, quad_degree=2 * p, device=device)


def gp_soln(x):
    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])


def gp_a(ctx, u, v):
    return torch.sum(ctx.grad(u) * ctx.grad(v))


def gp_L(ctx, v):
    return 2.0 * torch.pi ** 2 * gp_soln(ctx.x) * v.val


def gp_refine(sp, b, x0=None):
    """refine_solve with the f64 AD operator outside and K12 (Jacobi of the
    assembled diagonal) inside: (x, sweeps, rel)."""
    from tigar_tpu_torch.ops.fastpath import make_laplace_operator
    from tigar_tpu_torch.solvers.linear import jacobi_preconditioner
    from tigar_tpu_torch.solvers.refinement import refine_solve
    op64 = sp.matrix_operator(gp_a)
    op32 = make_laplace_operator(sp._assembler("dx"), sp.mask)
    M32 = jacobi_preconditioner(sp.assemble_diagonal(gp_a).float())
    return refine_solve(op64, op32, b, tol=1e-12,
                        inner_iters=GP_REFINE_ITERS, M_f32=M32, x0=x0)


def rel_diff(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def fastpath_kernel_phases(sp, rec):
    """K12 against its plain version at the path's shapes (2D p=2 256^2)
    and at 2D p=3 32^2 and 3D p=2 16^3, on the element matrices that
    ``make_laplace_operator`` builds, and the operator against the f64 AD
    tangent action; the library yardstick, at each shape, is the same BC'd
    operator as one f32 torch.sparse CSR matrix applied with ``@``."""
    from tigar_tpu_torch.ops import fastpath
    rec.setdefault("laplace_apply", [])
    dev = sp.device
    g = torch.Generator().manual_seed(21)
    for label, s in ((f"2D p=2 nel={GP_NEL}", sp),
                     ("2D p=3 nel=32", gp_spline(32, dev, p=3)),
                     ("3D p=2 nel=16", gp_spline(16, dev, dim=3))):
        asm = s._assembler("dx")
        Ke = fastpath.laplace_element_matrices(asm)
        connT = asm.conns[0].t().contiguous()
        nel, nq, nen, d = asm.dNs[0].shape
        m32 = s.mask.float()
        W = torch.randn(s.ndof, generator=g, dtype=torch.float64).to(dev)
        W32 = W.float()
        # reads Ke, connT, the mask and W, writes r; 2 nen^2 flops an
        # element.  The JAX layouts' bound, for the design this replaced:
        # 2 nen nq d floats an element in place of Ke
        work = (nbytes(Ke, connT, m32, W32, W32), 2.0 * nen * nen * nel,
                torch.float32)
        lay_bytes = 2 * nen * nq * d * nel * 4 + nbytes(connT, m32, W32, W32)
        compare(f"K12 laplace_apply f32 {label} nel={nel} "
                f"nen={nen} Ke rows={Ke.shape[0]}",
                lambda a=(Ke, connT, m32, W32):
                fastpath.laplace_apply_elem(*a),
                lambda a=(Ke, connT, m32, W32):
                fastpath.laplace_apply_elem_ref(*a),
                GP_TOL["k12"], 50, 5, rec["laplace_apply"],
                match="laplace_", work=work, per_call=2)
        lay_ms = bound(lay_bytes, 4.0 * nen * nq * d * nel, torch.float32)[0]
        rec["laplace_apply"][-1]["layouts_bound_ms"] = lay_ms
        say(f"    the JAX layouts' bound (the design this replaced): "
            f"{lay_ms:.4f} ms ({lay_bytes / 1e6:.2f} MB)")
        ref = s.tangent_action(gp_a, torch.zeros_like(W), W)
        out = fastpath.make_laplace_operator(asm, s.mask)(W)
        ad = float((out - ref).abs().max() / ref.abs().max())
        say(f"    K12 against the f64 AD tangent action ({label}): max "
            f"|diff| / max |ref| {ad:.3e} (bound {GP_TOL['k12_ad']:g})")
        if not ad <= GP_TOL["k12_ad"]:
            raise SystemExit(f"K12 against the AD tangent action FAILED "
                             f"({label})")
        A = s.assemble_sparse(gp_a).to(torch.float32).to_sparse_csr()
        yk = fastpath.laplace_apply_elem(Ke, connT, m32, W32)
        lib_err = rel_diff(torch.mv(A, W32), yk)
        lib = rec["laplace_apply"][-1]
        lib["library_ms"] = cuda_ms(lambda A=A, x=W32: torch.mv(A, x), 50)
        lib["library_probe"] = (lambda A=A, x=W32: torch.mv(A, x), 50)
        say(f"    library yardstick torch.sparse CSR f32 @ W ({label}, "
            f"{A._nnz()} entries): {lib['library_ms']:.4f} ms, rel diff "
            f"{lib_err:.1e}")


def twolevel_kernel_phases(pre, rec):
    """K11 in every mode on the two-level cycle's ELL operator (B9b's
    shape, ``ell_phases``) against the plain version, with the torch.sparse
    CSR yardstick; the whole cycle through K11 against the plain coo
    cycle."""
    rec.setdefault("ell_spmv_twolevel", [])
    g = torch.Generator().manual_seed(23)
    op = pre._ell_op
    ell_phases((op,), pre._om_dinv, "two-level", g, rec["ell_spmv_twolevel"])
    r = torch.randn(op.n, generator=g, dtype=torch.float64).to(
        op.vals.device, torch.float32)
    yk, yp = pre.apply32(r), pre.apply32_ref(r)
    err = rel_diff(yk, yp)
    say(f"    two-level cycle through K11 against the plain coo cycle: max "
        f"|diff| / max |plain| {err:.3e} (tol {TOL['f32']:g})")
    if not err <= TOL["f32"]:
        raise SystemExit("two-level SA cycle through K11 FAILED")


def generic_path(device, rec):
    """Phase 11, steps 1-6 (module docstring).  Returns what the profile
    and the launch table need."""
    from tigar_tpu_torch.ops import cuda_ext
    from tigar_tpu_torch.solvers.aggregation import TwoLevelSA

    t0 = time.perf_counter()
    sp = gp_spline(GP_NEL, device)
    torch.cuda.synchronize()
    say(f"generic Poisson setup: {time.perf_counter() - t0:.3f} s; "
        f"ndof={sp.ndof}, nel={GP_NEL}^2, p={GP_P}, quad_degree "
        f"{sp.quad_degree}")
    fastpath_kernel_phases(sp, rec)

    # step 2: the f64 reference solve (default options: cg at this ndof)
    zero = torch.zeros(sp.ndof, dtype=torch.float64, device=device)
    b = sp.assemble_vector(gp_L)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U = sp.solve_linear_variational_problem(gp_a, rhs_form=gp_L)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    info = dict(sp.last_linear_solve)
    true_rel = float(torch.linalg.norm(b - sp.tangent_action(gp_a, zero, U))
                     / torch.linalg.norm(b))
    say(f"generic f64 solve ({info['method']}, Jacobi, AD tangent action): "
        f"{t_cg:.3f} s, {info['iters']} iterations, recurrence rel "
        f"{info['rel']:.3e}, true rel {true_rel:.3e}")
    if not (bool(torch.isfinite(U).all()) and true_rel < 1e-11):
        raise SystemExit("generic f64 solve FAILED")

    # step 3: mixed-precision refinement, K12 inside
    torch.cuda.synchronize()
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    x, sweeps, rel = gp_refine(sp, b)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    l_ref = cuda_ext.counts()
    d_ref = rel_diff(x, U)
    say(f"generic refine_solve (f32 K12 + Jacobi inside, {GP_REFINE_ITERS} "
        f"inner iterations): {t_ref:.3f} s, {sweeps} sweeps, rel "
        f"{rel:.3e}; max |x - U_cg| / max |U_cg| {d_ref:.3e} (bound "
        f"{GP_TOL['solution']:g}); K12 launches {l_ref['laplace_apply']}")
    if not (rel < 1e-12 and d_ref <= GP_TOL["solution"]
            and l_ref["laplace_apply"] > 0):
        raise SystemExit("generic refine_solve FAILED")

    # step 4: L2 errors and the rate
    sp2 = gp_spline(GP_NEL2, device)
    U2 = sp2.solve_linear_variational_problem(gp_a, rhs_form=gp_L)
    e2 = float(sp2.errornorm(U2, lambda ctx: gp_soln(ctx.x)))
    e1 = float(sp.errornorm(U, lambda ctx: gp_soln(ctx.x)))
    rate = float(np.log2(e2 / e1))
    say(f"generic L2 errors {GP_NEL2}^2 / {GP_NEL}^2: {e2:.4e} / {e1:.4e}, "
        f"rate {rate:.4f} (> 2.7)")
    if not rate > 2.7:
        raise SystemExit("generic L2 rate FAILED")

    # step 5: two-level sa_cg at 128^2 (B9b through K11)
    sp2.set_solver_options(linear_solver="sa_cg", sa_levels=2)
    zero2 = torch.zeros(sp2.ndof, dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    pre, _ = sp2._sa_preconditioner(gp_a, zero2, None, True)
    torch.cuda.synchronize()
    setup2 = time.perf_counter() - t0
    if not isinstance(pre, TwoLevelSA):
        raise SystemExit("sa_levels=2 did not build a TwoLevelSA")
    say(f"two-level SA ({GP_NEL2}^2, {sp2.ndof} DoFs): m = {pre.n_coarse} "
        f"aggregates, omega {pre._omega:.6f}; host setup {setup2:.3f} s "
        f"(sparse assembly on the card, scipy/numpy on the host)")
    twolevel_kernel_phases(pre, rec)
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    Usa2 = sp2.solve_linear_variational_problem(gp_a, rhs_form=gp_L)
    torch.cuda.synchronize()
    t_sa2 = time.perf_counter() - t0
    l_sa2 = cuda_ext.counts()
    it2 = sp2.last_linear_solve["iters"]
    d_sa2 = rel_diff(Usa2, U2)
    say(f"two-level sa_cg solve: {t_sa2:.3f} s, {it2} iterations, rel "
        f"{sp2.last_linear_solve['rel']:.3e}; max |U - U_cg| / max |U_cg| "
        f"{d_sa2:.3e} (bound {GP_TOL['solution']:g}); K11 launches "
        f"{l_sa2['ell_spmv']} (by op and mode "
        f"{cuda_ext.counts_by('ell_spmv')})")
    if not (d_sa2 <= GP_TOL["solution"] and l_sa2["ell_spmv"] > 0):
        raise SystemExit("two-level sa_cg FAILED")

    # step 6: multilevel sa_cg (sa_levels=4) at 256^2
    sp.set_solver_options(linear_solver="sa_cg", sa_levels=4)
    t0 = time.perf_counter()
    pre4, _ = sp._sa_preconditioner(gp_a, zero, None, True)
    torch.cuda.synchronize()
    setup4 = time.perf_counter() - t0
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    Usa4 = sp.solve_linear_variational_problem(gp_a, rhs_form=gp_L)
    torch.cuda.synchronize()
    t_sa4 = time.perf_counter() - t0
    l_sa4 = cuda_ext.counts()
    d_sa4 = rel_diff(Usa4, U)
    say(f"multilevel sa_cg ({GP_NEL}^2): levels {pre4.level_sizes}, host "
        f"setup {setup4:.3f} s; solve {t_sa4:.3f} s, "
        f"{sp.last_linear_solve['iters']} iterations, rel "
        f"{sp.last_linear_solve['rel']:.3e}; max |U - U_cg| / max |U_cg| "
        f"{d_sa4:.3e} (bound {GP_TOL['solution']:g}); K11 launches "
        f"{l_sa4['ell_spmv']}")
    if not (d_sa4 <= GP_TOL["solution"] and l_sa4["ell_spmv"] > 0):
        raise SystemExit("multilevel sa_cg FAILED")
    sp.set_solver_options(linear_solver="cg")
    return dict(sp=sp, b=b, x=x, launches={
        "refine": {"laplace_apply": l_ref["laplace_apply"]},
        "sa_two_level": {"ell_spmv": l_sa2["ell_spmv"]},
        "sa_multilevel": {"ell_spmv": l_sa4["ell_spmv"]}})


def generic_reference(device):
    """Phase 11, step 7: nel=8, the card against the CPU plain versions
    for direct, cg, refine_solve and two-level sa_cg (U within 1e-10)."""
    out = {}
    for key, dev in (("card", device), ("cpu", "cpu")):
        s = gp_spline(8, dev)
        res = {}
        for method in ("direct", "cg", "sa_cg"):
            s.set_solver_options(linear_solver=method)
            res[method] = s.solve_linear_variational_problem(
                gp_a, rhs_form=gp_L).cpu()
        x, sweeps, _ = gp_refine(s, s.assemble_vector(gp_L))
        res["refine_solve"] = x.cpu()
        out[key] = (res, sweeps)
    diffs = {k: rel_diff(out["card"][0][k], v)
             for k, v in out["cpu"][0].items()}
    say(f"generic small-input reference (nel=8): card against CPU plain "
        f"versions, max rel diff of U {diffs}; refine sweeps card "
        f"{out['card'][1]}, CPU {out['cpu'][1]}")
    if not all(v <= GP_TOL["ref"] for v in diffs.values()):
        raise SystemExit("generic small-input reference FAILED")


def profile_refine_sweep(gp):
    """Phase 11, step 8: torch.profiler over one refinement sweep at the
    solution's neighbourhood (the f64 AD residual, 120 f32 CG iterations
    with K12, the update): device busy time and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    from tigar_tpu_torch.ops.fastpath import make_laplace_operator
    from tigar_tpu_torch.solvers.linear import (cg_fixed_iters,
                                                jacobi_preconditioner)
    sp, b = gp["sp"], gp["b"]
    x0 = torch.zeros_like(b)
    op64 = sp.matrix_operator(gp_a)
    op32 = make_laplace_operator(sp._assembler("dx"), sp.mask)
    M32 = jacobi_preconditioner(sp.assemble_diagonal(gp_a).float())

    def sweep():
        r = b - op64(x0)
        d, _ = cg_fixed_iters(op32, r.float(), GP_REFINE_ITERS, M=M32)
        return x0 + d.double()

    wall = best_of_3(sweep)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]
    if not rows:
        say("profile refinement sweep: no device time recorded (not "
            "measured)")
        return
    dev_ms = sum(r[2] for r in rows) / 1e3
    say(f"profile refinement sweep ({GP_NEL}^2): device busy {dev_ms:.3f} ms "
        f"of {wall * 1e3:.3f} ms un-profiled wall (busy share "
        f"{dev_ms / wall / 1e3:.3f}); {sum(r[1] for r in rows)} device ops")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:10]:
        say(f"    {us / 1e3:9.3f} ms  {us / 1e3 / dev_ms:6.3f} of busy  "
            f"{count:6d} x  {key[:90]}")


# -- phase 12: penalty self-contact, the reef-knot demo (K13, K14) ----------

# demos/kl_shell_svk/reef_knot_contact.py with NEL=96 MG=1 MIXED=1: 28,812
# DoFs, 9,604 collocation points, a 5-level f32 V-cycle, 40 f32 CG
# iterations a Newton correction
RK_NEL = 96
RK_ACTIVE = dict(k=1e4, r_max=0.3, r_self=0.05)   # tests/test_contact.py:29
# the JAX demo's Newton count (residual evaluations) for step 1 at NEL=96
# MG=1 MIXED=1, run on a CPU (PERF.md section 6)
RK_JAX_NEWTON = 7
# CG iterations of the card-vs-CPU references (the CPU runs apply the AD
# shell action eagerly, ~0.1 s a call); at 5 the NEL=12 card and CPU
# solutions drifted to 9.3e-10 of each other, over the 1e-10 bound
RK_REF_CG = 10
# CG iterations of the profiled correction: an eighth of the demo's 40, to
# keep the script inside its time limit (an iteration is tens of thousands
# of device ops, each a profiler event to process)
RK_PROF_CG = 5
RK_TOL = {"f64": 1e-12, "f32": 1e-5, "ref": 1e-10}


def contact_pair_counts(c, x):
    """(live pairs, interacting pairs: live with r < r_max) at points x."""
    n, live, inter = x.shape[0], 0, 0
    for i0 in range(0, n, 1024):
        d2 = ((x[i0:i0 + 1024, None, :] - x[None, :, :]) ** 2).sum(-1)
        m = c.pair_mask[i0:i0 + 1024]
        live += int(m.sum())
        inter += int((m & (d2 < c.r_max ** 2)).sum())
    return live, inter


def contact_kernel_phases(c, U, W, label, rec, profile):
    """K13 and K14 against their plain versions at the state U (point
    perturbations P W for K14), in f64 and f32.  Their bound: the n^2
    mask bytes, the points, weights (and perturbations) read once and the
    result written once, against the kernels' operations on this state's
    pairs: 8 a live pair (the squared distance), 10 more an interacting
    one for K13, 28 more for K14.  With ``profile`` each kernel's device
    time is taken right away (torch.profiler)."""
    from tigar_tpu_torch.ops import contact as oc
    for dt in (torch.float64, torch.float32):
        tname = "f64" if dt == torch.float64 else "f32"
        cc = c if dt == torch.float64 else c.astype(dt)
        x = cc.positions(U.to(dt)).contiguous()
        v = cc._apply_P(W.to(dt)).contiguous()
        n = x.shape[0]
        live, inter = contact_pair_counts(cc, x.double())
        say(f"contact state {label} {tname}: n={n}, live pairs {live}, "
            f"interacting pairs (live, r < r_max) {inter}")
        io = n * n + x.element_size() * (2 * x.numel() + n)
        for name, kern, plain, work in (
                ("contact_residual",
                 lambda: oc.contact_forces(x, cc.quad_w, cc.pair_mask, cc.k,
                                           cc.r_max),
                 lambda: oc.contact_forces_ref(x, cc.quad_w, cc.pair_mask,
                                               cc.phi, cc.r_max,
                                               cc.row_chunk),
                 (io, 8.0 * live + 10.0 * inter, dt)),
                ("contact_tangent",
                 lambda: oc.contact_hvp(x, v, cc.quad_w, cc.pair_mask, cc.k,
                                        cc.r_max),
                 lambda: oc.contact_hvp_ref(x, v, cc.quad_w, cc.pair_mask,
                                            cc.phi, cc.r_max, cc.row_chunk),
                 (io + x.element_size() * v.numel(),
                  8.0 * live + 28.0 * inter, dt))):
            kn = "K13" if name == "contact_residual" else "K14"
            rec.setdefault(name, [])
            yk, yp = kern(), plain()
            torch.cuda.synchronize()
            if float(yp.abs().max()) == 0.0:
                # no interacting pair: both sides must be exactly zero
                err = float(yk.abs().max())
                say(f"phase {kn} {name} {tname} {label} n={n}: no "
                    f"interacting pair, max |kernel| {err:.3e}")
                if err != 0.0:
                    raise SystemExit(f"{kn} {name} FAILED at {label}")
                rec[name].append(dict(name=f"{kn} {name} {tname} {label}",
                                      rel=0.0, abs=0.0))
                continue
            compare(f"{kn} {name} {tname} {label} n={n}", kern, plain,
                    RK_TOL[tname], 20 if profile else 5,
                    2 if profile else 0, rec[name],
                    match="contact_pairs_kernel" if profile else None,
                    work=work if profile else None)
            if profile:
                probe_device_time(rec[name][-1])


def contact_early(device, rec):
    """Phase 12, step 1a, with phase 2's kernel checks and before any
    other profiler session: K13/K14 on the 96^2 spline's 9,604 points at
    tests/test_contact.py's active state, U = 0.01 N(0, 1) and W ~ N(0, 1)
    from numpy seed 0; their device times."""
    from tigar_tpu_torch.contact import PointContact
    from tigar_tpu_torch.demos.reef_knot_contact import build_spline
    t0 = time.perf_counter()
    sp = build_spline(RK_NEL, device)
    c = PointContact(sp, **RK_ACTIVE)
    torch.cuda.synchronize()
    say(f"contact setup (96^2 spline, {c.X.shape[0]} points, "
        f"{RK_ACTIVE}): {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    U = torch.as_tensor(rng.normal(size=sp.ndof) * 0.01, device=device)
    W = torch.as_tensor(rng.normal(size=sp.ndof), device=device)
    contact_kernel_phases(c, U, W, "(a)", rec, profile=True)


def reef_knot_path(device, rec):
    """Phase 12, steps 1b-4: the demo step at 96^2 with every launch count
    reset just before it and read just after, K13/K14 at the state after
    the step, the card-vs-CPU references and the CG profile.  Returns the
    step's launches."""
    from tigar_tpu_torch.ops import cuda_ext
    from tigar_tpu_torch.contact import PointContact
    from tigar_tpu_torch.demos import reef_knot_contact as demo

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    cuda_ext.reset_counts()
    U, hist, energy = demo.run(RK_NEL, 1, mixed=True, mg=True, device=device,
                               log=say)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_ext.counts()
    rel_final = hist[0][-1]
    say(f"reef-knot demo (NEL={RK_NEL}, MG=1, MIXED=1): {wall:.3f} s "
        f"with setup; step 1 in {len(hist[0])} residual evaluations "
        f"(JAX reference {RK_JAX_NEWTON}), final rel {rel_final:.3e}; "
        f"contact energy {energy:.6e}; K13 launches "
        f"{launches['contact_residual']}, K14 launches "
        f"{launches['contact_tangent']}")
    if not (bool(torch.isfinite(U).all()) and rel_final < demo.REL_TOL
            and abs(len(hist[0]) - RK_JAX_NEWTON) <= 1
            and launches["contact_residual"] > 0
            and launches["contact_tangent"] > 0):
        raise SystemExit("reef-knot demo step FAILED")

    # step 2: the demo's own contact at the state after the step
    c = PointContact(demo.build_spline(RK_NEL, device), **demo.CONTACT)
    W = torch.as_tensor(np.random.default_rng(1).normal(size=U.numel()),
                        device=device)
    contact_kernel_phases(c, U, W, "(b)", rec, profile=False)

    # step 3: card against the CPU plain versions
    for nel, mg in ((6, False), (12, True)):
        out = {}
        for dev in (device, "cpu"):
            t1 = time.perf_counter()
            Ux, hx, _ = demo.run(nel, 1, mixed=False, mg=mg,
                                 cg_iters=RK_REF_CG, device=dev)
            out[str(dev)] = (Ux.cpu(), len(hx[0]), time.perf_counter() - t1)
        (Ug, ng, tg), (Uc, nc, tc) = out[str(device)], out["cpu"]
        d = rel_diff(Ug, Uc)
        say(f"reef-knot card-vs-CPU (NEL={nel}, MG={int(mg)}, MIXED=0, "
            f"{RK_REF_CG} CG iterations): Newton card {ng} ({tg:.1f} s), "
            f"CPU {nc} ({tc:.1f} s); max |U_card - U_cpu| / max |U_cpu| "
            f"{d:.3e} (bound {RK_TOL['ref']:g})")
        if not (ng == nc and d <= RK_TOL["ref"]):
            raise SystemExit(f"reef-knot card-vs-CPU reference FAILED "
                             f"(NEL={nel})")
    t0 = time.perf_counter()
    profile_reef_knot_cg(U, device)
    say(f"reef-knot CG profile took {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] for k in ("contact_residual", "contact_tangent")}


def profile_reef_knot_cg(U, device):
    """Phase 12, step 4: torch.profiler over the first RK_PROF_CG f32
    iterations of a Newton correction's CG (the V-cycle, K14) at the state
    after the step:
    device busy share, K14's share, and the f32 AD shell actions' share
    (their CUDA-event time a call, one graph replay at a time, times the
    calls the CG made)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    from tigar_tpu_torch.demos import reef_knot_contact as demo
    from tigar_tpu_torch.ops import cuda_ext
    from tigar_tpu_torch.solvers.linear import cg_device_iters

    rk = demo.ReefKnot(RK_NEL, device=device)
    r = rk.residual(U, U).float()
    A, M, _ = rk.operator(U, U)
    calls = [0] * len(rk.M.levels)
    shells = [rk.M._actions[lev] for lev in range(len(calls) - 1)]

    def counted(lev, fn):
        def f(W):
            calls[lev] += 1
            return fn(W)
        return f

    for lev, fn in enumerate(shells):
        rk.M._actions[lev] = counted(lev, fn)

    def solve():
        return cg_device_iters(A, r, RK_PROF_CG, M=M)[0]

    wall = best_of_3(solve)
    for i in range(len(calls)):
        calls[i] = 0
    k14_0 = cuda_ext.counts()["contact_tangent"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    k14_n = cuda_ext.counts()["contact_tangent"] - k14_0
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]
    if not rows:
        say("profile reef-knot CG: no device time recorded (not measured)")
        return
    busy = sum(rw[2] for rw in rows) / 1e3
    k14 = sum(rw[2] for rw in rows if "contact_pairs_kernel" in rw[0]) / 1e3
    k14_rec = sum(rw[1] for rw in rows if "contact_pairs_kernel" in rw[0])
    # the session is a measurement only if it recorded every K14 launch
    # and its busy time fits in the profiled wall
    ok = k14_rec == k14_n and busy <= prof_wall * 1e3
    say(f"profile reef-knot CG session: K14 launches recorded {k14_rec} of "
        f"{k14_n}, device busy {busy:.3f} ms of {prof_wall * 1e3:.3f} ms "
        f"profiled wall: "
        + ("complete" if ok else "NOT a measurement, the shares below "
           "are not measured"))
    # the fine shell action runs once more a CG iteration inside A
    calls[0] += RK_PROF_CG + 1
    per = []
    for lev, fn in enumerate(shells):
        W = torch.randn(rk.M.levels[lev]["dinv"].shape[0], device=device)
        per.append(cuda_ms(lambda fn=fn, W=W: fn(W), 5))
    shell = sum(c * t for c, t in zip(calls, per))
    say(f"profile reef-knot CG ({RK_PROF_CG} f32 iterations at the state "
        f"after step 1): device busy {busy:.3f} ms of {wall * 1e3:.3f} ms "
        f"un-profiled wall (busy share {busy / wall / 1e3:.3f}); K14 "
        f"{k14:.3f} ms ({k14 / busy:.3f} of busy); f32 AD shell actions "
        f"{shell:.3f} ms ({shell / busy:.3f} of busy, {shell / wall / 1e3:.3f} "
        f"of the un-profiled wall; calls a level {calls[:-1]}, CUDA-event ms "
        f"a call {[round(t, 4) for t in per]})")
    for key, count, us in sorted(rows, key=lambda rw: -rw[2])[:8]:
        say(f"    {us / 1e3:9.3f} ms  {us / 1e3 / busy:6.3f} of busy  "
            f"{count:6d} x  {key[:90]}")


# -- phase 13: sum-factorized forms (K15, K16) --------------------------------

# scripts/bench_shell_sumfac.py:40-62: the clamped 128^2 SVK shell (the
# shell path's spline), E=1e7, nu=0.3, h=0.03, load q=1e-2 on the third
# field, U = 1e-4 N(0, 1) from numpy seed 0; the module docstring's 3D
# Poisson residual (tigar_tpu/ops/sumfac_forms.py:28-37): p=2, 24^3
# elements, continuity_drop=1, quadrature degree 4, 117,649 DoFs
SF_Q, SF_NEL3 = 1.0e-2, 24
SF_TOL = {"f64": 1e-12, "f32": 1e-5, "shell": 1e-9, "poisson": 1e-12,
          "ref": 1e-12}


def sf_shell_form(ctx, u, v):
    from tigar_tpu_torch.forms import deriv
    from tigar_tpu_torch.models.shell import svk_psi_surface
    return deriv(lambda y: svk_psi_surface(ctx, y, E_MOD, NU, H_TH), u,
                 v) - SF_Q * v.val[2]


def sf_poisson_form(ctx, u, v):
    uu, vv = ctx.rationalize(u), ctx.rationalize(v)
    return torch.dot(ctx.grad(uu), ctx.grad(vv)) - 1.0 * vv.val


def sf_shell_assembler(spline):
    """The sumfac assembler with the shell reference attached to its ctx
    (scripts/bench_shell_sumfac.py:63-68)."""
    from tigar_tpu_torch.models.shell import shell_reference
    from tigar_tpu_torch.ops.sumfac_forms import make_sumfac_assembler
    asm = make_sumfac_assembler(spline)
    aux = dict(asm.ctx.aux or {})
    aux["shell_ref"] = shell_reference(asm.ctx)
    asm.ctx = asm.ctx._replace(aux=aux)
    return asm


def sf_poisson_spline(nel, device):
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu_torch.models.space import EqualOrderSpline
    from tigar_tpu_torch.models.extracted import ExtractedSpline
    kv = uniform_knots(2, 0.0, 1.0, nel, continuity_drop=1)
    cm = ExplicitBSplineControlMesh([2, 2, 2], [kv] * 3)
    return ExtractedSpline(EqualOrderSpline(1, cm), quad_degree=4,
                           device=device)


def sf_layouts(device, shell_spline, shell_asm, poisson_asm):
    """(label, layout) of every K15/K16 check: the shell's three fields
    and its control net (four columns) at nders 2, the 24^3 field at
    nders 1, a small periodic (gather) field and the small RT pair."""
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import (ExplicitBSplineControlMesh,
                                                TensorBSplineBasis)
    from tigar_tpu_torch.models.compatible import generate_fields_compat
    from tigar_tpu_torch.ops.sumfac_forms import (DevicePlan, FieldPlan,
                                                  JetGroup, JetLayout)
    ctrl = DevicePlan(FieldPlan(shell_spline.control_basis,
                                shell_spline.npts, 2), device, torch.float64)
    m = shell_spline.bnet.shape[1]
    out = [(f"shell fields {NEL}^2", shell_asm.layout),
           (f"shell control net {NEL}^2",
            JetLayout([JetGroup(ctrl, 0, m, 1, m, 0)],
                      m * shell_spline.control_basis.ncp)),
           (f"poisson {SF_NEL3}^3 drop 1", poisson_asm.layout)]
    per = DevicePlan(FieldPlan(TensorBSplineBasis([2, 2], [
        uniform_knots(2, 0., 1., 6, periodic=True),
        uniform_knots(2, 0., 1., 4)]), 3, 2), device, torch.float64)
    out.append(("periodic 6x4", JetLayout(
        [JetGroup(per, 0, 1, per.ncp, 1, 0)], per.ncp)))
    rt = [DevicePlan(FieldPlan(b, 3, 1), device, torch.float64)
          for b in generate_fields_compat(ExplicitBSplineControlMesh(
              [1, 1], [uniform_knots(1, 0., 1., 4)] * 2), "RT", [1, 1])]
    out.append(("RT 4x4", JetLayout(
        [JetGroup(rt[0], 0, 1, rt[0].ncp, 1, 0),
         JetGroup(rt[1], rt[0].ncp, 1, rt[1].ncp, 1, 1)],
        rt[0].ncp + rt[1].ncp)))
    return out


def sf_jets_bytes(layout, dt, with_jets=True):
    """Bytes K15 (or K16) must move: the coefficient vector, the tables
    and windows read once, the jets written (read) once."""
    es = torch.tensor([], dtype=dt).element_size()
    tabs = sum(t.numel() * es for g in layout.groups for t in g.plan.tabs)
    idx = sum(4 * i.numel() for g in layout.groups for i in g.plan.idxs
              if i is not None)
    njets = 1 + layout.dim + (layout.dim ** 2 if layout.nders >= 2 else 0)
    return layout.n * es + tabs + idx + layout.nq_total * layout.M * \
        njets * es


def jets_flat(jets):
    """The jets (val, g, h or None) of a layout as one flat vector."""
    return torch.cat([x.reshape(-1) for x in jets if x is not None])


def jets_csr(layout):
    """K15's linear map W -> jets (``jets_flat`` order) of an f64 layout as
    one torch.sparse CSR matrix J, and J^T (K16's map) as another: the
    library yardstick of K15/K16.  Columns are probed in colors (each
    coefficient's grid index modulo the window width pp in every
    direction, so no output reads two coefficients of one color): a probe
    with the color's indicator gives the entries, one weighted by column
    index + 1 gives their columns."""
    from tigar_tpu_torch.ops.sumfac_forms import jets_plain
    dev = layout.groups[0].plan.tabs[0].device
    color = torch.full((layout.n,), -1, dtype=torch.int64, device=dev)
    for g in layout.groups:
        ncp_d = g.plan.ncp_d
        pp = [m[4] for m in g.plan.metas]
        idx = torch.arange(g.plan.ncp, device=dev)
        c, rest, mult = torch.zeros_like(idx), idx, 1
        for n_d, p_d in zip(ncp_d, pp):
            c = c + (rest % n_d % p_d) * mult
            rest, mult = rest // n_d, mult * p_d
        for k in range(g.ncols):
            color[g.base + k * g.col_stride + idx * g.cp_stride] = c
    pos = torch.arange(1, layout.n + 1, dtype=torch.float64, device=dev)
    rows, cols, vals = [], [], []
    for k in range(int(color.max()) + 1):
        w = (color == k).to(torch.float64)
        y1, y2 = jets_flat(jets_plain(w, layout)), \
            jets_flat(jets_plain(w * pos, layout))
        nz = torch.nonzero(y1).reshape(-1)
        rows.append(nz)
        cols.append(torch.round(y2[nz] / y1[nz]).long() - 1)
        vals.append(y1[nz])
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    m = int(jets_flat(jets_plain(torch.zeros(layout.n, dtype=torch.float64,
                                             device=dev), layout)).numel())
    J = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                (m, layout.n)).coalesce().to_sparse_csr()
    Jt = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals,
                                 (layout.n, m)).coalesce().to_sparse_csr()
    return J, Jt


def jets_library(entry, A, x, ref, reps, what):
    """The library yardstick of a K15/K16 record: ``A @ x`` (one
    torch.sparse CSR product) against the plain version's ``ref``, its
    CUDA-event time and, right away, its profiler device time."""
    err = float((A @ x - ref).abs().max() / ref.abs().max())
    entry["library_ms"] = cuda_ms(lambda A=A, x=x: A @ x, reps)
    entry["library_dev_ms"], got, few = library_device_ms(
        lambda A=A, x=x: A @ x, reps)
    dev = ("not measured (sessions of 10 and "
           f"{reps} calls recorded {few:g} and {got:g} events a call)"
           if entry["library_dev_ms"] is None
           else f"{entry['library_dev_ms']:.4f} ms")
    say(f"    library yardstick {what}: torch.sparse CSR @ ({A._nnz()} "
        f"entries, {A.shape[0]} x {A.shape[1]}) {entry['library_ms']:.4f} "
        f"ms, device {dev}, rel diff {err:.1e}")
    if not err <= SF_TOL["f32" if A.dtype == torch.float32 else "f64"]:
        raise SystemExit(f"the CSR yardstick of {what} computes another "
                         f"map: rel diff {err:.3e}")


def sumfac_kernel_phases(device, shell_spline, shell_asm, poisson_asm, rec):
    """Phase 13, step 1 (with phase 2's kernel checks, before the main
    paths' profiler sessions): K15/K16 against their plain versions in f64
    and f32 at every layout of ``sf_layouts`` (f64 1e-12, f32 1e-5 of the
    largest entry), their CUDA-event times, byte bounds and (right away)
    device times."""
    from tigar_tpu_torch.ops import sumfac_forms as sf
    rec.setdefault("sumfac_jets", [])
    rec.setdefault("sumfac_scatter_jets", [])
    rng = np.random.default_rng(4)
    for label, lay64 in sf_layouts(device, shell_spline, shell_asm,
                                   poisson_asm):
        W64 = torch.as_tensor(rng.normal(size=lay64.n), device=device)
        full = ("fields" in label or "poisson" in label
                or "control net" in label)
        if full:
            t0 = time.perf_counter()
            J64, Jt64 = jets_csr(lay64)
            say(f"K15/K16 yardstick {label}: J {tuple(J64.shape)}, "
                f"{J64._nnz()} entries, built in "
                f"{time.perf_counter() - t0:.2f} s")
        for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
            lay = lay64 if dt == torch.float64 else lay64.cast(dt)
            W = W64.to(dt)
            jk, jp = sf.jets_cuda(W, lay), sf.jets_plain(W, lay)
            torch.cuda.synchronize()
            ref = max(float(x.abs().max()) for x in jp if x is not None)
            err = max(float((a - b).abs().max())
                      for a, b in zip(jk, jp) if b is not None)
            cot = tuple(None if x is None else torch.as_tensor(
                rng.normal(size=tuple(x.shape)), device=device).to(dt)
                for x in jp)
            name = f"K15 sumfac_jets {tag} {label}"
            ms = cuda_ms(lambda w=W, l=lay: sf.jets_cuda(w, l),
                         20 if full else 5)
            plain_ms = cuda_ms(lambda w=W, l=lay: sf.jets_plain(w, l), 3)
            say(f"phase {name}: max rel err {err / ref:.3e} (tol "
                f"{SF_TOL[tag]:g}), max abs err {err:.3e}, kernel "
                f"{ms:.4f} ms, twin {plain_ms:.4f} ms")
            if not err <= SF_TOL[tag] * ref:
                raise SystemExit(f"phase {name} FAILED")
            entry = dict(name=name, rel=err / ref, abs=err, ms=ms,
                         plain_ms=plain_ms)
            entry["bound_ms"], entry["bound_by"] = bound(
                sf_jets_bytes(lay, dt), 0.0, dt)
            say(f"    bound {entry['bound_ms']:.4f} ms by bytes "
                f"({sf_jets_bytes(lay, dt) / 1e6:.2f} MB)")
            entry["probe"] = (lambda w=W, l=lay: sf.jets_cuda(w, l),
                              20 if full else 5, "sumfac_jets_kernel",
                              len(lay.groups))
            rec["sumfac_jets"].append(entry)
            probe_device_time(entry)
            if full:
                J = J64 if dt == torch.float64 else J64.to(dt)
                jets_library(entry, J, W, jets_flat(jp), 20,
                             f"K15 {tag} {label} (J @ W)")
            compare(f"K16 sumfac_scatter_jets {tag} {label}",
                    lambda c=cot, l=lay: sf.scatter_jets_cuda(c, l),
                    lambda c=cot, l=lay: sf.scatter_jets_plain(c, l),
                    SF_TOL[tag], 20 if full else 5, 3,
                    rec["sumfac_scatter_jets"],
                    match="sumfac_scatter_jets_",
                    work=(sf_jets_bytes(lay, dt), 0.0, dt),
                    per_call=2 * len(lay.groups))
            probe_device_time(rec["sumfac_scatter_jets"][-1])
            if full:
                Jt = Jt64 if dt == torch.float64 else Jt64.to(dt)
                jets_library(rec["sumfac_scatter_jets"][-1], Jt,
                             jets_flat(cot), sf.scatter_jets_plain(cot, lay),
                             20, f"K16 {tag} {label} (J^T @ F)")


def sumfac_forms_path(device, shell_spline, shell_asm, poisson_sp,
                      poisson_asm):
    """Phase 13, step 2, the main path: the 128^2 shell's sumfac residual
    and tangent action (f64) with K15/K16's counts reset just before and
    read just after, each against the generic assembler (<= 1e-9 of the
    largest entry, as scripts/bench_shell_sumfac.py asserts); best of 3
    warm times of both assemblers' residual and the sumfac tangent action,
    f32 and f64; the 24^3 Poisson residual, sumfac against generic (f64,
    1e-12), both timed.  Returns the main path's launches."""
    from tigar_tpu_torch.forms import tree_jvp
    from tigar_tpu_torch.ops import cuda_ext
    ndof = shell_spline.ndof
    rng = np.random.default_rng(0)
    U64 = torch.as_tensor(rng.normal(size=ndof) * 1e-4, device=device)
    W64 = torch.as_tensor(rng.normal(size=ndof), device=device)
    gen = shell_spline._assembler("dx")
    torch.cuda.synchronize()
    cuda_ext.reset_counts()
    r_sf = shell_asm.residual_vector(sf_shell_form, U64)
    t_sf = shell_asm.tangent_action(sf_shell_form, U64, W64)
    torch.cuda.synchronize()
    launches = {k: cuda_ext.counts()[k]
                for k in ("sumfac_jets", "sumfac_scatter_jets")}
    r_gen, t_gen = tree_jvp(
        lambda a: gen.residual_vector(sf_shell_form, a), U64, W64)
    for what, a, b in (("residual", r_sf, r_gen), ("tangent action", t_sf,
                                                   t_gen)):
        if tuple(a.shape) != (ndof,) or not bool(torch.isfinite(a).all()):
            raise SystemExit(f"sumfac shell {what} is not finite or has "
                             "the wrong shape")
        d, m = float((a - b).abs().max()), float(b.abs().max())
        say(f"sumfac shell {NEL}^2 {what} (f64): max |generic - sumfac| "
            f"{d:.3e} (rel {d / m:.3e}, tol {SF_TOL['shell']:g})")
        if not d <= SF_TOL["shell"] * m:
            raise SystemExit(f"sumfac shell {what} FAILED")
    say(f"sumfac shell main path (one residual, one tangent action) "
        f"kernel launches: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit("the sumfac main path never launched K15/K16")
    times = {}
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        g = gen if dt == torch.float64 else gen.astype(dt)
        s = shell_asm if dt == torch.float64 else shell_asm.to(dt)
        U, W = U64.to(dt), W64.to(dt)
        for name, fn in (
                ("generic residual",
                 lambda g=g, U=U: g.residual_vector(sf_shell_form, U)),
                ("sumfac residual",
                 lambda s=s, U=U: s.residual_vector(sf_shell_form, U)),
                ("sumfac tangent action",
                 lambda s=s, U=U, W=W: s.tangent_action(sf_shell_form, U,
                                                        W))):
            fn()
            cuda_ext.reset_counts()
            times[f"{name} {tag}"] = best_of_3(fn)
            c = cuda_ext.counts()
            say(f"sumfac shell {NEL}^2 {name} {tag}: best of 3 "
                f"{times[f'{name} {tag}'] * 1e3:.3f} ms (K15 "
                f"{c['sumfac_jets']}, K16 {c['sumfac_scatter_jets']} "
                f"launches in the 3 calls)")
    Up = torch.as_tensor(rng.normal(size=poisson_sp.ndof), device=device)
    gp = poisson_sp._assembler("dx")
    rp_sf = poisson_asm.residual_vector(sf_poisson_form, Up)
    rp_gen = gp.residual_vector(sf_poisson_form, Up)
    d = float((rp_sf - rp_gen).abs().max()) / float(rp_gen.abs().max())
    t_psf = best_of_3(lambda: poisson_asm.residual_vector(sf_poisson_form,
                                                          Up))
    t_pgen = best_of_3(lambda: gp.residual_vector(sf_poisson_form, Up))
    say(f"sumfac poisson {SF_NEL3}^3 continuity_drop=1 "
        f"({poisson_sp.ndof} DoFs) residual (f64): rel diff to generic "
        f"{d:.3e} (tol {SF_TOL['poisson']:g}); best of 3 sumfac "
        f"{t_psf * 1e3:.3f} ms, generic {t_pgen * 1e3:.3f} ms")
    if not d <= SF_TOL["poisson"]:
        raise SystemExit("sumfac 24^3 Poisson residual FAILED")
    return launches


def sumfac_reference(device):
    """Phase 13, step 3: at tests/test_sumfac_forms.py's sizes (the shell
    at nel=5, the 3D Poisson at nel=3) the card's kernels against the CPU
    plain versions: residual (and the shell's tangent action) within
    1e-12."""
    from tigar_tpu_torch.ops.knots import uniform_knots
    from tigar_tpu_torch.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu_torch.models.space import EqualOrderSpline
    from tigar_tpu_torch.models.extracted import ExtractedSpline
    from tigar_tpu_torch.ops.sumfac_forms import make_sumfac_assembler
    rng = np.random.default_rng(7)
    diffs = {}
    for label, form in (("shell nel=5", sf_shell_form),
                        ("3d nel=3", sf_poisson_form)):
        out = {}
        for dev in ("cpu", device):
            if form is sf_shell_form:
                cm = ExplicitBSplineControlMesh(
                    [2, 2], [uniform_knots(2, -1., 1., 5)] * 2, extra_dim=1)
                sp = ExtractedSpline(EqualOrderSpline(3, cm), quad_degree=4,
                                     nders=2, device=dev)
            else:
                cm = ExplicitBSplineControlMesh(
                    [2, 2, 2], [uniform_knots(2, 0., 1., 3)] * 3)
                sp = ExtractedSpline(EqualOrderSpline(1, cm), quad_degree=4,
                                     device=dev)
            asm = make_sumfac_assembler(sp)
            if dev == "cpu":
                U = rng.normal(size=sp.ndof) * 1e-3
                W = rng.normal(size=sp.ndof)
            Ut = torch.as_tensor(U, device=dev)
            Wt = torch.as_tensor(W, device=dev)
            out[dev == "cpu"] = [asm.residual_vector(form, Ut).cpu()]
            if form is sf_shell_form:
                out[dev == "cpu"].append(
                    asm.tangent_action(form, Ut, Wt).cpu())
        diffs[label] = max(rel_diff(a, b) for a, b in zip(out[False],
                                                          out[True]))
    say(f"sumfac small-input reference: card against CPU plain versions, "
        f"max rel diff {diffs}")
    if not all(v <= SF_TOL["ref"] for v in diffs.values()):
        raise SystemExit("sumfac small-input reference FAILED")


def binding_refusals():
    """C3: one refused call per check site of every binding, all in one
    child process (tigar_tpu_torch.ops.refusals), so that a call that
    ends its process fails this phase instead of the script; every one
    must raise RuntimeError."""
    from tigar_tpu_torch.ops import refusals
    t0 = time.time()
    rc, lines = refusals.run()
    for ln in lines:
        if not ln.endswith(": ..."):
            say(f"refusal {ln}")
    if rc != 0:
        raise SystemExit(f"binding refusals FAILED (exit {rc})")
    say(f"binding refusals: {time.time() - t0:.1f} s")


def main():
    global CARD
    from tigar_tpu_torch.config import require_cuda
    device = require_cuda()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    CARD = out[0].strip()
    print(CARD, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    from tigar_tpu_torch.ops import cuda_ext

    cuda_ext.load()
    say(f"kernel build: {cuda_ext.build_seconds:.1f} s "
        f"({len(cuda_ext.SOURCES) - 1} .cu + bindings.cpp, sm_90a)")
    binding_refusals()

    t0 = time.time()
    ns, mg_sizes = build_solver(NEL, device)
    torch.cuda.synchronize()
    ndof = ns.spline.ndof
    say(f"setup: {time.time() - t0:.2f} s; ndof={ndof}, nel={NEL}^2, "
        f"mg levels={[NEL] + mg_sizes}")

    rec = kernel_phases(ns)
    rec["sumfac_apply"] = sumfac_phases(device)
    # K13/K14 and their profiler session come first of all the sessions
    contact_early(device, rec)
    # phase 13, step 1: K15/K16 at the shell's and the 24^3 Poisson's shapes
    t13 = time.time()
    sf_shell = sf_shell_assembler(ns.spline)
    sf_psp = sf_poisson_spline(SF_NEL3, device)
    from tigar_tpu_torch.ops.sumfac_forms import make_sumfac_assembler
    sf_pasm = make_sumfac_assembler(sf_psp)
    torch.cuda.synchronize()
    say(f"sumfac assemblers: shell {NEL}^2 ({sf_shell.nq_total} points), "
        f"poisson {SF_NEL3}^3 drop 1 ({sf_psp.ndof} DoFs, "
        f"{sf_pasm.nq_total} points): {time.time() - t13:.2f} s")
    sumfac_kernel_phases(device, ns.spline, sf_shell, sf_pasm, rec)
    t13 = time.time() - t13
    # phase 14, step 1: K1, K2's element mode, K10 and K11 at the star
    # T-spline's shapes and on a ragged extraction
    from tigar_tpu_torch.demos import star_tspline_shell as star_demo
    t14 = time.time()
    ns_ts = star_demo.build(TS_NEL, device)
    ts_ragged = star_demo.ragged_spline(device)
    torch.cuda.synchronize()
    say(f"star T-spline setup (make_star_extraction(3, {TS_NEL}), the Rhino "
        f"file written and read back, boundary_dofs, SANewton): "
        f"{time.time() - t14:.2f} s; {ns_ts.spline.ndof} DoFs, "
        f"{ns_ts.asm64.nel} elements; ragged extraction "
        f"{ts_ragged.ndof} DoFs, functions an element "
        f"{sorted(set(ts_ragged._assembler('dx').masks[0].sum(1).long().tolist()))}")
    setup_ts = ts_kernel_phases(ns_ts, ts_ragged, rec)
    t14 = time.time() - t14

    # -- the shell main path: warm steps, then the solve with every launch
    # count reset just before it and read just after -----------------------
    U0 = torch.zeros(ndof, dtype=torch.float64, device=device)
    U1, rn, _ = ns.step(U0)                    # warm-up
    float(rn)
    best = best_of_3(lambda: ns.step(U1))
    say(f"production newton step: best of 3 {best * 1e3:.3f} ms "
        f"({ndof / best:.4e} DoF/s)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    Usol, rel64, nsteps, dU_rel = ns.solve(rtol=1e-10, log=say)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = cuda_ext.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"full solve: {t_solve:.3f} s, {nsteps} steps, f64 rel |r| = "
        f"{rel64:.3e}, |dU|/|U| = {dU_rel:.3e}; peak device memory "
        f"{peak_gb:.3f} GiB")
    say(f"main-path kernel launches: {launches}")
    k3_levels("shell main path")
    tally("shell", ("tangent_stencil",))
    if tuple(Usol.shape) != (ndof,) or not bool(torch.isfinite(Usol).all()):
        raise SystemExit("solution is not finite or has the wrong shape")
    shell_kernels = ("shell_residual", "tangent_stencil", "stencil_apply")
    missing = [k for k in shell_kernels if launches[k] <= 0]
    if missing:
        raise SystemExit(f"main path never launched {missing}")

    # -- floor certificate: the CPU twin of K1 on the same state -----------
    shell_certificate(ns, Usol, rel64, dU_rel)

    # -- the Poisson main path, with every launch count reset ---------------
    pb, _, err96, launches["sumfac_apply"] = poisson_main_path(device)
    by_path = {"shell": {k: launches[k] for k in shell_kernels},
               "poisson": {"sumfac_apply": launches["sumfac_apply"]}}

    # -- the two-patch path: kernels, then the main path with reset counts --
    t0 = time.time()
    ns_tp, cpl, sizes = build_two_patch(device)
    torch.cuda.synchronize()
    setup_tp = time.time() - t0
    say(f"two-patch setup: {setup_tp:.2f} s; ndof={ns_tp.spline.ndof}, "
        f"levels={sizes}, pd={cpl.penalty:g}, pr={cpl.penalty_rot:g}")
    iface_kernel_phases(ns_tp, cpl, rec)
    Utp, rel_tp, dU_tp, l_tp, _ = two_patch_main_path(ns_tp, cpl, sizes,
                                                      setup_tp)
    two_patch_certificate(ns_tp, cpl, Utp, rel_tp, dU_tp)
    tp_kernels = ("iface_block", "shell_iface_residual",
                  "shell_iface_tangent")
    by_path["two_patch"] = {k: l_tp[k] for k in shell_kernels + tp_kernels}
    for k in tp_kernels:
        launches[k] = l_tp[k]

    # -- the two-patch Nitsche path (bench.py's default two-patch point) on
    # the same splines: kernels, then the main path with reset counts ------
    t0 = time.time()
    ns_nit, cpl_nit, _ = build_two_patch(
        device, coupling="nitsche",
        splines=[ns_tp.spline] + list(ns_tp.mg_splines))
    torch.cuda.synchronize()
    setup_nit = time.time() - t0
    say(f"two-patch Nitsche setup (splines shared): {setup_nit:.2f} s; "
        f"beta_d={cpl_nit.params['beta_d']:g}, "
        f"beta_r={cpl_nit.params['beta_r']:g}")
    nitsche_kernel_phases(ns_nit, rec)
    Unit, rel_nit, dU_nit, l_nit, _ = two_patch_nitsche_main_path(
        ns_nit, cpl_nit, sizes, setup_nit)
    two_patch_certificate(ns_nit, cpl_nit, Unit, rel_nit, dU_nit,
                          TP_NITSCHE_FLOOR_REL, "two-patch Nitsche")
    nit_kernels = ("nitsche_iface_residual", "nitsche_iface_tangent")
    by_path["two_patch_nitsche"] = {
        k: l_nit[k] for k in shell_kernels + ("iface_block",) + nit_kernels}
    for k in nit_kernels:
        launches[k] = l_nit[k]

    # -- the SANewton path on the same shell: element tangents (K2's element
    # mode, K10) and the smoothed-aggregation cycle (K11) -----------------
    t0 = time.time()
    ns_sa = sa_solver(ns.spline, ns.adjoint)
    say(f"SANewton setup (spline shared with the shell path): "
        f"{time.time() - t0:.2f} s; options {SA_OPTS}")
    setup_sa = sa_kernel_phases(ns_sa, smooth_state(ns), rec)
    Usa, l_sa, _ = sa_main_path(ns_sa, Usol, setup_sa)
    sa_kernels = ("tangent_elements", "elem_tangent_apply", "ell_spmv")
    by_path["sa_newton"] = {k: l_sa[k]
                            for k in ("shell_residual",) + sa_kernels}
    for k in sa_kernels:
        launches[k] = l_sa[k]

    # -- phase 11: the generic form path (FEniCS-like forms, 256^2 Poisson):
    # K12 under mixed-precision refinement, B9b through K11 --------------
    t0 = time.time()
    gp = generic_path(device, rec)
    say(f"phase 11 (generic form path) took {time.time() - t0:.1f} s")
    by_path.update({f"generic_{k}": v for k, v in gp["launches"].items()})
    launches["laplace_apply"] = gp["launches"]["refine"]["laplace_apply"]
    launches["ell_spmv_twolevel"] = by_path["generic_sa_two_level"][
        "ell_spmv_twolevel"] = gp["launches"]["sa_two_level"]["ell_spmv"]

    # -- phase 13, step 2: the sum-factorized forms' main path -------------
    t0 = time.time()
    by_path["sumfac_forms"] = sumfac_forms_path(device, ns.spline, sf_shell,
                                                sf_psp, sf_pasm)
    launches.update(by_path["sumfac_forms"])
    t13 += time.time() - t0

    # -- phase 14, step 2: the star-T-spline point (bench._tspline_point)
    # through the demo's entry point, counts reset around its solve -------
    t0 = time.time()
    _, l_ts, _ = ts_main_path(ns_ts, setup_ts)
    by_path["star_tspline"] = {
        k: l_ts[k] for k in ("shell_residual", "tangent_elements",
                             "elem_tangent_apply", "ell_spmv")}
    for k, kk in zip(("shell_residual", "tangent_elements",
                      "elem_tangent_apply", "ell_spmv"),
                     ("shell_residual_bicubic",) + TS_KEYS):
        launches[kk] = by_path["star_tspline"][kk] = l_ts[k]
    del ns_ts
    t14 += time.time() - t0


    # -- where the time goes (after the main paths' counts) -----------------
    kernel_device_times(rec)
    best_polish = best_of_3(lambda: ns.polish_step(U1))
    say(f"polish step (frozen stencils): best of 3 "
        f"{best_polish * 1e3:.3f} ms")
    profile_steps(ns, U1, {"production step": best,
                           "polish step": best_polish})
    tp_step = best_of_3(lambda: ns_tp.step(Utp))
    tp_polish = best_of_3(lambda: ns_tp.polish_step(Utp))
    say(f"two-patch steps at the solution: production (f32) best of 3 "
        f"{tp_step * 1e3:.3f} ms, polish (frozen operators) "
        f"{tp_polish * 1e3:.3f} ms")
    say("two-patch profile:")
    profile_steps(ns_tp, Utp, {"production step": tp_step,
                               "polish step": tp_polish})
    nit_step = best_of_3(lambda: ns_nit.step(Unit))
    nit_polish = best_of_3(lambda: ns_nit.polish_step(Unit))
    say(f"two-patch Nitsche steps at the solution: production (f32) best "
        f"of 3 {nit_step * 1e3:.3f} ms, polish (frozen operators) "
        f"{nit_polish * 1e3:.3f} ms")
    say("two-patch Nitsche profile:")
    profile_steps(ns_nit, Unit, {"production step": nit_step,
                                 "polish step": nit_polish})
    sa_step = best_of_3(lambda: ns_sa.step(Usa))
    sa_polish = best_of_3(lambda: ns_sa.polish_step(Usa))
    say(f"SANewton steps at the solution: production (f32) best of 3 "
        f"{sa_step * 1e3:.3f} ms, polish (frozen tangents and hierarchy) "
        f"{sa_polish * 1e3:.3f} ms")
    say("SANewton profile:")
    profile_steps(ns_sa, Usa, {"production step": sa_step,
                               "polish step": sa_polish})
    profile_refine_sweep(gp)

    # -- phase 12: penalty self-contact, the reef-knot demo at 96^2, after
    # the other phases' profiler sessions, which so run before any of its
    # CUDA graphs exists ---------------------------------------------------
    t0 = time.time()
    by_path["reef_knot"] = reef_knot_path(device, rec)
    launches.update(by_path["reef_knot"])
    say(f"phase 12 (reef-knot contact path) took {time.time() - t0:.1f} s")

    # -- small-input reference: card against the CPU twins ----------------
    ns_g, _ = build_solver(8, device, cg_iters=40)
    ns_c, _ = build_solver(8, "cpu", cg_iters=40)
    Ug, relg, itg, _ = ns_g.solve(rtol=1e-9)
    Uc, relc, itc, _ = ns_c.solve(rtol=1e-9)
    err = float((Ug.cpu() - Uc).abs().max() / Uc.abs().max())
    say(f"small-input reference (nel=8): card {itg} steps rel {relg:.3e}, "
        f"CPU twins {itc} steps rel {relc:.3e}, max rel diff of U {err:.3e}")
    if not (err <= 1e-8 and relg <= 1e-9 and abs(itg - itc) <= 1):
        raise SystemExit("small-input reference FAILED")

    two_patch_reference(device)
    two_patch_reference(device, "nitsche")
    sa_reference(device)
    generic_reference(device)
    t0 = time.time()
    sumfac_reference(device)
    t13 += time.time() - t0
    say(f"phase 13 (sum-factorized forms) took {t13:.1f} s")
    t0 = time.time()
    ts_reference(device)
    t14 += time.time() - t0
    say(f"phase 14 (star T-spline) took {t14:.1f} s")

    poisson_checks(device, pb, err96)

    src = {"shell_residual": ("tigar_tpu_torch/csrc/shell_residual.cu",
                              "tigar_tpu/ops/assembly.py:342"),
           "tangent_stencil": ("tigar_tpu_torch/csrc/tangent_stencil.cu",
                               "tigar_tpu/ops/assembly.py:349"),
           "stencil_apply": ("tigar_tpu_torch/csrc/stencil_apply.cu",
                             "tigar_tpu/ops/stencil.py:73"),
           "sumfac_apply": ("tigar_tpu_torch/csrc/sumfac_apply.cu",
                            "tigar_tpu/ops/sumfac.py:208"),
           "iface_block": ("tigar_tpu_torch/csrc/iface_block.cu",
                           "tigar_tpu/solvers/newton_stencil_mp.py:85"),
           "shell_iface_residual": (
               "tigar_tpu_torch/csrc/shell_interface.cu",
               "tigar_tpu/interface.py:711"),
           "shell_iface_tangent": ("tigar_tpu_torch/csrc/shell_interface.cu",
                                   "tigar_tpu/interface.py:684"),
           "nitsche_iface_residual": ("tigar_tpu_torch/csrc/shell_nitsche.cu",
                                      "tigar_tpu/interface.py:711"),
           "nitsche_iface_tangent": ("tigar_tpu_torch/csrc/shell_nitsche.cu",
                                     "tigar_tpu/interface.py:684"),
           "tangent_elements": ("tigar_tpu_torch/csrc/tangent_stencil.cu",
                                "tigar_tpu/solvers/newton_sa.py:297"),
           "elem_tangent_apply": ("tigar_tpu_torch/csrc/elem_tangent.cu",
                                  "tigar_tpu/solvers/newton_sa.py:132"),
           "ell_spmv": ("tigar_tpu_torch/csrc/ell_spmv.cu",
                        "tigar_tpu/solvers/aggregation.py:356"),
           "laplace_apply": ("tigar_tpu_torch/csrc/laplace_apply.cu",
                             "tigar_tpu/ops/fastpath.py:57"),
           "ell_spmv_twolevel": ("tigar_tpu_torch/csrc/ell_spmv.cu",
                                 "tigar_tpu/solvers/aggregation.py:113"),
           "contact_residual": ("tigar_tpu_torch/csrc/contact_pairs.cu",
                                "tigar_tpu/contact.py:205"),
           "contact_tangent": ("tigar_tpu_torch/csrc/contact_pairs.cu",
                               "tigar_tpu/contact.py:210"),
           "sumfac_jets": ("tigar_tpu_torch/csrc/sumfac_jets.cu",
                           "tigar_tpu/ops/sumfac_forms.py:189"),
           "sumfac_scatter_jets": ("tigar_tpu_torch/csrc/sumfac_jets.cu",
                                   "tigar_tpu/ops/sumfac_forms.py:319"),
           "shell_residual_bicubic": (
               "tigar_tpu_torch/csrc/shell_residual.cu",
               "tigar_tpu/ops/assembly.py:342"),
           "tangent_elements_bicubic": (
               "tigar_tpu_torch/csrc/tangent_stencil.cu",
               "tigar_tpu/solvers/newton_sa.py:297"),
           "elem_tangent_apply_nloc48": (
               "tigar_tpu_torch/csrc/elem_tangent.cu",
               "tigar_tpu/solvers/newton_sa.py:132"),
           "ell_spmv_star": ("tigar_tpu_torch/csrc/ell_spmv.cu",
                             "tigar_tpu/solvers/aggregation.py:356")}
    # times at the main paths' shapes: K1 f32, K2 f32 at the reduced rule,
    # K3 f32 Jacobi sweep on the fine grid, K4 f32 at the V-cycle's fine
    # level (336 of the solve's 357 launches)
    pick = {"shell_residual": "f32", "tangent_stencil": f"nq={ns.asm_b32.nq}",
            "stencil_apply": "jacobi f32 fine",
            "sumfac_apply": f"f32 {NEL3}^3", "iface_block": "f32",
            "shell_iface_residual": "f32", "shell_iface_tangent": "f32",
            "nitsche_iface_residual": f"f32 nq={cpl_nit.wq.numel()}",
            "nitsche_iface_tangent": f"f32 nq={cpl_nit.wq.numel()}",
            "tangent_elements": f"f32 nq={ns_sa.asm_b32.nq}",
            "elem_tangent_apply": "masked f32",
            "ell_spmv": "P apply f32 level 0",
            "laplace_apply": f"2D p=2 nel={GP_NEL}",
            "ell_spmv_twolevel": "A jacobi f32 two-level",
            "contact_residual": "f64 (a)", "contact_tangent": "f32 (a)",
            "sumfac_jets": f"f64 shell fields {NEL}^2",
            "sumfac_scatter_jets": f"f64 shell fields {NEL}^2",
            "shell_residual_bicubic": "f64 nq=16 nen=16 star",
            "tangent_elements_bicubic": "f32 nq=9 star",
            "elem_tangent_apply_nloc48": "masked f32",
            "ell_spmv_star": "P apply f32 level 0"}
    kernels = []
    for name, phases in rec.items():
        timed = [p for p in phases if pick[name] in p["name"]][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": max(p["abs"] for p in phases),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed.get("library_ms"),
            "device_ms": timed.get("dev_ms"),
            "library_device_ms": timed.get("library_dev_ms"),
            "launches_by_path": {p: c[name] for p, c in by_path.items()
                                 if name in c},
            "launches_by_key": {p: t[name] for p, t in TALLIES.items()
                                if name in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
