#!/usr/bin/env python3
"""GPU smoke run of tigar_tpu_torch: the production Newton path of the
clamped SVK Kirchhoff-Love shell on one NVIDIA card.

    python3 chip_smoke.py

Problem (as tigar_tpu's bench._build_solver): 128x128 biquadratic
elements, 3 displacement fields, 3*130^2 = 50,700 DoFs, load q=100,
E=1e7, nu=0.3, h=0.03, multigrid levels 64^2, 32^2, 16^2, 8^2; options
cg_iters=15, build_quad_degree=2, rebuild_rel=0.1, polish_tangent="cast".

Phases, each fatal on failure (nothing is caught):
  1. build the three CUDA kernels from tigar_tpu_torch/csrc;
  2. per kernel, at the main path's shapes and a seeded smooth state
     (displacement ~0.1): kernel against its plain PyTorch twin on the card
     (max relative error; tolerance f64 1e-12, f32 1e-4 on stencils and
     1e-5 elsewhere) and both times;
  3. the main path with every launch count reset: one production step
     after a warm-up (best of 3) and the full solve to rtol=1e-10;
  4. the floor certificate: the final f64 residual against the CPU twin of
     the residual kernel on the same state (rel64 <= 3 cpu_rel,
     rel64 <= 1e-8, |dU|/|U| <= 1e-10; or rel64 <= 1e-10);
  5. a small-input reference: the nel=8 solve on the card against the
     same solve through the CPU twins.
  6. where the time goes: a polish step timed like the production step,
     then a torch.profiler trace of one production and one polish step
     (device time by kernel, the device's busy share of the step).
Every launch counter of the main path (phase 3) must be positive.  The
next-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device the script
raises.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

E_MOD, NU, H_TH, Q = 1.0e7, 0.3, 0.03, 100.0
NEL = 128
TOL = {"f64": 1e-12, "f32": 1e-5, "f32_stencil": 1e-4}

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


def compare(name, kernel, twin, tol, reps, twin_reps, record):
    """Kernel against twin on the same inputs: errors, times, the gate."""
    yk = kernel()
    yt = twin()
    torch.cuda.synchronize()
    if tuple(yk.shape) != tuple(yt.shape) or not bool(
            torch.isfinite(yk).all()):
        raise SystemExit(f"{name}: kernel output is not finite or has the "
                         f"wrong shape {tuple(yk.shape)}")
    abs_err = float((yk - yt).abs().max())
    rel = abs_err / float(yt.abs().max())
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(twin, twin_reps)
    say(f"phase {name}: max rel err {rel:.3e} (tol {tol:g}), max abs err "
        f"{abs_err:.3e}, kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    if not rel <= tol:
        raise SystemExit(f"phase {name} FAILED: rel err {rel:.3e} > {tol:g}")
    record.append(dict(name=name, rel=rel, abs=abs_err, ms=ms,
                       plain_ms=plain_ms))


def kernel_phases(ns):
    from tigar_tpu_torch.ops.assembly import residual_vector_adjoint_ref
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
        compare(f"K1 shell_residual {tag} nq={asm.nq}",
                lambda a=asm, u=U: a.residual_vector_adjoint(dens, u),
                lambda a=asm, u=U: residual_vector_adjoint_ref(a, dens, u),
                tol, 20, 3, rec["shell_residual"])

    basis = ns.basis
    for asm in (ns.asm_b32, ns.asm32):
        compare(f"K2 tangent_stencil f32 nq={asm.nq}",
                lambda a=asm: build_stencil(a, dens, U32, basis, 3).S,
                lambda a=asm: build_stencil_ref(a, dens, U32, basis, 3).S,
                TOL["f32_stencil"], 5, 1, rec["tangent_stencil"])

    st_fine = build_stencil(ns.asm_b32, dens, U32, basis, 3)
    levels = [("fine", st_fine, ns.mask32),
              ("coarse", ns._coarse_sts[1], ns._coarse_masks[1])]
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
                compare(f"K3 stencil_apply {mode} {tag} {lname} "
                        f"grid={st.grid_shape}",
                        lambda s=st, kw=kw, x=x: stencil_apply(s, x, **kw),
                        lambda s=st, kw=kw, x=x: stencil_apply_ref(s, x,
                                                                   **kw),
                        tol, 50, 10, rec["stencil_apply"])
    return rec


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
    """torch.profiler trace of one production step and one polish step at
    state U; prints device time by kernel and the device's busy share of
    the un-profiled step wall time ``step_s``.  Only device-side events
    (kernels, copies, memsets) are summed: the CPU op rows of key_averages
    carry the device time of the kernels they launch, which appear as rows
    of their own (the rule of the profiler's own table footer)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    runs = (("production step", lambda: ns.step(U)),
            ("polish step", lambda: ns.polish_step(U)))
    for label, fn in runs:
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
        say(f"profile {label}: device busy {dev_ms:.3f} ms of {ref:.3f} ms "
            f"un-profiled wall (busy share {dev_ms / ref:.3f}); "
            f"profiled wall {wall * 1e3:.3f} ms; {sum(r[1] for r in rows)} "
            f"device ops")
        for key, count, us in sorted(rows, key=lambda r: -r[2])[:10]:
            say(f"    {us / 1e3:9.3f} ms  {us / 1e3 / dev_ms:6.3f} of busy  "
                f"{count:6d} x  {key[:90]}")


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
    from tigar_tpu_torch.ops.assembly import residual_vector_adjoint_ref

    cuda_ext.load()
    say(f"kernel build: {cuda_ext.build_seconds:.1f} s "
        f"(3 .cu + bindings.cpp, sm_90a)")

    t0 = time.time()
    ns, mg_sizes = build_solver(NEL, device)
    torch.cuda.synchronize()
    ndof = ns.spline.ndof
    say(f"setup: {time.time() - t0:.2f} s; ndof={ndof}, nel={NEL}^2, "
        f"mg levels={[NEL] + mg_sizes}")

    rec = kernel_phases(ns)

    # -- the main path, with every launch count reset ------------------------
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.reset_counts()
    U0 = torch.zeros(ndof, dtype=torch.float64, device=device)
    U1, rn, _ = ns.step(U0)                    # warm-up
    float(rn)
    best = best_of_3(lambda: ns.step(U1))
    say(f"production newton step: best of 3 {best * 1e3:.3f} ms "
        f"({ndof / best:.4e} DoF/s)")

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
    if tuple(Usol.shape) != (ndof,) or not bool(torch.isfinite(Usol).all()):
        raise SystemExit("solution is not finite or has the wrong shape")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"main path never launched {missing}")

    # -- floor certificate: the CPU twin of K1 on the same state -----------
    r0_64 = ns.true_rel_residual(torch.zeros_like(Usol))
    asm_cpu = ns.asm64.to("cpu")
    r_cpu = ns.mask64.cpu() * residual_vector_adjoint_ref(
        asm_cpu, ns.adjoint, Usol.cpu())
    cpu_rel = float(torch.linalg.norm(r_cpu)) / r0_64
    floor_ok = bool(rel64 <= 3.0 * max(cpu_rel, 1e-16) and rel64 <= 1e-8
                    and dU_rel <= 1e-10)
    f64_ok = bool(rel64 <= 1e-10) or floor_ok
    say(f"floor certificate: rel64 {rel64:.3e}, CPU-twin f64 rel "
        f"{cpu_rel:.3e}, |dU|/|U| {dU_rel:.3e}: floor_certified={floor_ok}, "
        f"f64_accurate={f64_ok}")
    if not f64_ok:
        raise SystemExit("floor certificate FAILED")

    # -- where the time goes (after the main path's counts) ----------------
    best_polish = best_of_3(lambda: ns.polish_step(U1))
    say(f"polish step (frozen stencils): best of 3 "
        f"{best_polish * 1e3:.3f} ms")
    profile_steps(ns, U1, {"production step": best,
                           "polish step": best_polish})

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

    src = {"shell_residual": ("tigar_tpu_torch/csrc/shell_residual.cu",
                              "tigar_tpu/ops/assembly.py:342"),
           "tangent_stencil": ("tigar_tpu_torch/csrc/tangent_stencil.cu",
                               "tigar_tpu/ops/assembly.py:349"),
           "stencil_apply": ("tigar_tpu_torch/csrc/stencil_apply.cu",
                             "tigar_tpu/ops/stencil.py:73")}
    # times at the production step's shapes: K1 f32, K2 f32 at the reduced
    # rule, K3 f32 Jacobi sweep on the fine grid
    pick = {"shell_residual": "f32", "tangent_stencil": f"nq={ns.asm_b32.nq}",
            "stencil_apply": "jacobi f32 fine"}
    kernels = []
    for name, phases in rec.items():
        timed = [p for p in phases if pick[name] in p["name"]][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": max(p["abs"] for p in phases),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
