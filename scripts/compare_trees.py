#!/usr/bin/env python3
"""Times a set of kernels and main paths for one checkout of
tigar_tpu_torch on one CUDA card, so that two versions of the port can be
timed in turns on one card:

    python scripts/compare_trees.py \
        --what k12_k5|shell|k10_k3|k11_k16|k2_k4|k14_k9 \
        --tree DIR --label NAME [--out FILE]

imports ``tigar_tpu_torch`` from DIR (its kernels build into DIR/build)
and the measuring code from this repository's ``chip_smoke.py``, and
prints one JSON line, also appended to FILE.  Kernel ms: CUDA events over
the calls, wrapper included; device ms: torch.profiler, every device
event of the call, None unless sessions of 10 and of the timed calls
record the same whole number a call (K10: its two kernels, from up to
three sessions that record every launch).  Without a CUDA device it
raises.

``--what k12_k5``: K12 (the f32 fast-path Laplace apply) through
``make_laplace_operator`` on the generic Poisson at 2D p=2 256^2, 2D p=3
32^2 and 3D p=2 16^3, beside the same BC'd operator as one f32
torch.sparse CSR matrix; K5 (the dense interface block apply) through
``iface_block_apply`` on the fine interface block of the two-patch
penalty operator (m = 2,376) at chip_smoke's seeded state, f64 and f32,
accumulating into one buffer, beside ``torch.mv`` on the pre-gathered
vector; then the two-patch penalty and Nitsche main paths (best of 3 warm
f32 steps, the full solve).

``--what shell``: K1 (the SVK shell residual) and K2 (the tangent stencil
build and its element mode) on the biquadratic 128^2 shell of
``build_solver`` at its seeded smooth state, as chip_smoke.py's phases 2
and 10: K1 through ``residual_vector_adjoint`` (f32, f64; 9 points); K2
through ``build_stencil`` (f32 at 4 and 9 points) and its element mode
through ``element_matrices_adjoint`` with the BC mask at the connectivity
(f32, f64; 4 points).

``--what k10_k3``: K3 (the stencil apply) on every grid the shell's
V-cycle smooths (130^2, 66^2, 34^2, 18^2; f32, every mode, and the f64
fine apply) and on each patch of the two-patch shell's smoothed levels
(in place, f32, every mode), each apply beside the same BC'd operator as
one f32 torch.sparse CSR matrix; K10 (the element-batch tangent apply)
on the BC'd f32 and f64 tangents of the 128^2 shell's SANewton path and
of the star T-spline (nel 48), beside the same operator as one CSR
matrix, with E's max |E - E^T| / max |E|; every kernel with its bound
(chip_smoke.py's ``bound``).  Then each path through them: the shell
(StencilNewton), the two-patch penalty and Nitsche shells, the 128^2
shell through SANewton and the star: warm step times, the full solve and
the device's busy share of a production and a polish step
(chip_smoke.py's ``profile_steps``), and K3's launches by grid.

``--what k11_k16``: first, each part in a fresh process of its own
(``--what k11_k16_part --part NAME``: later profiler sessions of a
process drop launches), K11 (the SA levels' ELL products) on every level
of the f32 SA hierarchies of the 128^2 shell's SANewton path and of the
star T-spline (nel 48) at chip_smoke.py's seeded states, and on the two-
level cycle of the 128^2 generic Poisson, in the modes the cycles run
(the Jacobi sweep, the residual, the first sweep from x = 0, the coarse
correction x + P z, Pt's product; a tree without the fused modes runs
them as its cycle does, with their elementwise launches) and in the
plain apply, each with n, K, its fill, its bounds by the bytes of the
nonzeros and of the tree's layout, and the same matrix as one
torch.sparse CSR product; one V-cycle of each hierarchy (ms, busy device
ms, launches by kernel); then K16 (the sum-factorized jets' transpose)
on the 24^3 drop-1 Poisson field and the 128^2 shell's fields (f64, f32)
beside J^T @ F as one CSR product and the byte bound; the sumfac
residual's best of 3 at 128^2 (f64, f32) and 24^3 (f64); then the
SANewton 128^2 and star paths as ``k10_k3``.

``--what k2_k4``: first, each part in a fresh process of its own
(``--what k2_k4_part --part NAME``), K2 (the SVK shell tangent) at every
mode, type and point count its paths build: the 128^2 shell's stencil
builds (f32 at 4 and 9 points, f64 at 4) and its element mode with the BC
mask at the connectivity (f32, f64; 4 points), each patch of the
two-patch shell (f32 builds and f64 polish tangents; 4 points), the star
T-spline's element mode (nel 48, 16 local functions a field; f32 and f64
at 9 and 16 points), at chip_smoke.py's seeded states, each with the
device ms of every device event of a call (the stencil mode's fold and
memset included) and its operations or bytes bound; K4 (the
sum-factorized apply) on every grid of the 96^3 Poisson hierarchy
(96^3 ... 6^3) in f32 and f64, device ms of every device event of a call,
beside the same BC'd operator as one torch.sparse CSR matrix of the same
type and the operations bound.  Then the paths through them: as
``k10_k3``'s (the shell, the two-patch penalty and Nitsche shells, the
128^2 shell through SANewton and the star), and the 96^3 Poisson MG-CG
solve (cold and warm, the relative residual, the L2 error, the busy share
of a warm solve and K4's device ms in it), with K2's and K4's launches by
key on each path (``chip_smoke.tally``; empty from a tree whose wrappers
give no key).

``--what k14_k9``: first, each part in a fresh process of its own
(``--what k14_k9_part --part NAME``), K13 and K14 (the contact forces and
tangent action) in f64 and f32 on the reef-knot demo's 9,604 points at
state (a) (``chip_smoke.RK_ACTIVE``, U and W as ``contact_early``) and
at state (b) (the demo's own contact at the state after its first step,
which part "reef knot" takes and saves under the tree's build/), each
with its live and interacting pairs and, from a tree that culls, the
tile pairs the cull keeps and the live pairs in them, its bound from
the tree's mask layout; the reef-knot demo's step (wall, residual
evaluations, K13 / K14 launches by key); K9 (the Nitsche interface
tangent block) in f64 and f32 on the interfaces of the two-patch
Nitsche solver's three levels (768, 384 and 192 points) at
``chip_smoke``'s seeded states.  Device ms of every device event of a
call, and of the kernels' own launches alone.  Then the two-patch
Nitsche solve (steps, seconds, K9's launches by key).
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k12_k5(cs, dev, timed):
    import torch
    from tigar_tpu_torch.ops import fastpath
    from tigar_tpu_torch.solvers.newton_stencil_mp import iface_block_apply
    out = {"k12": {}, "k5": {}}
    g = torch.Generator().manual_seed(21)
    for label, nel, p, dim in (("2D p=2 256^2", 256, 2, 2),
                               ("2D p=3 32^2", 32, 3, 2),
                               ("3D p=2 16^3", 16, 2, 3)):
        sp = cs.gp_spline(nel, dev, p, dim)
        op = fastpath.make_laplace_operator(sp._assembler("dx"), sp.mask)
        W = torch.randn(sp.ndof, generator=g,
                        dtype=torch.float64).to(dev).float()
        y = op(W)
        A = sp.assemble_sparse(cs.gp_a).to(torch.float32).to_sparse_csr()
        out["k12"][label] = {
            **timed(lambda: op(W), 200),
            "csr": timed(lambda: torch.mv(A, W), 200),
            "csr_rel_diff": cs.rel_diff(torch.mv(A, W), y),
            "ndof": sp.ndof}

    t0 = time.perf_counter()
    ns, cpl, sizes = cs.build_two_patch(dev)
    setup_s = time.perf_counter() - t0
    U64 = cs.mp_smooth_state(ns)
    for tag, op in (("f64", ns._build(ns.asm_b64, U64)),
                    ("f32", ns._build(ns.asm_b32, U64.float()))):
        B, idx = op.ifaces[0].K, op.ifaces[0].idx
        mk = ns.mask64.to(B.dtype)
        v = torch.randn(ns.spline.ndof, generator=g,
                        dtype=torch.float64).to(dev, B.dtype)
        acc = torch.zeros_like(v)
        vs = v[idx.long()]
        out["k5"][tag] = {
            "m": idx.numel(),
            **timed(lambda B=B, idx=idx, v=v, o=acc, mk=mk:
                    iface_block_apply(B, idx, v, o, mk, 1.0), 200),
            "mv": timed(lambda B=B, vs=vs: torch.mv(B, vs), 200)}

    *_, out["two_patch_penalty"] = cs.two_patch_main_path(ns, cpl, sizes,
                                                           setup_s)
    splines = [ns.spline, *ns.mg_splines]
    t0 = time.perf_counter()
    ns, cpl, sizes = cs.build_two_patch(dev, coupling="nitsche",
                                        splines=splines)
    *_, out["two_patch_nitsche"] = cs.two_patch_nitsche_main_path(
        ns, cpl, sizes, time.perf_counter() - t0)
    return out


def shell(cs, dev, timed):
    from tigar_tpu_torch.ops.stencil import build_stencil
    out = {}
    ns, _ = cs.build_solver(cs.NEL, dev)
    dens = ns.adjoint
    U64 = cs.smooth_state(ns)
    U32 = U64.float()
    for tag, asm, U in (("f32", ns.asm32, U32), ("f64", ns.asm64, U64)):
        out[f"K1 {tag} nq={asm.nq}"] = timed(
            lambda a=asm, u=U: a.residual_vector_adjoint(dens, u), 200)
    for asm in (ns.asm_b32, ns.asm32):
        out[f"K2 stencil f32 nq={asm.nq}"] = timed(
            lambda a=asm: build_stencil(a, dens, U32, ns.basis, 3), 50)
    me64 = ns.spline.mask[ns.asm_b64.cat_conn]
    for tag, asm, U in (("f32", ns.asm_b32, U32), ("f64", ns.asm_b64, U64)):
        me = me64.to(U.dtype)
        out[f"K2 elements {tag} nq={asm.nq}"] = timed(
            lambda a=asm, u=U, me=me: a.element_matrices_adjoint(
                dens, u, me=me), 50)
    return out


def k10_k3_kernels(cs, dev, timed):
    """K3 at every grid the V-cycles smooth and K10 at both SANewton
    paths, each beside its bound and its library yardstick."""
    import numpy as np
    import torch
    from tigar_tpu_torch.demos import star_tspline_shell as star_demo
    from tigar_tpu_torch.ops import sparse
    from tigar_tpu_torch.ops.stencil import build_stencil, stencil_apply
    out = {"k3": {}, "k10": {}}
    g = torch.Generator().manual_seed(31)

    def rnd(n, dt):
        return torch.randn(n, generator=g, dtype=torch.float64).to(dev, dt)

    def k3(key, st, m, modes, patch=None):
        dt = st.S.dtype
        n = m.numel()
        x, b = rnd(n, dt), rnd(n, dt)
        dinv = 1.0 / (m * rnd(n, dt).abs().add(1.0))
        kw = {} if patch is None else dict(out=torch.empty_like(x),
                                          base=patch[0], fstride=patch[1])
        for mode in modes:
            r = timed(lambda mode=mode: stencil_apply(
                st, x, m, b, dinv, 0.7, mode, **kw), 200)
            r["bound_ms"], r["bound_by"] = cs.bound(*cs.stencil_work(st,
                                                                     mode))
            if mode == "apply" and patch is None and dt == torch.float32:
                A = cs.stencil_csr(st, m)
                r["csr"] = timed(lambda: torch.mv(A, x), 200)
            out["k3"][f"{key} {mode}"] = r

    # the shell's smoothed V-cycle levels (f32) and its f64 fine apply
    ns, _ = cs.build_solver(cs.NEL, dev)
    U64 = cs.smooth_state(ns)
    st = build_stencil(ns.asm_b32, ns.adjoint, U64.float(), ns.basis, 3)
    levels = [(st, ns.mask32)] + list(zip(ns._coarse_sts[:-1],
                                          ns._coarse_masks[:-1]))
    for st, m in levels:
        k3("shell {}x{} f32".format(*st.grid_shape), st, m,
           ("apply", "residual", "jacobi"))
    k3("shell {}x{} f64".format(*levels[0][0].grid_shape),
       levels[0][0].astype(torch.float64), ns.mask64, ("apply",))

    # the two-patch shell's smoothed levels, each patch in place (f32)
    ns_tp, _, _ = cs.build_two_patch(dev)
    op = ns_tp._build(ns_tp.asm_b32, cs.mp_smooth_state(ns_tp).float())
    for op, m in [(op, ns_tp.mask32)] + list(zip(ns_tp._coarse_sts[:-1],
                                                 ns_tp._coarse_masks[:-1])):
        for p, st in enumerate(op.sts):
            k3("two-patch {}x{} f32".format(*st.grid_shape), st, m,
               ("apply", "residual", "jacobi"),
               (op.doffsets[p], op.doffsets[-1]))

    # K10's BC'd apply on the f32 and f64 tangents of both SANewton paths
    ns_sa = cs.sa_solver(ns.spline, ns.adjoint)
    ns_ts = star_demo.build(cs.TS_NEL, dev)
    rng = np.random.default_rng(0)
    U_star = ns_ts.mask64 * torch.as_tensor(
        rng.normal(size=ns_ts.spline.ndof) * 1e-3, device=dev)
    for label, s, U in (("128^2", ns_sa, U64), ("star", ns_ts, U_star)):
        for dt in (torch.float32, torch.float64):
            tag = "f32" if dt == torch.float32 else "f64"
            st = s._build(s.asm_b32 if tag == "f32" else s.asm_b64,
                          U.to(dt))
            E = st.E
            m = s.mask64.to(dt)
            x = rnd(st.ndof, dt)
            r = timed(lambda st=st, x=x, m=m: sparse.elem_tangent_apply(
                st.conn, st.E, x, m), 200, "elem_", 2)
            r["bound_ms"], r["bound_by"] = cs.bound(*cs.elem_work(st))
            A = cs.elem_csr(st, m)
            r["csr"] = timed(lambda A=A, x=x: A @ x, 200)
            r["asym"] = float((E - E.transpose(1, 2)).abs().max()
                              / E.abs().max())
            r["nel"], r["nloc"] = st.conn.shape
            out["k10"][f"{label} {tag}"] = r
    return out


def _steps(cs, ns, U, step_s, polish_s):
    """A production and a polish step at U: their wall times and the
    device's busy share of each (None where nothing was recorded)."""
    busy = cs.profile_steps(ns, U, {"production step": step_s,
                                    "polish step": polish_s})
    return dict(busy_step_ms=step_s * 1e3, polish_ms=polish_s * 1e3,
                busy_production=busy.get("production step"),
                busy_polish=busy.get("polish step"))


def sa_paths(cs, dev, ns, Usol):
    """The 128^2 shell through SANewton, its U held to the stencil
    solution ``Usol`` of ``ns``'s problem, and the star T-spline through
    the demo's entry point: warm step times, the full solve and the busy
    shares of their steps (the host SA setups are timed inside the solves,
    not apart: nan)."""
    from tigar_tpu_torch.demos import star_tspline_shell as star_demo
    out = {}
    ns_sa = cs.sa_solver(ns.spline, ns.adjoint)
    Usa, _, times = cs.sa_main_path(ns_sa, Usol, float("nan"))
    out["sa_newton"] = dict(**times, **_steps(
        cs, ns_sa, Usa, cs.best_of_3(lambda: ns_sa.step(Usa)),
        cs.best_of_3(lambda: ns_sa.polish_step(Usa))))
    del ns_sa
    ns_ts = star_demo.build(cs.TS_NEL, dev)
    run, _, Uts = cs.ts_main_path(ns_ts, float("nan"))
    out["star"] = dict(
        step_ms=run["step32_s"] * 1e3, solve_s=run["solve_s"],
        steps=run["steps"], rel64=run["rel64"],
        sa_setup_s=sum(run["sa_setup_s"]),
        **_steps(cs, ns_ts, Uts, cs.best_of_3(lambda: ns_ts.step(Uts)),
                 cs.best_of_3(lambda: ns_ts.polish_step(Uts))))
    return out


def shell_solution(cs, dev):
    """The 128^2 shell's StencilNewton solver, its warm step, solve and
    solution."""
    import torch
    ns, _ = cs.build_solver(cs.NEL, dev)
    U1, rn, _ = ns.step(torch.zeros(ns.spline.ndof, dtype=torch.float64,
                                    device=dev))
    float(rn)
    step_s = cs.best_of_3(lambda: ns.step(U1))
    t0 = time.perf_counter()
    Usol, rel64, nsteps, _ = ns.solve(rtol=1e-10)
    torch.cuda.synchronize()
    return ns, U1, step_s, Usol, dict(step_ms=step_s * 1e3,
                                      solve_s=time.perf_counter() - t0,
                                      steps=nsteps, rel64=rel64)


def k10_k3_paths(cs, dev):
    """The paths through K3 and K10: each one's warm step times, its full
    solve (steps, seconds) and the device's busy share of its steps."""
    from tigar_tpu_torch.ops import cuda_ext
    out = {}

    # the shell (StencilNewton)
    cuda_ext.reset_counts()
    ns, U1, step_s, Usol, rec = shell_solution(cs, dev)
    levels = cs.k3_levels("shell")
    cs.tally("shell", ("tangent_stencil",))
    polish_s = cs.best_of_3(lambda: ns.polish_step(U1))
    out["shell"] = dict(**rec, k3_by_grid=levels,
                        **_steps(cs, ns, U1, step_s, polish_s))

    # the two-patch shell, penalty and Nitsche couplings
    t0 = time.perf_counter()
    ns_tp, cpl, sizes = cs.build_two_patch(dev)
    Utp, rel, _, _, times = cs.two_patch_main_path(
        ns_tp, cpl, sizes, time.perf_counter() - t0)
    out["two_patch_penalty"] = dict(
        rel64=rel, **times, **_steps(cs, ns_tp, Utp,
                                     cs.best_of_3(lambda: ns_tp.step(Utp)),
                                     cs.best_of_3(
                                         lambda: ns_tp.polish_step(Utp))))
    t0 = time.perf_counter()
    ns_nit, cpl_nit, _ = cs.build_two_patch(
        dev, coupling="nitsche", splines=[ns_tp.spline, *ns_tp.mg_splines])
    Unit, rel, _, _, times = cs.two_patch_nitsche_main_path(
        ns_nit, cpl_nit, sizes, time.perf_counter() - t0)
    out["two_patch_nitsche"] = dict(
        rel64=rel, **times, **_steps(cs, ns_nit, Unit,
                                     cs.best_of_3(lambda: ns_nit.step(Unit)),
                                     cs.best_of_3(
                                         lambda: ns_nit.polish_step(Unit))))
    del ns_tp, ns_nit
    out.update(sa_paths(cs, dev, ns, Usol))
    return out


def k10_k3(cs, dev, timed):
    out = k10_k3_kernels(cs, dev, timed)
    out.update(k10_k3_paths(cs, dev))
    return out


def launches_per_call(fn, reps=5):
    """{kernel name: launches a call} of ``fn`` (torch.profiler,
    device-side kernels), None where a count is not a whole number."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    import torch
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            k = e.key[:60]
            out[k] = out.get(k, 0) + e.count / reps
    return {k: (v if v == int(v) else None) for k, v in out.items()}


def k11_records(cs, timed, sparse, new, label, levels, ops, n_coarse, g):
    """K11 on one SA hierarchy (or the two-level operator) of a tree: each
    level's (A, P, Pt) in the modes its cycle runs and in the plain
    apply, with the one PyTorch call of the same function where there is
    one (``chip_smoke.ELL_LIBRARY`` on the CSR matrix: ``@``, addmv) as
    "csr"; ``ops`` the tree's EllOperators (None in a tree without
    them)."""
    import torch
    out = {}
    sizes = [int(lv[2].shape[0]) for lv in levels] + [int(n_coarse)]
    use = {"A": ("apply", "jacobi", "residual", "jacobi0"),
           "P": ("apply", "add"), "Pt": ("apply",)}
    for l, lv in enumerate(levels):
        arrays = {"A": (lv[0], lv[1], sizes[l]), "P": (lv[3], lv[4],
                                                     sizes[l + 1]),
                  "Pt": (lv[5], lv[6], sizes[l])}
        om = lv[2]
        for name, (cols, vals, ncols) in arrays.items():
            if cols is None:
                continue
            n, K = cols.shape
            nnz = int((vals != 0).sum())
            x = torch.randn(ncols, generator=g).to(vals.device)
            b = torch.randn(n, generator=g).to(vals.device)
            op = None if ops is None else ops[l][("A", "P", "Pt").index(
                name)]
            if new and op is None:      # level 0 under the fine operator
                op = sparse.EllOperator(cols, vals, ncols)
            slots = int(op.card.starts[-1]) if new else n * K
            Kl = int(op.card.width.max()) if new else K
            for mode in use[name]:
                if new:
                    a = (None if mode == "jacobi0" else x, b,
                         om if mode in ("jacobi", "jacobi0") else None, mode)
                    fn = (lambda op=op, a=a: op(*a))
                    r = timed(fn, 200, "ell_s", 1)
                elif mode == "jacobi0":
                    fn = (lambda c=cols, v=vals, b=b, om=om: sparse.ell_spmv(
                        c, v, om * b, b, om, "jacobi"))
                    r = timed(fn, 200)
                elif mode == "add":
                    fn = (lambda c=cols, v=vals, x=x, b=b:
                          b + sparse.ell_spmv(c, v, x))
                    r = timed(fn, 200)
                else:
                    fn = (lambda c=cols, v=vals, x=x, b=b, om=om, mode=mode:
                          sparse.ell_spmv(c, v, x, b, om, mode))
                    r = timed(fn, 200, "ell_s", 1)
                per_col, per_row = cs.ELL_VECTORS[mode]
                vec = (per_col * ncols + per_row * n) * 4
                r.update(n=n, K=Kl, nnz=nnz, slots=slots,
                         fill=nnz / max(slots, 1),
                         bound_nnz_ms=cs.bound(nnz * 8 + vec, 2.0 * nnz,
                                               torch.float32)[0],
                         bound_layout_ms=cs.bound(slots * 8 + vec, 2.0 * nnz,
                                                  torch.float32)[0])
                lib = cs.ELL_LIBRARY.get(mode)
                if lib is not None:     # CSR @, torch.addmv
                    rr = torch.arange(n, device=x.device)[:, None]
                    A = cs.csr_of(rr.expand_as(cols).reshape(-1),
                                  cols.reshape(-1), vals.reshape(-1),
                                  (n, ncols))
                    r["csr"] = timed(lambda A=A, x=x, b=b, lib=lib:
                                     lib(A, x, b), 200)
                out[f"{label} {name} level {l} {mode}"] = r
    return out


def k11_part(cs, dev, timed, path):
    """K11 on the SA hierarchy of one path (the 128^2 SANewton shell, the
    star, or the two-level cycle of the 128^2 generic Poisson) and one
    cycle of it: ms, busy device ms and launches by kernel."""
    import numpy as np
    import torch
    from tigar_tpu_torch.ops import sparse
    new = hasattr(sparse, "EllOperator")
    g = torch.Generator().manual_seed(41)
    if path == "two-level":
        from tigar_tpu_torch.solvers.aggregation import TwoLevelSA
        sp2 = cs.gp_spline(cs.GP_NEL2, dev)
        sp2.set_solver_options(linear_solver="sa_cg", sa_levels=2)
        pre, _ = sp2._sa_preconditioner(cs.gp_a, torch.zeros(
            sp2.ndof, dtype=torch.float64, device=dev), None, True)
        assert isinstance(pre, TwoLevelSA)
        lv = (pre._ell_cols, pre._ell_vals, pre._om_dinv) + (None,) * 4
        recs = k11_records(cs, timed, sparse, new, path, [lv],
                           [(pre._ell_op, None, None)] if new else None,
                           pre.n_coarse, g)
        r = torch.randn(sp2.ndof, generator=g).to(dev)
        cyc = lambda: pre.apply32(r)                        # noqa: E731
        info = {}
    else:
        if path == "128^2":
            ns, _ = cs.build_solver(cs.NEL, dev)
            s, U = cs.sa_solver(ns.spline, ns.adjoint), cs.smooth_state(ns)
        else:
            from tigar_tpu_torch.demos import star_tspline_shell as demo
            s = demo.build(cs.TS_NEL, dev)
            U = s.mask64 * torch.as_tensor(np.random.default_rng(0).normal(
                size=s.spline.ndof) * 1e-3, device=dev)
        sa = s._ensure_sa(s._build(s.asm_b32, U.float()))
        recs = k11_records(cs, timed, sparse, new, path, sa._levels,
                           sa._ops if new else None, sa._coarse_inv.shape[0],
                           g)
        r = s.mask32 * torch.randn(s.spline.ndof, generator=g).to(dev)
        cyc = lambda: sa(r)                                 # noqa: E731
        info = {"levels": sa.level_sizes}
    return {"k11": recs, "cycle": {path: dict(
        **info, **timed(cyc, 50), launches=launches_per_call(cyc))}}


def k16_part(cs, dev, timed, tree):
    """K16 on the 24^3 drop-1 Poisson field and the 128^2 shell's fields
    (f64, f32) beside J^T @ F and the byte bound, and the sumfac
    residual's best of 3."""
    import numpy as np
    import torch
    from tigar_tpu_torch.ops import sumfac_forms as sf
    src = open(os.path.join(tree, "tigar_tpu_torch", "csrc",
                            "sumfac_jets.cu")).read()
    per_group = 2 if "sumfac_scatter_jets_gather" in src else 1
    out = {"k16": {}, "sumfac_residual_ms": {}}
    rng = np.random.default_rng(4)
    shell_spline = cs.build_spline(cs.NEL, dev)
    shell_asm = cs.sf_shell_assembler(shell_spline)
    psp = cs.sf_poisson_spline(cs.SF_NEL3, dev)
    pasm = sf.make_sumfac_assembler(psp)
    for label, lay64 in ((f"{cs.SF_NEL3}^3 drop 1", pasm.layout),
                         (f"{cs.NEL}^2 shell fields", shell_asm.layout)):
        _, Jt64 = cs.jets_csr(lay64)
        for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
            lay = lay64 if dt == torch.float64 else lay64.cast(dt)
            jp = sf.jets_plain(torch.zeros(lay.n, dtype=dt, device=dev), lay)
            cot = tuple(None if x is None else torch.as_tensor(
                rng.normal(size=tuple(x.shape)), device=dev).to(dt)
                for x in jp)
            fn = (lambda c=cot, l=lay: sf.scatter_jets_cuda(c, l))
            r = timed(fn, 200, "sumfac_scatter_jets",
                      per_group * len(lay.groups))
            if per_group == 2:          # the two passes apart
                for ps in ("local", "gather"):
                    r[f"{ps}_device_ms"] = cs.device_ms(
                        fn, 200, f"sumfac_scatter_jets_{ps}",
                        len(lay.groups))[0]
            r["rel_err"] = cs.rel_diff(fn(), sf.scatter_jets_plain(cot, lay))
            Jt, flat = Jt64.to(dt), cs.jets_flat(cot)
            r["csr"] = timed(lambda Jt=Jt, f=flat: Jt @ f, 200)
            r["bound_ms"] = cs.bound(cs.sf_jets_bytes(lay, dt), 0.0, dt)[0]
            out["k16"][f"{label} {tag}"] = r
    U = torch.as_tensor(rng.normal(size=shell_spline.ndof) * 1e-4,
                        device=dev)
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
        s = shell_asm if dt == torch.float64 else shell_asm.to(dt)
        out["sumfac_residual_ms"][f"{cs.NEL}^2 shell {tag}"] = \
            cs.best_of_3(lambda s=s, u=U.to(dt): s.residual_vector(
                cs.sf_shell_form, u)) * 1e3
    Up = torch.as_tensor(rng.normal(size=psp.ndof), device=dev)
    out["sumfac_residual_ms"][f"{cs.SF_NEL3}^3 poisson f64"] = \
        cs.best_of_3(lambda: pasm.residual_vector(cs.sf_poisson_form,
                                                  Up)) * 1e3
    return out


K11_K16_PARTS = ("k11 128^2", "k11 star", "k11 two-level", "k16")
K2_K4_PARTS = ("k2 128^2", "k2 two-patch", "k2 star", "k4")


def k2_shapes(cs, dev, where):
    """(label, call, bound) of K2 at the shapes of ``where``."""
    import torch
    from tigar_tpu_torch.ops.assembly import shell_kernel_args
    from tigar_tpu_torch.ops.stencil import build_stencil
    out = []

    def stencil(label, asm, dens, U, basis, ncp):
        args = shell_kernel_args(asm, dens, U)
        work = (cs.nbytes(U, *args[:1], *args[2:])
                + 225 * ncp * U.element_size(),
                cs.K2_STENCIL_OPS * asm.nel * asm.nq, U.dtype)
        out.append((label, lambda: build_stencil(asm, dens, U, basis, 3),
                    cs.bound(*work)[0]))

    def elements(label, asm, dens, U, me):
        out.append((label, lambda: asm.element_matrices_adjoint(dens, U,
                                                                 me=me),
                    cs.bound(*cs.elements_work(asm, dens, U, me))[0]))

    if where == "128^2":
        ns, _ = cs.build_solver(cs.NEL, dev)
        U64 = cs.smooth_state(ns)
        ncp = ns.mask32.numel() // 3
        for asm, U in ((ns.asm_b32, U64.float()), (ns.asm32, U64.float()),
                       (ns.asm_b64, U64)):
            stencil(f"stencil {str(U.dtype)[6:]} nq={asm.nq}", asm,
                    ns.adjoint, U, ns.basis, ncp)
        me = ns.spline.mask[ns.asm_b64.cat_conn]
        for asm, U in ((ns.asm_b32, U64.float()), (ns.asm_b64, U64)):
            elements(f"elements {str(U.dtype)[6:]} nq={asm.nq}", asm,
                     ns.adjoint, U, me.to(U.dtype))
    elif where == "two-patch":
        ns, _, _ = cs.build_two_patch(dev)
        U64 = cs.mp_smooth_state(ns)
        e0 = 0
        for p, pt in enumerate(ns.basis.patches):
            for asm, U in ((ns.asm_b32, U64.float()), (ns.asm_b64, U64)):
                sub = asm.elements(e0, e0 + pt.nel)
                stencil(f"stencil {str(U.dtype)[6:]} patch {'AB'[p]} "
                        f"nel={pt.nel} nq={sub.nq}", sub, ns.adjoint, U, pt,
                        pt.ncp)
            e0 += pt.nel
    else:
        from tigar_tpu_torch.demos import star_tspline_shell as star_demo
        ns = star_demo.build(cs.TS_NEL, dev)
        g = torch.Generator().manual_seed(7)
        U64 = 0.01 * torch.randn(ns.spline.ndof, generator=g,
                                 dtype=torch.float64).to(dev)
        for qd in (4, None):
            asm0 = ns.spline._assembler("dx", quad_degree=qd)
            me = ns.spline.mask[asm0.cat_conn] * asm0.masks[0].repeat(1, 3)
            for dt in (torch.float32, torch.float64):
                asm = asm0.astype(dt)
                elements(f"elements {str(dt)[6:]} nq={asm.nq}", asm,
                         ns.adjoint, U64.to(dt), me.to(dt))
    return out


def k2_part(cs, dev, timed, where):
    out = {}
    for label, call, bound_ms in k2_shapes(cs, dev, where):
        call()
        out[f"{where} {label}"] = dict(**timed(call, 20), bound_ms=bound_ms)
    return {"k2": out}


def k4_part(cs, dev, timed):
    """K4 on every grid of the Poisson hierarchy, f32 and f64, beside one
    CSR product of the same BC'd operator."""
    import numpy as np
    import torch
    from tigar_tpu_torch.ops.sumfac import build_sumfac_data, sumfac_apply
    bases, masks = cs.poisson_levels(cs.NEL3)
    rng = np.random.default_rng(2)
    out = {}
    for basis, mask in zip(bases, masks):
        W64 = torch.as_tensor(rng.normal(size=basis.ncp), device=dev)
        for dt in (torch.float32, torch.float64):
            data = build_sumfac_data(basis, None, cs.QD3, dev, dt)
            W, m = W64.to(dt), torch.as_tensor(mask, device=dev).to(dt)
            reps = 100 if basis.nel_per_dir[0] >= 48 else 400
            rec = timed(lambda: sumfac_apply(data, W, 1.0, 0.0, m), reps)
            rec["bound_ms"] = cs.bound(cs.nbytes(W, m, W), cs.sumfac_flops(
                data), dt)[0]
            A = cs.sumfac_csr(data, m, dt)
            rec["csr"] = timed(lambda: torch.mv(A, W), reps)
            rec["csr_nnz"] = int(A._nnz())
            del A
            out[f"{basis.nel_per_dir[0]}^3 {str(dt)[6:]}"] = rec
    return {"k4": out}


def k2_k4_part(cs, dev, timed, tree, part):
    if part == "k4":
        return k4_part(cs, dev, timed)
    return k2_part(cs, dev, timed, part.split(" ", 1)[1])


def poisson_path(cs, dev):
    """The 96^3 Poisson MG-CG solve (cold and warm), its checks, the busy
    share of a warm solve and K4's device ms in it."""
    pb, _, err96, launches = cs.poisson_main_path(dev)
    t0 = time.perf_counter()
    cs.poisson_solve(pb)
    import torch
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    return dict(l2_error=err96, k4_launches=launches, warm_s=warm,
                profile=cs.profile_poisson(pb))


def k2_k4(cs, dev, timed, tree):
    """Each kernel part in a fresh process of its own, then the paths."""
    out = {"k2": {}, "k4": {}}
    for p in K2_K4_PARTS:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--what",
             "k2_k4_part", "--part", p, "--tree", tree, "--label", p],
            capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        if run.returncode or not lines:
            raise SystemExit(f"part {p} failed:\n{run.stdout[-3000:]}\n"
                             f"{run.stderr[-3000:]}")
        got = json.loads(lines[-1])
        for k in ("k2", "k4"):
            out[k].update(got.get(k, {}))
    out["poisson"] = poisson_path(cs, dev)
    out.update(k10_k3_paths(cs, dev))
    out["tallies"] = cs.TALLIES
    return out


def k11_k16_part(cs, dev, timed, tree, part):
    if part == "k16":
        return k16_part(cs, dev, timed, tree)
    return k11_part(cs, dev, timed, part.split(" ", 1)[1])


def k11_k16(cs, dev, timed, tree):
    """Each kernel part in a fresh process of its own (profiler sessions
    late in a process drop launches), then the SA paths here."""
    out = {"k11": {}, "cycle": {}}
    for p in K11_K16_PARTS:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--what",
             "k11_k16_part", "--part", p, "--tree", tree, "--label", p],
            capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        if run.returncode or not lines:
            raise SystemExit(f"part {p} failed:\n{run.stdout[-3000:]}\n"
                             f"{run.stderr[-3000:]}")
        got = json.loads(lines[-1])
        for k in ("k11", "cycle"):
            out[k].update(got.pop(k, {}))
        out.update({k: v for k, v in got.items()
                    if k in ("k16", "sumfac_residual_ms")})
    ns, _, _, Usol, _ = shell_solution(cs, dev)
    out.update(sa_paths(cs, dev, ns, Usol))
    return out


K14_K9_PARTS = ("reef knot", "k14 (a)", "k14 (b)", "k9")


def _contact_calls(cs, c, U, W, dev):
    """(label, call, bound ms, counts) of K13 and K14 at state U, f64 and
    f32, through the tree's wrappers (with its bits, where it keeps
    them)."""
    import torch
    from tigar_tpu_torch.ops import contact as oc
    out = []
    for dt in (torch.float64, torch.float32):
        cc = c if dt == torch.float64 else c.astype(dt)
        x = cc.positions(U.to(dt)).contiguous()
        v = cc._apply_P(W.to(dt)).contiguous()
        n, es = x.shape[0], x.element_size()
        kw = {"bits": cc.pair_bits} if hasattr(cc, "pair_bits") else {}
        xd = x.double()
        live = inter = kept_live = 0
        keep = (~oc.culled_tile_pairs(x, cc.pair_bits, cc.r_max)
                if kw else None)
        for i0 in range(0, n, 1024):
            d2 = ((xd[i0:i0 + 1024, None] - xd[None]) ** 2).sum(-1)
            m = cc.pair_mask[i0:i0 + 1024]
            live += int(m.sum())
            inter += int((m & (d2 < cc.r_max ** 2)).sum())
            if keep is not None:
                rows = torch.arange(i0, min(i0 + 1024, n), device=dev) // 32
                cols = torch.arange(n, device=dev) // 32
                kept_live += int((m & keep[rows][:, cols]).sum())
        counts = dict(n=n, live=live, interacting=inter)
        if keep is not None:
            counts.update(tile_pairs=keep.numel(), tiles_kept=int(keep.sum()),
                          kept_live=kept_live)
            mask_bytes = cs.nbytes(cc.pair_bits.words, cc.pair_bits.tiles)
            scanned = kept_live
        else:
            mask_bytes, scanned = n * n, live
        io = es * (2 * x.numel() + n)
        dname = str(dt)[6:]
        out.append((f"K13 {dname}", lambda x=x, cc=cc, kw=kw: oc.contact_forces(
            x, cc.quad_w, cc.pair_mask, cc.k, cc.r_max, **kw),
            cs.bound(mask_bytes + io, 8.0 * scanned + 10.0 * inter, dt)[0],
            counts))
        out.append((f"K14 {dname}", lambda x=x, v=v, cc=cc, kw=kw:
                    oc.contact_hvp(x, v, cc.quad_w, cc.pair_mask, cc.k,
                                   cc.r_max, **kw),
                    cs.bound(mask_bytes + io + es * v.numel(),
                             8.0 * scanned + 28.0 * inter, dt)[0], counts))
    return out


def _state_b_file(tree):
    return os.path.join(tree, "build", "k14_state_b.pt")


def k14_k9_part(cs, dev, timed, tree, part):
    import numpy as np
    import torch
    from tigar_tpu_torch.contact import PointContact
    from tigar_tpu_torch.demos import reef_knot_contact as demo
    from tigar_tpu_torch.ops import cuda_ext
    if part == "reef knot":
        torch.cuda.synchronize()
        cuda_ext.reset_counts()
        t0 = time.perf_counter()
        U, hist, energy = demo.run(cs.RK_NEL, 1, mixed=True, mg=True,
                                   device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_ext.counts()
        by_key = cs.tally("reef_knot", ("contact_residual",
                                        "contact_tangent"))
        os.makedirs(os.path.dirname(_state_b_file(tree)), exist_ok=True)
        torch.save(U.cpu(), _state_b_file(tree))
        return {"reef_knot": dict(
            wall_s=wall, residual_evaluations=len(hist[0]),
            final_rel=hist[0][-1], energy=energy,
            launches={k: launches[k] for k in ("contact_residual",
                                                "contact_tangent")},
            launches_by_key=by_key)}
    if part in ("k14 (a)", "k14 (b)"):
        sp = demo.build_spline(cs.RK_NEL, dev)
        if part == "k14 (a)":
            c = PointContact(sp, **cs.RK_ACTIVE)
            rng = np.random.default_rng(0)
            U = torch.as_tensor(rng.normal(size=sp.ndof) * 0.01, device=dev)
            W = torch.as_tensor(rng.normal(size=sp.ndof), device=dev)
        else:
            c = PointContact(sp, **demo.CONTACT)
            U = torch.load(_state_b_file(tree)).to(dev)
            W = torch.as_tensor(np.random.default_rng(1).normal(
                size=U.numel()), device=dev)
        out = {}
        for label, call, bound_ms, counts in _contact_calls(cs, c, U, W, dev):
            call()
            rec = timed(call, 50)
            rec["kernels_device_ms"] = timed(call, 50, "contact_",
                                             2 if hasattr(c, "pair_bits")
                                             else 1)["device_ms"]
            out[f"{part[4:]} {label}"] = dict(**rec, bound_ms=bound_ms,
                                              **counts)
        return {"k14": out}
    # K9 on the three levels of the Nitsche solver
    ns, _, _ = cs.build_two_patch(dev, coupling="nitsche")
    levels = [("fine", ns.couplings[0], cs.mp_smooth_state(ns))]
    for i, (spl, cl) in enumerate(zip(ns.mg_splines, ns.mg_couplings)):
        g = torch.Generator().manual_seed(5 + i)
        U = 0.01 * torch.randn(spl.ndof, generator=g, dtype=torch.float64)
        levels.append((f"level {i + 1}", cl[0],
                       spl.mask * U.to(ns.mask64.device)))
    out = {}
    for level, cpl, U64 in levels:
        idx, pos_a, pos_b = cpl.support_positions()
        for dt in (torch.float64, torch.float32):
            c = cpl.astype(dt)
            us = U64.to(dt)[idx.long()]
            call = (lambda c=c, us=us, pa=pos_a, pb=pos_b:
                    c.tangent_block_cuda(us, pa, pb, c.params))
            call()
            reps = 20 if dt == torch.float64 else 50
            rec = timed(call, reps)
            rec["kernel_device_ms"] = timed(
                call, reps, "nitsche_tangent_kernel")["device_ms"]
            m, es = idx.numel(), us.element_size()
            out[f"{level} {str(dt)[6:]} nq={c.wq.numel()} m={m}"] = dict(
                **rec, bound_ms=cs.bound(m * m * es, 0.0, dt)[0])
    return {"k9": out}


def k14_k9(cs, dev, timed, tree):
    """Each part in a fresh process of its own, then the Nitsche solve."""
    out = {"k14": {}, "k9": {}}
    for p in K14_K9_PARTS:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--what",
             "k14_k9_part", "--part", p, "--tree", tree, "--label", p],
            capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        if run.returncode or not lines:
            raise SystemExit(f"part {p} failed:\n{run.stdout[-3000:]}\n"
                             f"{run.stderr[-3000:]}")
        got = json.loads(lines[-1])
        for k in ("k14", "k9"):
            out[k].update(got.pop(k, {}))
        out.update({k: v for k, v in got.items() if k == "reef_knot"})
    t0 = time.perf_counter()
    ns, cpl, sizes = cs.build_two_patch(dev, coupling="nitsche")
    *_, out["two_patch_nitsche"] = cs.two_patch_nitsche_main_path(
        ns, cpl, sizes, time.perf_counter() - t0)
    out["tallies"] = cs.TALLIES
    return out


WHAT = {"k12_k5": k12_k5, "shell": shell, "k10_k3": k10_k3,
        "k11_k16": k11_k16, "k11_k16_part": k11_k16_part, "k2_k4": k2_k4,
        "k2_k4_part": k2_k4_part, "k14_k9": k14_k9,
        "k14_k9_part": k14_k9_part}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", required=True, choices=sorted(WHAT))
    ap.add_argument("--tree", default=".")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--part", default=None,
                    choices=K11_K16_PARTS + K2_K4_PARTS + K14_K9_PARTS)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    import chip_smoke as cs                  # puts HERE first on sys.path
    sys.path.insert(0, tree)
    import torch
    import tigar_tpu_torch
    from tigar_tpu_torch.ops import cuda_ext
    if not os.path.abspath(tigar_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f"imported {tigar_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    t0 = time.time()
    cuda_ext.load()
    out = {"what": args.what, "label": args.label, "tree": tree,
           "card": cs.CARD, "build_s": time.time() - t0}

    def timed(fn, reps, match=None, per_call=1):
        """CUDA-event ms a call; device ms a call of every device event
        (``library_device_ms``) or, with ``match``, of the kernels whose
        name holds it, ``per_call`` of them a call (``device_ms``)."""
        dev = (cs.library_device_ms(fn, reps)[0] if match is None
               else cs.device_ms(fn, reps, match, per_call)[0])
        return {"ms": cs.cuda_ms(fn, reps), "device_ms": dev}

    extra = ((tree,) if args.what in ("k11_k16", "k2_k4", "k14_k9") else
             (tree, args.part) if args.what in ("k11_k16_part", "k2_k4_part",
                                                "k14_k9_part")
             else ())
    out.update(WHAT[args.what](cs, dev, timed, *extra))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
