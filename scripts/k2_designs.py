#!/usr/bin/env python3
"""Times ablations of K2 (the SVK shell tangent, stencil and element
modes) against the port's, on one CUDA card:

    python scripts/k2_designs.py [--out FILE]

builds scripts/k2_designs.cu (which includes the port's
csrc/tangent_stencil.cu) with nvcc (sm_90a) into build/k2_designs/ and
runs each variant at the paths' shapes, at chip_smoke.py's seeded smooth
states: the 128^2 shell's stencil builds (f32 at 4 and 9 points, f64 at
4), its element mode with the BC mask at the connectivity (f32, f64, 4
points), and the star T-spline's (nel 48; 16 local functions a field,
the padding mask) element mode at 9 and 16 points (f32, f64).  Variants:
the port (stencil mode: its element kernel into a scratch E, then the
fold); its stages at one element a block ("epb1"); without the writes
("no_write"); without the coalesced store of the block's E ("no_store");
the inputs, jets and jet-Jacobians alone ("jacobians"); the inputs alone
("inputs"); every tile of E with no mirror ("full"); the fold alone
("fold", stencil shapes); the port built with nvcc -maxrregcount=128
("port_r128").  The variants write E (element mode).  It prints one
JSON line a shape (also appended to FILE): each variant's CUDA-event ms a
call over back-to-back calls through ctypes,
its device ms a call (torch.profiler, every device event of the call;
None unless sessions of 10 and of the timed calls record the same whole
number a call), and for the variants that write, the max error against
the plain version relative to the largest entry.  Without a CUDA device
it raises.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("port", "epb1", "no_write", "no_store", "jacobians", "inputs",
            "full")
# the port built again with its registers capped (nvcc -maxrregcount)
CAPS = (128,)


def build(cap=None):
    out = os.path.join(HERE, "build", "k2_designs")
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out, f"libk2_designs{cap or ''}.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v", "-o", lib]
                   + ([f"-maxrregcount={cap}"] if cap else [])
                   + [os.path.join(HERE, "scripts", "k2_designs.cu")],
                   check=True)
    so = ctypes.CDLL(lib)
    for f in (so.k2_design_f32, so.k2_design_f64):
        f.argtypes = ([ctypes.c_char_p] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 8)
    return so


def shapes(cs, dev):
    """(label, assembler, density, U, (element grid, grid, basis) of a
    stencil build or None, me)."""
    import torch
    from tigar_tpu_torch.demos import star_tspline_shell as star_demo
    from tigar_tpu_torch.ops.stencil import _layout
    ns, _ = cs.build_solver(cs.NEL, dev)
    U64 = cs.smooth_state(ns)
    _, grid, nel = _layout(ns.basis)
    me64 = ns.spline.mask[ns.asm_b64.cat_conn]
    st = (nel, grid, ns.basis)
    out = [(f"stencil f32 nq={ns.asm_b32.nq} {cs.NEL}^2", ns.asm_b32,
            ns.adjoint, U64.float(), st, None),
           (f"stencil f32 nq={ns.asm32.nq} {cs.NEL}^2", ns.asm32,
            ns.adjoint, U64.float(), st, None),
           (f"stencil f64 nq={ns.asm_b64.nq} {cs.NEL}^2", ns.asm_b64,
            ns.adjoint, U64, st, None)]
    for tag, asm, U in (("f32", ns.asm_b32, U64.float()),
                        ("f64", ns.asm_b64, U64)):
        out.append((f"elements {tag} nq={asm.nq} {cs.NEL}^2", asm,
                    ns.adjoint, U, None, me64.to(U.dtype)))
    ns_ts = star_demo.build(cs.TS_NEL, dev)
    g = torch.Generator().manual_seed(7)
    Uts = 0.01 * torch.randn(ns_ts.spline.ndof, generator=g,
                             dtype=torch.float64).to(dev)
    for qd in (4, None):
        asm0 = ns_ts.spline._assembler("dx", quad_degree=qd)
        me = ns_ts.spline.mask[asm0.cat_conn] * asm0.masks[0].repeat(1, 3)
        for dt in (torch.float32, torch.float64):
            asm = asm0.astype(dt)
            out.append((f"elements {str(dt)[6:]} nq={asm.nq} star",
                        asm, ns_ts.adjoint, Uts.to(dt), None, me.to(dt)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from tigar_tpu_torch.ops.assembly import (element_matrices_adjoint_ref,
                                              shell_kernel_args,
                                              shell_padding_mask)
    from tigar_tpu_torch.ops.stencil import build_stencil_ref
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = {"": build(), **{f"_r{c}": build(c) for c in CAPS}}
    dev = torch.device("cuda")
    for label, asm, dens, U, grid, me in shapes(cs, dev):
        a = shell_kernel_args(asm, dens, U)
        conn, ts = a[0], [U.contiguous()] + a[2:]
        tptr = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in ts])
        c = (ctypes.c_double * 4)(*dens.kernel_constants()[:4])
        mask = shell_padding_mask(asm)
        nen, dt = asm.nens[0], U.dtype
        E = torch.empty((asm.nel, 3 * nen, 3 * nen), dtype=dt, device=dev)
        E_ref = element_matrices_adjoint_ref(asm, dens, U, me)
        if grid is None:
            S, nel_x = None, 1
        else:
            (_, nel_x), (ny, nx), basis = grid
            S = torch.empty((3, 3, 5, 5, ny, nx), dtype=dt, device=dev)
            S_ref = build_stencil_ref(asm, dens, U, basis, 3).S

        def call(what, lib=""):
            fn = getattr(libs[lib], "k2_design_f32" if dt == torch.float32
                         else "k2_design_f64")
            stencil = S is not None and what in ("port", "fold")
            err = fn(what.encode(), asm.nel, nel_x, asm.nq, nen,
                     conn.data_ptr(), tptr,
                     None if mask is None else mask.data_ptr(), c,
                     S.data_ptr() if stencil else None,
                     None if me is None else me.data_ptr(), E.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{label} {what}: CUDA error {err}")

        def rel(x, ref):
            return float((x - ref).abs().max()) / float(ref.abs().max())

        rec = {"shape": label, "card": card, "nel": asm.nel}
        runs = [(w, "") for w in VARIANTS] + [("port", k) for k in libs
                                             if k]
        if S is not None:
            runs.append(("fold", ""))
        for what, lib in runs:
            E.fill_(float("nan"))
            if S is not None:
                S.fill_(float("nan"))
            call(what, lib)
            torch.cuda.synchronize()
            err = None
            if S is not None and what == "port":
                err = rel(S, S_ref)
            elif what in ("port", "epb1", "full"):
                err = rel(E, E_ref)
            if what == "fold":   # on the port's E
                call("port")
            ms = cs.cuda_ms(lambda w=what, k=lib: call(w, k), 20)
            dev_ms = cs.library_device_ms(lambda w=what, k=lib: call(w, k),
                                          20)[0]
            rec[what + lib] = dict(ms=ms, device_ms=dev_ms, max_rel_err=err)
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
