#!/usr/bin/env python3
"""Times the designs of K10 that were tried and not kept, and two read-only
bounds, against the port's K10 on the tangents of both SANewton paths, on
one CUDA card:

    python scripts/k10_designs.py [--out FILE]

builds scripts/k10_designs.cu with nvcc (sm_90a) into build/k10_designs/,
takes the BC'd f32 and f64 element matrices of the 128^2 shell's SANewton
path and of the star T-spline (nel 48) at chip_smoke.py's seeded states,
and prints one JSON line a case (also appended to FILE): each design's
element kernel (no init launch) as the device time a launch of its kernel
(torch.profiler, None unless a session recorded every launch) and the
CUDA-event ms a call over 500 back-to-back calls through ctypes (host
work included), with its max error against the plain version relative to
the largest entry; the same for the port's K10 (its element kernel alone,
and the call through its wrapper with the init launch); one
torch.sparse CSR product of the same operator; the device time of reading
E's upper triangle entry by entry in the port's order and of reading all
of E with 16-byte loads; and the byte bound.  Without a CUDA device it
raises.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGNS = (("square", 1), ("pipeline", 2), ("pipeline", 3), ("wide", 1))


def build():
    out = os.path.join(HERE, "build", "k10_designs")
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out, "libk10_designs.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, os.path.join(HERE, "scripts",
                                            "k10_designs.cu")], check=True)
    so = ctypes.CDLL(lib)
    for f in (so.k10_design_f32, so.k10_design_f64):
        f.argtypes = ([ctypes.c_char_p] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 6)
    return so


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import chip_smoke as cs
    from tigar_tpu_torch.demos import star_tspline_shell as star_demo
    from tigar_tpu_torch.ops import sparse
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    so = build()
    dev = torch.device("cuda")
    ns, _ = cs.build_solver(cs.NEL, dev)
    ns_sa = cs.sa_solver(ns.spline, ns.adjoint)
    ns_ts = star_demo.build(cs.TS_NEL, dev)
    rng = np.random.default_rng(0)
    U_star = ns_ts.mask64 * torch.as_tensor(
        rng.normal(size=ns_ts.spline.ndof) * 1e-3, device=dev)
    g = torch.Generator().manual_seed(31)
    for label, s, U in (("128^2", ns_sa, cs.smooth_state(ns)),
                        ("star", ns_ts, U_star)):
        for dt in (torch.float32, torch.float64):
            tag = "f32" if dt == torch.float32 else "f64"
            st = s._build(s.asm_b32 if tag == "f32" else s.asm_b64, U.to(dt))
            m = s.mask64.to(dt)
            x = torch.randn(st.ndof, generator=g,
                            dtype=torch.float64).to(dev, dt)
            nel, nloc = st.conn.shape
            y = torch.zeros_like(x)
            ref = sparse.elem_tangent_apply_ref(st.conn, st.E, x, m) \
                - (1.0 - m) * x
            fn = so.k10_design_f32 if tag == "f32" else so.k10_design_f64
            out = {"case": f"{label} {tag}", "card": cs.CARD, "nel": nel,
                   "nloc": nloc}

            def call(what, stages):
                return fn(what.encode(), stages, nel, nloc,
                          st.conn.data_ptr(), st.E.data_ptr(), x.data_ptr(),
                          m.data_ptr(), y.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
            for what, stages in DESIGNS:
                name = what if what != "pipeline" else f"pipeline S{stages}"
                y.zero_()
                if call(what, stages) != 0:
                    out[name] = None
                    continue
                torch.cuda.synchronize()
                err = float((y - ref).abs().max() / ref.abs().max())
                fn_d = (lambda w=what, k=stages: call(w, k))
                out[name] = {"device_ms": cs.device_ms(fn_d, 200,
                                                       f"::{what}<", 1)[0],
                             "ms": cs.cuda_ms(fn_d, 500), "err": err}
            port = (lambda: sparse.elem_tangent_apply(st.conn, st.E, x, m))
            yk = port()
            out["port"] = {
                "device_ms": cs.device_ms(port, 200, "elem_apply_kernel",
                                          1)[0],
                "device_ms_with_init": cs.device_ms(port, 200, "elem_",
                                                    2)[0],
                "ms": cs.cuda_ms(port, 500),
                "err": float((yk - (1.0 - m) * x - ref).abs().max()
                             / ref.abs().max())}
            for what, match in (("read_tri", "::read_tri<"),
                                ("read_full", "read_full")):
                out[what] = cs.device_ms(lambda w=what: call(w, 1), 200,
                                         match, 1)[0]
            A = cs.elem_csr(st, m)
            out["csr"] = {"ms": cs.cuda_ms(lambda: A @ x, 500),
                          "device_ms": cs.library_device_ms(lambda: A @ x,
                                                            200)[0]}
            out["bound_ms"] = cs.bound(*cs.elem_work(st))[0]
            line = json.dumps(out)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
