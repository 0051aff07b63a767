#!/usr/bin/env python3
"""Times a set of kernels and main paths for one checkout of
tigar_tpu_torch on one CUDA card, so that two versions of the port can be
timed in turns on one card:

    python scripts/compare_trees.py --what k12_k5|shell --tree DIR \
        --label NAME [--out FILE]

imports ``tigar_tpu_torch`` from DIR (its kernels build into DIR/build)
and the measuring code from this repository's ``chip_smoke.py``, and
prints one JSON line, also appended to FILE.  Kernel ms: CUDA events over
the calls, wrapper included; device ms: torch.profiler, every device
event of the call, None unless sessions of 10 and of the timed calls
record the same whole number a call.  Without a CUDA device it raises.

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


WHAT = {"k12_k5": k12_k5, "shell": shell}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", required=True, choices=sorted(WHAT))
    ap.add_argument("--tree", default=".")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
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

    def timed(fn, reps):
        return {"ms": cs.cuda_ms(fn, reps),
                "device_ms": cs.library_device_ms(fn, reps)[0]}

    out.update(WHAT[args.what](cs, dev, timed))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
