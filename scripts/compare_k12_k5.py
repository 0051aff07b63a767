#!/usr/bin/env python3
"""Times K12 (the f32 fast-path Laplace apply), K5 (the dense interface
block apply) and the two-patch shell paths that run K5, for one checkout
of tigar_tpu_torch on one CUDA card, so that two designs can be timed in
turns on one card:

    python scripts/compare_k12_k5.py --tree DIR --label NAME [--out FILE]

imports ``tigar_tpu_torch`` from DIR (its kernels build into DIR/build)
and the measuring code from this repository's ``chip_smoke.py``, and
prints one JSON line, also appended to FILE.  Shapes, as chip_smoke.py's:
K12 through ``make_laplace_operator`` on the generic Poisson at 2D p=2
256^2, 2D p=3 32^2 and 3D p=2 16^3, beside the same BC'd operator as one
f32 torch.sparse CSR matrix; K5 through ``iface_block_apply`` on the fine
interface block of the two-patch penalty operator (m = 2,376) at
chip_smoke's seeded state, f64 and f32, accumulating into one buffer,
beside ``torch.mv`` on the pre-gathered vector; then the two-patch
penalty and Nitsche main paths (best of 3 warm f32 steps, the full
solve).  Kernel ms: CUDA events over the calls, wrapper included; device
ms: torch.profiler, every device event of the call, None unless sessions
of 10 and of REPS calls record the same whole number a call.  Without a
CUDA device it raises.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 200


def main():
    ap = argparse.ArgumentParser()
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
    from tigar_tpu_torch.ops import cuda_ext, fastpath
    from tigar_tpu_torch.solvers.newton_stencil_mp import iface_block_apply
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
    out = {"label": args.label, "tree": tree, "card": cs.CARD,
           "build_s": time.time() - t0, "k12": {}, "k5": {}}

    def timed(fn):
        return {"ms": cs.cuda_ms(fn, REPS),
                "device_ms": cs.library_device_ms(fn, REPS)[0]}

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
            **timed(lambda: op(W)),
            "csr": timed(lambda: torch.mv(A, W)),
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
                    iface_block_apply(B, idx, v, o, mk, 1.0)),
            "mv": timed(lambda B=B, vs=vs: torch.mv(B, vs))}

    *_, out["two_patch_penalty"] = cs.two_patch_main_path(ns, cpl, sizes,
                                                           setup_s)
    splines = [ns.spline, *ns.mg_splines]
    t0 = time.perf_counter()
    ns, cpl, sizes = cs.build_two_patch(dev, coupling="nitsche",
                                        splines=splines)
    *_, out["two_patch_nitsche"] = cs.two_patch_nitsche_main_path(
        ns, cpl, sizes, time.perf_counter() - t0)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
