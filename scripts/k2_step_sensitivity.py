#!/usr/bin/env python3
"""How far the step count of the 128^2 shell's solve depends on the f32
rounding of its tangent stencils, on one CUDA card:

    python scripts/k2_step_sensitivity.py [--out FILE]

solves chip_smoke.py's shell (``build_solver``, StencilNewton from U = 0
to rtol 1e-10, as the script's main path) once with its fine f32 tangent
stencils from kernel K2, once each with every K2 stencil entry times
(1 + 1e-7 z), z standard normal from seeds 0-4 (the size of f32
rounding), and once with the stencils of K2's plain version
(``build_stencil_ref``: jacfwd element matrices and the slice-add fold,
on the card).  The coarse levels' stencils are the solver's own in every
run.  It prints one JSON line (also appended to FILE): for each run the
steps, the relative residual after the first (f32) step and the final
f64 relative residual.  Without a CUDA device it raises.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(5)
EPS = 1e-7


def run(cs, dev, build):
    """One full solve with the fine f32 stencils from ``build(ns, asm,
    U)``: (steps, first step's rel |r|, final rel64)."""
    import torch
    ns, _ = cs.build_solver(cs.NEL, dev)
    orig = ns._build
    ns._build = lambda asm, U: build(ns, orig, asm, U)
    lines = []
    _, rel64, nsteps, _ = ns.solve(rtol=1e-10, log=lines.append)
    torch.cuda.synchronize()
    first = next(float(ln.split("rel |r| = ")[1].split()[0].rstrip(","))
                 for ln in lines if "newton it 1 " in ln)
    return dict(steps=nsteps, first_rel=first, rel64=rel64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from tigar_tpu_torch.ops.stencil import StencilOperator, build_stencil_ref
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def kernel(ns, orig, asm, U):
        return orig(asm, U)

    def noisy(seed):
        g = torch.Generator(device=dev).manual_seed(seed)

        def build(ns, orig, asm, U):
            st = orig(asm, U)
            z = torch.randn(st.S.shape, generator=g, device=dev,
                            dtype=st.S.dtype)
            return StencilOperator(st.S * (1 + EPS * z), st.grid_shape,
                                   st.degrees, st.nf)
        return build

    def plain(ns, orig, asm, U):
        return build_stencil_ref(asm, ns.adjoint, U, ns.basis, ns.nf)

    rec = {"card": card, "eps": EPS, "kernel": run(cs, dev, kernel)}
    for s in SEEDS:
        rec[f"kernel, noise seed {s}"] = run(cs, dev, noisy(s))
    rec["plain"] = run(cs, dev, plain)
    text = json.dumps(rec)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
