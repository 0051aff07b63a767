#!/usr/bin/env python3
"""Where K11's time goes on the star T-spline's SA levels, on one CUDA
card:

    python scripts/k11_probe.py [--out FILE]

Builds the star's SA hierarchy (``demos.star_tspline_shell.build(48)``,
the f32 tangent at a seeded state, as ``chip_smoke.py`` phase 14 does) and
prints one JSON line a record (also appended to FILE):

- "host": the host microseconds a call of the Jacobi sweep on level 1's A
  (n 6,051, 560 slots), over 2,000 calls issued back to back: the whole
  ``EllOperator`` call, the binding alone (``ell_spmv`` on the layout, its
  checks, the output's allocation and the launch), ``cuda_ext.load()``
  alone and the launch tally (``cuda_ext.count`` with its key) alone;
  beside them the CUDA-event ms a call and the profiler's device ms a
  launch.
- "lanes": level 0's and level 1's A (jacobi), P (add) and Pt (apply)
  with every tile at one fixed number of lanes a row (4-256) against the
  layout ``sliced_ell`` picks, by profiler device ms a launch, each held
  to the carried arrays' plain version.
- "addmv": ``torch.addmv`` on the operator as a CSR tensor (residual,
  alpha -1, and add) against K11's residual and add modes: ms and the
  largest difference relative to the plain version's largest entry.

Without a CUDA device it raises.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = (4, 8, 16, 32, 64, 128, 256)


def fixed_lanes(sparse, op, lanes):
    """``op``'s sliced layout with every tile at ``lanes`` lanes a row
    (``ELL_THREADS / lanes`` rows a tile), through ``sparse.sliced_ell``
    with its tiling rule replaced."""
    import torch
    rule = sparse._tile_of_rows

    def tiles(chunks):
        r = torch.arange(chunks.shape[0], device=chunks.device)
        rows = 256 // lanes
        return (r // rows) * rows, torch.full_like(r, lanes)
    sparse._tile_of_rows = tiles
    try:
        return sparse.sliced_ell(op.cols, op.vals, op.ncols)
    finally:
        sparse._tile_of_rows = rule


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import numpy as np
    import torch
    from tigar_tpu_torch.demos import star_tspline_shell as demo
    from tigar_tpu_torch.ops import cuda_ext, sparse
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    ext = cuda_ext.load()

    def emit(rec):
        text = json.dumps(dict(rec, card=card))
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")

    s = demo.build(cs.TS_NEL, dev)
    U = s.mask64 * torch.as_tensor(np.random.default_rng(0).normal(
        size=s.spline.ndof) * 1e-3, device=dev)
    sa = s._ensure_sa(s._build(s.asm_b32, U.float()))
    g = torch.Generator().manual_seed(17)

    def vectors(op):
        return tuple(torch.randn(k, generator=g).to(dev)
                     for k in (op.ncols, op.n))

    def host_us(fn, n=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    # host time a call, level 1's A, Jacobi sweep
    lv = sa._levels[1]
    op = sa._ops[1][0]
    sl = op.card
    x, b = vectors(op)
    om = lv.om_dinv
    code = sparse.ELL_MODES["jacobi"]
    whole = (lambda: op(x, b, om, "jacobi"))
    binding = (lambda: ext.ell_spmv(sl.tiles, sl.starts, sl.cols, sl.vals,
                                    sl.n, sl.ncols, x, b, om, code))
    key = (op.key, "jacobi")
    emit({"what": "host", "op": "star A1 jacobi", "n": op.n,
          "K": int(sl.width.max()),
          "call_us": host_us(whole), "binding_us": host_us(binding),
          "load_us": host_us(cuda_ext.load, 20000),
          "count_us": host_us(lambda: cuda_ext.count("ell_spmv", key),
                              20000),
          "call_ms": cs.cuda_ms(whole, 200),
          "binding_ms": cs.cuda_ms(binding, 200),
          "device_ms": cs.device_ms(whole, 200, "ell_sliced_kernel")[0]})

    # lanes a row: fixed against the picked layout
    for l in (0, 1):
        lv = sa._levels[l]
        ops = sa._ops[l]
        A = ops[0] if ops[0] is not None else sparse.EllOperator(
            lv.A_cols, lv.A_vals, lv.om_dinv.shape[0])
        for name, op, mode in (("A", A, "jacobi"), ("P", ops[1], "add"),
                               ("Pt", ops[2], "apply")):
            x, b = vectors(op)
            om = lv.om_dinv if mode == "jacobi" else None
            code = sparse.ELL_MODES[mode]
            want = sparse.ell_spmv_ref(op.cols, op.vals, x, b, om, mode)
            rec = {"what": "lanes", "op": f"star {name}{l} {mode}",
                   "n": op.n, "K": int(op.cols.shape[1])}
            for lanes in ("picked",) + LANES:
                sl = op.card if lanes == "picked" else fixed_lanes(
                    sparse, op, lanes)
                fn = (lambda sl=sl, x=x, b=b, om=om, code=code:
                      ext.ell_spmv(sl.tiles, sl.starts, sl.cols, sl.vals,
                                   sl.n, sl.ncols, x, b, om, code))
                err = cs.rel_diff(fn(), want)
                if not err <= cs.TOL["f32"]:
                    raise SystemExit(f"{rec['op']} at {lanes} lanes: "
                                     f"{err:.2e}")
                rec[f"{lanes}_device_ms"] = cs.device_ms(
                    fn, 200, "ell_sliced_kernel")[0]
                if lanes == "picked":
                    t = sl.tiles[:, 2].tolist()
                    rec["picked_lanes"] = {k: t.count(k) for k in set(t)}
            emit(rec)

    # torch.addmv on the CSR matrix against residual and add
    for l in (0, 1):
        lv = sa._levels[l]
        ops = sa._ops[l]
        A = ops[0] if ops[0] is not None else sparse.EllOperator(
            lv.A_cols, lv.A_vals, lv.om_dinv.shape[0])
        for name, op, mode in (("A", A, "residual"), ("P", ops[1], "add")):
            x, b = vectors(op)
            rr = torch.arange(op.n, device=dev)[:, None].expand_as(op.cols)
            M = cs.csr_of(rr.reshape(-1), op.cols.reshape(-1),
                          op.vals.reshape(-1), (op.n, op.ncols))
            lib = cs.ELL_LIBRARY[mode]
            want = sparse.ell_spmv_ref(op.cols, op.vals, x, b, None, mode)
            emit({"what": "addmv", "op": f"star {name}{l} {mode}",
                  "kernel_ms": cs.cuda_ms(lambda: op(x, b, mode=mode), 200),
                  "addmv_ms": cs.cuda_ms(lambda: lib(M, x, b), 200),
                  "addmv_rel_diff": cs.rel_diff(lib(M, x, b), want)})


if __name__ == "__main__":
    main()
