#!/usr/bin/env python3
"""Times K9 (the Nitsche interface tangent block) at other layouts and
by parts beside the port's kernel on one CUDA card:

    python scripts/k9_designs.py [--out FILE]

builds scripts/k9_designs.cu (which includes the port's
csrc/shell_nitsche.cu) with nvcc (sm_90a, -Xptxas -v) into
build/k9_designs/, prints the registers, stack frame and spills ptxas
reports for K9 (and K8) of both types, and calls it through ctypes on the
two-patch Nitsche solver's fine interface (768 points, m = 2,376) at
chip_smoke's seeded state, f64 and f32: the port's kernel at 1, 2 and, in
f32, 4 points a block, its staging alone, and its
staging and column passes without the scatter, and at 1 and 3
coefficients a thread.  One JSON line a type
(also appended to --out): each variant's CUDA-event ms and device ms of
every device event of a call (chip_smoke's cuda_ms, library_device_ms;
the K variants include the zeroing of K), and the full variants' largest
difference from the port's wrapper, relative to its largest entry.
Without a CUDA device it raises.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_info(text):
    """{function: {stack, spill_stores, spill_loads[, registers]}} from
    ptxas -v: each "Function properties for F" line is followed by F's
    stack and spills, and an entry function's by its registers."""
    info, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            info[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            info[name].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            info[name]["registers"] = int(m.group(1))
    return info


def build(dbl):
    """The float64 (``dbl``) or float32 library and its ptxas report."""
    out = os.path.join(HERE, "build", "k9_designs")
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out, f"libk9_designs_{'f64' if dbl else 'f32'}.so")
    run = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-Xptxas", "-v", "-o", lib]
                         + (["-DK9_DOUBLE"] if dbl else [])
                         + [os.path.join(HERE, "scripts", "k9_designs.cu")],
                         capture_output=True, text=True, check=True)
    return ctypes.CDLL(lib), ptxas_info(run.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # the two types' libraries build side by side
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as ex:
        built = dict(zip((True, False), ex.map(build, (True, False))))
    lines = [{"card": card, "ptxas": {k: v for _, info in built.values()
                                      for k, v in info.items()
                                      if "nitsche" in k}}]
    dev = torch.device("cuda")
    ns, _, _ = cs.build_two_patch(dev, coupling="nitsche")
    cpl = ns.couplings[0]
    U64 = cs.mp_smooth_state(ns)
    idx, pos_a, pos_b = cpl.support_positions()
    P = ctypes.c_void_p
    for dt in (torch.float64, torch.float32):
        c = cpl.astype(dt)
        us = U64.to(dt)[idx.long()].contiguous()
        sa, sb, consts = c._kernel_args(us, c.params)
        nq, m = c.wq.numel(), idx.numel()
        keep = [t.contiguous() for t in sa + sb] + [pos_a.contiguous(),
                                                    pos_b.contiguous()]
        ta = (P * 10)(*[P(t.data_ptr()) for t in [keep[20]] + keep[1:10]])
        tb = (P * 10)(*[P(t.data_ptr()) for t in [keep[21]] + keep[11:20]])
        cs_arr = (ctypes.c_double * 8)(*consts)
        wq, sj = c.wq.contiguous(), c.surfJ.contiguous()
        port = c.tangent_block_cuda(us, pos_a, pos_b, c.params)
        scale = float(port.abs().max())
        rec = {"dtype": str(dt)[6:], "nq": nq, "m": m, "card": card}

        def variant(np_, T, v):
            def call():
                out = (torch.zeros((m, m), dtype=dt, device=dev) if v == 0
                       else torch.empty(nq * 54, dtype=dt, device=dev))
                e = built[dt == torch.float64][0].k9_launch(
                    int(dt == torch.float64), np_, T, v, nq, m, ta, tb,
                    P(wq.data_ptr()), P(sj.data_ptr()), P(us.data_ptr()),
                    cs_arr, P(out.data_ptr()))
                assert e == 0, e
                return out
            return call

        runs = {"port (wrapper)": lambda: c.tangent_block_cuda(
            us, pos_a, pos_b, c.params)}
        shapes = (((1, 1), (2, 1), (2, 3)) if dt == torch.float64 else
                  ((1, 1), (2, 1), (4, 1), (2, 3)))
        for np_, T in shapes:
            runs[f"NP={np_} T={T}"] = variant(np_, T, 0)
        runs["NP=2 no scatter"] = variant(2, 1, 2)
        runs["NP=2 staging only"] = variant(2, 1, 1)
        for name, fn in runs.items():
            y = fn()
            torch.cuda.synchronize()
            err = (float((y - port).abs().max()) / scale
                   if y.shape == port.shape else None)
            reps = 20 if dt == torch.float64 else 50
            rec[name] = dict(ms=cs.cuda_ms(fn, reps),
                             device_ms=cs.library_device_ms(fn, reps)[0],
                             rel_err=err)
        lines.append(rec)
    for rec in lines:
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
