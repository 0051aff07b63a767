#!/usr/bin/env python3
"""Times K13 / K14 designs beside the port's kernels on one CUDA card
(float32, the reef-knot path's type):

    python scripts/k14_designs.py [--state-b FILE] [--out FILE]

builds scripts/k14_designs.cu (the design K14 had before its bit mask
and culling, with ablations, and the port's csrc/contact_pairs.cu at
other row-tile counts (1, 2, 4, 8) and splits, and without its cull) with nvcc (sm_90a)
into build/k14_designs/ and calls it through ctypes on the reef-knot
demo's 9,604 points: at state (a) (chip_smoke.RK_ACTIVE, U and W as
chip_smoke.contact_early) and, given FILE (the U that
``compare_trees.py --what k14_k9_part --part "reef knot"`` saves as
build/k14_state_b.pt), at state (b), the demo's own contact after its
first step.  One JSON line a state (also appended to --out): each
design's CUDA-event ms and device ms of every device event of a call
(chip_smoke's cuda_ms, library_device_ms), and the largest difference of
its output from the port's, relative to the port's largest entry (None
where the port's output is zero, and for the ablations, which compute
something else).  Without a CUDA device it raises.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build():
    out = os.path.join(HERE, "build", "k14_designs")
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out, "libk14_designs.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, os.path.join(HERE, "scripts",
                                            "k14_designs.cu")], check=True)
    return ctypes.CDLL(lib)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--state-b", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import chip_smoke as cs
    from tigar_tpu_torch.contact import PointContact
    from tigar_tpu_torch.demos import reef_knot_contact as demo
    from tigar_tpu_torch.ops import contact as oc
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = build()
    dev = torch.device("cuda")
    sp = demo.build_spline(cs.RK_NEL, dev)
    rng = np.random.default_rng(0)
    states = [("(a)", PointContact(sp, **cs.RK_ACTIVE),
               torch.as_tensor(rng.normal(size=sp.ndof) * 0.01, device=dev),
               torch.as_tensor(rng.normal(size=sp.ndof), device=dev))]
    if args.state_b:
        states.append(("(b)", PointContact(sp, **demo.CONTACT),
                       torch.load(args.state_b).to(dev),
                       torch.as_tensor(np.random.default_rng(1).normal(
                           size=sp.ndof), device=dev)))
    P = ctypes.c_void_p
    f32 = ctypes.c_float
    for label, c0, U, W in states:
        c = c0.astype(torch.float32)
        x = c.positions(U.float()).contiguous()
        v = c._apply_P(W.float()).contiguous()
        w, n = c.quad_w.contiguous(), x.shape[0]
        bits = c.pair_bits
        ones = torch.ones_like(bits.tiles)
        mask, ld = c.pair_mask, c.pair_mask.stride(0)
        out = torch.empty_like(x)
        rec = {"state": label, "card": card, "n": n,
               "tiles_kept": int((~oc.culled_tile_pairs(
                   x, bits, c.r_max)).sum()),
               "tile_pairs": bits.tiles.numel()}
        for kname, vv in (("K13", None), ("K14", v)):
            port = (oc.contact_hvp(x, v, w, mask, c.k, c.r_max, bits=bits)
                    if vv is not None else
                    oc.contact_forces(x, w, mask, c.k, c.r_max, bits=bits))
            scale = float(port.abs().max())
            vp = P(vv.data_ptr()) if vv is not None else None

            def old(mode, vp=vp):
                e = lib.k14_old(mode, n, ctypes.c_longlong(ld),
                                P(mask.data_ptr()), P(x.data_ptr()), vp,
                                P(w.data_ptr()), f32(c.k), f32(c.r_max),
                                P(out.data_ptr()))
                assert e == 0, e

            def new(R, nsplit, cull, vp=vp):
                ng = lib.k14_groups(n, R)
                boxes = torch.empty(((n + 31) // 32, 6), device=dev)
                part = torch.empty(max(nsplit * n * 3, 1), device=dev)
                done = torch.zeros(ng, dtype=torch.int32, device=dev)
                tl = bits.tiles if cull else ones

                def call():
                    e = lib.k14_new(R, nsplit, cull, n,
                                    P(bits.words.data_ptr()),
                                    P(tl.data_ptr()), P(x.data_ptr()), vp,
                                    P(w.data_ptr()), f32(c.k), f32(c.r_max),
                                    P(boxes.data_ptr()), P(part.data_ptr()),
                                    P(done.data_ptr()), P(out.data_ptr()))
                    assert e == 0, e
                return call

            designs = {f"old mode {m}": (lambda m=m: old(m)) for m in
                       (0, 1, 2)}
            designs["port (wrapper)"] = (
                (lambda: oc.contact_hvp(x, v, w, mask, c.k, c.r_max,
                                        bits=bits)) if vv is not None else
                (lambda: oc.contact_forces(x, w, mask, c.k, c.r_max,
                                           bits=bits)))
            ns4 = max(1, min(-(-16 * 132 // (lib.k14_groups(n, 4) * 4)),
                             (n + 31) // 32))
            for R in (1, 2, 4, 8):
                nsR = max(1, min(-(-16 * 132 // (lib.k14_groups(n, R) * 4)),
                                 (n + 31) // 32))
                designs[f"R={R} splits={nsR}"] = new(R, nsR, 1)
            for R, nsR in ((2, 8), (2, 16), (1, 4)):
                designs[f"R={R} splits={nsR}"] = new(R, nsR, 1)
            designs["R=4 splits=1"] = new(4, 1, 1)
            designs[f"R=4 splits={ns4} no cull"] = new(4, ns4, 0)
            res = {}
            for name, fn in designs.items():
                fn()
                torch.cuda.synchronize()
                err = (None if scale == 0.0 or name.startswith("old mode 1")
                       or name.startswith("old mode 2") else
                       float((out - port).abs().max()) / scale
                       if not name.startswith("port") else 0.0)
                res[name] = dict(ms=cs.cuda_ms(fn, 50),
                                 device_ms=cs.library_device_ms(fn, 50)[0],
                                 rel_err=err)
            rec[kname] = res
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
