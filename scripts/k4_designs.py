#!/usr/bin/env python3
"""Times the designs of K4 (the sum-factorized apply) that were measured
and not kept against the port's kernel, on one CUDA card:

    python scripts/k4_designs.py [--out FILE]

builds scripts/k4_designs.cu (which includes the port's
csrc/sumfac_apply.cu) with nvcc (sm_90a) into build/k4_designs/ and runs
each design on every grid of the 96^3 Poisson path's hierarchy (96^3 ...
6^3, p = 2, quadrature degree 4, identity geometry, the Dirichlet mask;
chip_smoke.py's ``poisson_levels``), f32 and f64, with seeded
coefficients: the port's kernel (one thread an element, 27 global atomics
an element, memset and BC epilogue), "generic" (the same design built
from the generic element arithmetic that every other design runs),
"generic_compute" (its loads and arithmetic alone), "fused" ("generic"
with an init launch and masked atomics instead of the two passes),
"split" ("fused", three threads an element, one a q_0 slice), the tile
designs at 8x4x4 elements a block: "shared_atomics" (the staged window
and shared atomics into a window of sums; also at 8x8x4, 16x4x2 and
32x4x2), "tile_global" (that with global atomics), "tile_nostage" (that
without the staged window), "gather" (the window slots summing the
elements' results, no atomics), "unrolled" (the arithmetic unrolled,
tables and coefficients in registers), and "tile_split" (unrolled, three
threads an element, on 8x4x2 tiles).  It prints one JSON line a grid and type (also
appended to FILE): each design's CUDA-event ms a call over back-to-back
calls through ctypes, its device ms a call (torch.profiler, every device
event of the call; None unless sessions of 10 and of the timed calls
record the same whole number a call) and its max error against the plain
version relative to the largest entry, with the operations bound.
Without a CUDA device it raises.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the designs without tiles, and the tile designs (at TILES[0])
DESIGNS = ("port", "generic", "generic_compute", "fused", "split")
TILED = ("shared_atomics", "tile_global", "tile_nostage", "gather",
         "unrolled")
# the tile design's tiles (direction 0 first): "shared_atomics" at each
TILES = ((8, 4, 4), (8, 8, 4), (16, 4, 2), (32, 4, 2))


def build():
    out = os.path.join(HERE, "build", "k4_designs")
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(out, "libk4_designs.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v", "-o", lib,
                    os.path.join(HERE, "scripts", "k4_designs.cu")],
                   check=True)
    so = ctypes.CDLL(lib)
    for f in (so.k4_design_f32, so.k4_design_f64):
        f.argtypes = ([ctypes.c_char_p] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 12
                      + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 2)
    return so


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import chip_smoke as cs
    from tigar_tpu_torch.ops.sumfac import build_sumfac_data, sumfac_apply_ref
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    so = build()
    dev = torch.device("cuda")
    bases, masks = cs.poisson_levels(cs.NEL3)
    rng = np.random.default_rng(2)

    def ints(x):
        return (ctypes.c_int * 3)(*x)

    def ptrs(ts):
        return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])

    for basis, mask_np in zip(bases, masks):
        W64 = torch.as_tensor(rng.normal(size=basis.ncp), device=dev)
        for dt in (torch.float32, torch.float64):
            data = build_sumfac_data(basis, None, cs.QD3, dev, dt)
            W, m = W64.to(dt), torch.as_tensor(mask_np, device=dev).to(dt)
            ref = sumfac_apply_ref(data, W, 1.0, 0.0, m)
            scale = float(ref.abs().max())
            tile, win = k4_plan_for(data, TILES[0])
            fn = so.k4_design_f32 if dt == torch.float32 else \
                so.k4_design_f64
            keep = [ints(data.nel_d), ints(data.ncp_d), ptrs(data.B),
                    ptrs(data.D), ptrs(data.starts), ptrs(data.w)]
            r = torch.empty_like(W)

            def call(what, tl, wn):
                stream = torch.cuda.current_stream().cuda_stream
                err = fn(what.encode(), 3, data.degrees[0] + 1, data.nq,
                         keep[0], keep[1], ints(tl), ints(wn), keep[2],
                         keep[3], keep[4], keep[5], None, None,
                         W.data_ptr(), m.data_ptr(), 1.0, 0.0,
                         r.data_ptr(), stream)
                if err:
                    raise SystemExit(f"{what} tile {tl}: CUDA error {err}")

            rec = {"grid": f"{basis.nel_per_dir[0]}^3",
                   "dtype": str(dt)[6:], "card": card, "tile": [tile, win],
                   "bound_ms": cs.bound(cs.nbytes(W, m, W), cs.sumfac_flops(
                       data), dt)[0]}
            reps = 200 if basis.nel_per_dir[0] >= 48 else 500
            runs = [(d, tile, win) for d in DESIGNS + TILED]
            split = k4_plan_for(data, (8, 4, 2))   # 3 x 64 threads
            if split is not None:
                runs.append(("tile_split",) + split)
            for t in TILES[1:]:
                d = k4_plan_for(data, t)
                if d is not None and d[0] != tile:
                    runs.append(("shared_atomics",) + d)
            seen = set()
            for what, tl, wn in runs:
                key = what
                if what == "shared_atomics" and what in seen:
                    key = f"{what} " + "x".join(map(str, tl))
                seen.add(what)
                call(what, tl, wn)
                torch.cuda.synchronize()
                err = (None if what == "generic_compute" else
                       float((r - ref).abs().max()) / scale)
                ms = cs.cuda_ms(lambda: call(what, tl, wn), reps)
                dev_ms = cs.library_device_ms(
                    lambda: call(what, tl, wn), reps)[0]
                rec[key] = dict(ms=ms, device_ms=dev_ms, max_rel_err=err)
            text = json.dumps(rec)
            print(text, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(text + "\n")


def k4_plan_for(data, tile):
    """(tile, windows) of a tile design's tile shape (direction 0 first),
    clipped to the grid: per direction the largest window of any tile,
    starts[last] - starts[first] + p + 1; None past 256 threads."""
    import numpy as np
    tile = [max(1, min(t, n)) for t, n in zip(tile, data.nel_d)]
    if int(np.prod(tile)) > 256:
        return None
    win = []
    for s, t, p in zip(data.starts, tile, data.degrees):
        s = s.cpu().numpy().astype(np.int64)
        first = np.arange(0, len(s), t)
        last = np.minimum(first + t, len(s)) - 1
        win.append(int(np.max(s[last] - s[first])) + p + 1)
    return tile, win


if __name__ == "__main__":
    main()
