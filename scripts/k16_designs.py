#!/usr/bin/env python3
"""Times the designs of K16 that were tried and not kept (pass 1 staged
through shared memory with cp.async, and its ablations; pass 2 with
32-bit index math and without its register list of candidates) against
the port's pass 1 and pass 2, on one CUDA card:

    python scripts/k16_designs.py [--out FILE]

builds scripts/k16_designs.cu (which includes the port's
csrc/sumfac_jets.cu) with nvcc (sm_90a) into build/k16_designs/ and runs
it: on the 24^3 drop-1 Poisson field (3D, nders 1, stride 2) and the
128^2 shell's three fields (2D, nders 2), f64 and f32, with seeded
tables and cotangents, it prints one JSON line a case (also appended to
FILE) with each kernel's CUDA-event ms a launch over 200 back-to-back
launches, the staged design's largest difference from the port's
element-local slots and the pass-2 variants' from the port's output, each
relative to the largest entry.  Without a CUDA device it
raises.
"""

import argparse
import json
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = os.path.join(HERE, "build", "k16_designs")
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    exe = os.path.join(out, "k16_designs")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", exe,
                    os.path.join(HERE, "scripts", "k16_designs.cu")],
                   check=True)
    run = subprocess.run([exe], capture_output=True, text=True, check=True)
    for line in run.stdout.splitlines():
        rec = dict(json.loads(line), card=card)
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
