#!/usr/bin/env python3
"""Three experiments on the torch.profiler crash over K9 (the Nitsche
interface tangent block kernel of tigar_tpu_torch) on one NVIDIA card.

    python3 scripts/k9_profile_check.py [bounds|sessions|standin]

With no argument all three run, in this order.  Each run is a child
process: its exit code (-11 = segmentation fault) and its last lines are
the result, and the whole log goes to build/k9_profile.log.

1. bounds.  The port's kernels are built with ``-DTIGAR_BOUNDS_CHECK``
   (device-side checks of every support position and DoF index K8/K9
   load, and of the indices into their staged point data and the tangent
   block; a failed check prints ``TIGAR_ASSERT failed`` and traps).  A
   control first: K9 on the small Nitsche plate with one support position
   out of range must fail with that message, which shows the checks are
   compiled in.  Then chip_smoke.py runs in its own order -- the kernel
   phases, the main paths, the profiler sessions over the timed kernels --
   with K9 back in those sessions.  A crash without a failed check rules
   out those accesses.
2. sessions.  For N = 0, 1, 2, 4 and 16, a fresh process builds bench.py's
   Nitsche two-patch point (the fine interface: 768 points), runs K9 and
   its plain version once in f64 and f32 (as chip_smoke.py's comparison
   does), then N profiler sessions over a trivial kernel (an elementwise
   product), then one profiler session over K9 in each type; once more
   with 4 sessions over K8 (the Nitsche residual kernel, built from the
   same source) in place of the trivial kernel.
3. standin.  chip_smoke.py runs in its own order with K9 back in its
   profiler sessions, except that when the K9 entries come up a stand-in
   kernel (scripts/k9_dummy_kernel.cu: K9's launch shape, its static
   shared memory and its per-thread local frame, read with ``cuobjdump
   -res-usage`` from the built extension; 100,000 loop iterations, 3.4 s
   a launch on an H100) is profiled in K9's place first; K9 itself is
   profiled right after.
   The stand-in is built with nvcc and launched through ctypes, not
   through the extension.

``faulthandler`` prints the Python stack of a crash.  Without a CUDA
device it raises.
"""

import ctypes
import faulthandler
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LOG = os.path.join(ROOT, "build", "k9_profile.log")
DUMMY_DIR = os.path.join(ROOT, "build", "k9_dummy")
K9_PHASE = "nitsche_iface_tangent"   # chip_smoke's record of K9's phases


def control():
    """K9 with pos_a[0, 0, 0] = m (one past the support): must trap."""
    from tigar_tpu_torch.config import require_cuda
    device = require_cuda()
    ns, cpl, _ = cs.build_two_patch(device, cs.TP_REF["nel"], bench=False,
                                    coupling="nitsche")
    idx, pos_a, pos_b = cpl.support_positions()
    bad = pos_a.clone()
    bad[0, 0, 0] = idx.numel()
    cpl.tangent_block_cuda(ns.mask64[idx.long()], bad, pos_b, cpl.params)
    torch.cuda.synchronize()


def profiled_smoke():
    """chip_smoke.py in its own order, K9 in its profiler sessions."""
    cs.PROFILE_K9 = True
    cs.main()


def sessions(n, over):
    from tigar_tpu_torch.config import require_cuda
    from tigar_tpu_torch.interface import iform_tangent_block_ref
    device = require_cuda()
    ns, cpl, _ = cs.build_two_patch(device, coupling="nitsche")
    idx, pos_a, pos_b = cpl.support_positions()
    U = cs.mp_smooth_state(ns)
    k9 = {}
    for dt in (torch.float64, torch.float32):
        c, us = cpl.astype(dt), U[idx.long()].to(dt)
        k9[dt] = (lambda c=c, us=us: c.tangent_block_cuda(us, pos_a, pos_b,
                                                         c.params))
        k9[dt]()
        iform_tangent_block_ref(c, us, pos_a, pos_b, c.params)
    torch.cuda.synchronize()
    x = torch.ones(1 << 20, device=device)
    fn, match = {"trivial": (lambda: x.mul_(1.0), "elementwise"),
                 "k8": (lambda: cpl.residual(U),
                        "nitsche_residual_kernel")}[over]
    for i in range(n):
        ms, _ = cs.device_ms(fn, 5, match)
        print(f"{over} session {i + 1}: {ms} ms", flush=True)
    for dt, fn in k9.items():
        ms, _ = cs.device_ms(fn, 3, "nitsche_tangent_kernel")
        print(f"K9 {dt} profiled: {ms:.4f} ms a call", flush=True)
    print("SESSIONS CHILD OK", flush=True)


def res_usage(so, name):
    """{instantiation: (static shared bytes, stack bytes)} of the kernels
    whose mangled name contains ``name`` (cuobjdump -res-usage)."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-res-usage", so],
                         capture_output=True, text=True, check=True).stdout
    found, fn = {}, None
    for line in out.splitlines():
        if line.strip().startswith("Function"):
            fn = line.strip()[len("Function"):].strip(" :")
        elif fn and name in fn and "SHARED" in line:
            shared = int(re.search(r"SHARED:(\d+)", line).group(1))
            stack = int(re.search(r"STACK:(\d+)", line).group(1))
            found[fn] = (shared, stack)
    if not found:
        raise SystemExit(f"no kernel named {name} in {so}")
    return found


def standin():
    from tigar_tpu_torch.ops import cuda_ext
    cuda_ext.load()
    so = [os.path.join(cuda_ext.BUILD_DIR, f)
          for f in os.listdir(cuda_ext.BUILD_DIR) if f.endswith(".so")][0]
    usage = res_usage(so, "nitsche_tangent_kernel")
    for fn, (shared, stack) in usage.items():
        print(f"K9 resources: {fn}: static shared {shared} B, stack "
              f"{stack} B", flush=True)
    shared, stack = max(usage.values(), key=lambda v: v[1])
    os.makedirs(DUMMY_DIR, exist_ok=True)
    lib = os.path.join(DUMMY_DIR, "libk9dummy.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-gencode", "arch=compute_90a,code=sm_90a",
                    f"-DK9_SMEM={shared}", f"-DK9_STACK={max(stack, 64)}",
                    "-o", lib,
                    os.path.join(ROOT, "scripts", "k9_dummy_kernel.cu")],
                   check=True)
    dl = ctypes.CDLL(lib)
    dl.k9_dummy_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    dl.k9_dummy_launch.restype = ctypes.c_int
    out = torch.zeros(768, device="cuda")

    def dummy():
        err = dl.k9_dummy_launch(out.data_ptr(), 768, 100000,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stand-in launch failed: {err}")

    print(f"stand-in: {cs.cuda_ms(dummy, 3):.4f} ms a launch (CUDA "
          f"events)", flush=True)
    times = cs.kernel_device_times

    def kernel_device_times(rec):
        # chip_smoke keeps (fn, reps, match) under "probe"
        k9 = [p for p in rec.get(K9_PHASE, []) if "probe" in p]
        if not k9:
            raise SystemExit(f"chip_smoke recorded no profiled {K9_PHASE}")
        saved = [p["probe"] for p in k9]
        for p in k9:
            p["probe"] = (dummy, p["probe"][1], "k9_dummy_kernel")
        times(rec)
        print("STAND-IN PROFILED in K9's place: no crash", flush=True)
        for p, probe in zip(k9, saved):
            p["probe"] = probe
        times({K9_PHASE: k9})
        print("K9 PROFILED after the stand-in: no crash", flush=True)

    cs.kernel_device_times = kernel_device_times
    profiled_smoke()


def run_child(args, log, env=None):
    r = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                       capture_output=True, text=True, timeout=1500,
                       env=env)
    log.write(f"==== {' '.join(args)}: exit {r.returncode}\n{r.stdout}\n"
              f"{r.stderr}\n")
    log.flush()
    text = r.stdout + r.stderr
    tail = [ln for ln in text.splitlines() if ln.strip()]
    print(f"{' '.join(args)}: exit {r.returncode}; last lines: {tail[-6:]}",
          flush=True)
    return r.returncode, text


def main(which):
    from tigar_tpu_torch.config import require_cuda
    require_cuda()
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    with open(LOG, "w") as log:
        if "bounds" in which:
            env = dict(os.environ, TIGAR_BOUNDS_CHECK="1")
            rc, text = run_child(["control"], log, env)
            fired = "TIGAR_ASSERT failed" in text
            print(f"bounds-check control: check fired: {fired}", flush=True)
            if rc == 0 or not fired:
                raise SystemExit("the bounds checks are not active")
            run_child(["profiled-smoke"], log, env)
        if "sessions" in which:
            for n, over in ((0, "trivial"), (1, "trivial"), (2, "trivial"),
                            (4, "trivial"), (16, "trivial"), (4, "k8")):
                run_child(["sessions-child", str(n), over], log)
        if "standin" in which:
            run_child(["standin-child"], log)


if __name__ == "__main__":
    faulthandler.enable()
    args = sys.argv[1:]
    if args == ["control"]:
        control()
    elif args == ["profiled-smoke"]:
        profiled_smoke()
    elif args[:1] == ["sessions-child"]:
        sessions(int(args[1]), args[2])
    elif args == ["standin-child"]:
        standin()
    elif len(args) <= 1 and set(args) <= {"bounds", "sessions", "standin"}:
        main(args or ["bounds", "sessions", "standin"])
    else:
        raise SystemExit(__doc__)
