"""K9's backward (`csrc/coarse_transformer_train.cu`: apply_bwd, bwd_merge,
stats_bwd, the weight gradients and the fixed-order sums) of one checkout
of the port, timed on one card by kernel, for comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/coarse_train_bwd_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timers (the bounds are this script's checkout's
`utils/kernel_bounds.py`, so an older ROOT is held to the same ones). The
script builds ROOT's `coarse_transformer_train` library anew and prints what
`-Xptxas -v` says of `apply_bwd_kernel` at the four (C, head dim) pairs
(registers, spills, static shared memory), its SASS instructions
(cuobjdump), and the dynamic shared memory and resident blocks an SM the
runtime reports for it (where the library exports
`fm_coarse_train_bwd_occupancy`), then, at the training step's self call
[8, 4800, 256] and cross call [4, 4800, 256] (8 heads; the step runs 4 and
8 of them):
  - the backward's device time by kernel (the profiler over REPS calls
    after a warm-up, per call), apply_bwd's beside its own bound
    (`kernel_bounds.coarse_train_apply_bwd_work`);
  - the whole backward by CUDA events (ITERS calls after a warm-up);
  - each summed over the step's 12 calls.
With --check it first holds each call against the plain twin (dx, dsrc and
the 10 gradients within chip_smoke.K9_TOL of each tensor's norm) and exits 1
on a disagreement. Run one tree after another in one call on one card (old,
new, new, old).
"""

import ctypes
import importlib.util
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops import coarse_transformer_train as ctt

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", Path(__file__).resolve().parents[1] / "featurematching_tpu_torch" / "utils"
    / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS, REPS = 20, 10
SM_REGS, THREADS = 65536, 256
N, C, HEADS = 4800, 256, 8
CALLS = [(8, "self", 4), (4, "cross", 8)]  # (images, kind, calls a step)
WIDTHS = [(128, 16), (128, 32), (256, 16), (256, 32)]


def ptxas_report(log: str) -> None:
    """apply_bwd's registers, spills and static shared memory from ptxas, and
    the blocks an SM the registers allow at 256 threads."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?apply_bwd_kernelILi(\d+)ELi(\d+)E", line)
        if not m:
            continue
        info = " ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 1:i + 4]
                        if "Compiling" not in x and "Function properties" not in x)
        regs = re.search(r"Used (\d+) registers", info)
        r = int(regs.group(1)) if regs else 0
        by_regs = SM_REGS // (-(-r // 8) * 8 * THREADS) if r else 0
        print(f"  apply_bwd<{m.group(1)}, {m.group(2)}>: {info} -> {by_regs} blocks an SM by "
              "registers")


def code_report() -> None:
    """apply_bwd's SASS instructions at each (C, D), from cuobjdump."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    lib = _build._lib_path("coarse_transformer_train")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?apply_bwd_kernelILi(\d+)ELi(\d+)E", line)
        if "Function : " in line:
            name = f"apply_bwd<{m.group(1)}, {m.group(2)}>" if m else None
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] = counts.get(name, 0) + 1
    for n, k in sorted(counts.items()):
        print(f"  {n}: {k} SASS instructions ({16 * k} bytes)")


def occupancy_report() -> None:
    lib = _build._load("coarse_transformer_train")
    if not hasattr(lib, "fm_coarse_train_bwd_occupancy"):
        print("  occupancy: not exported by this tree's library")
        return
    fn = lib.fm_coarse_train_bwd_occupancy
    fn.argtypes = [_build.INT, _build.INT, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _build.INT
    for c, d in WIDTHS:
        info = (ctypes.c_int * 2)()
        err = fn(c, d, info)
        if err:
            raise RuntimeError(f"fm_coarse_train_bwd_occupancy({c}, {d}): CUDA error {err}")
        print(f"  C={c}, D={d}: apply_bwd {info[0]} bytes of dynamic shared memory, {info[1]} "
              "blocks an SM")


def by_kernel(fn) -> dict:
    """Device ms of each kernel of one fn() call, by kernel name, from the
    profiler over REPS calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if not cs.is_kernel(e):
            continue
        bare = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
        k = re.split(r"[<(]", bare)[0].split("::")[-1]
        split[k] = split.get(k, 0.0) + e.device_time_total / 1e3 / REPS
    return split


def check(x, src, kv, ks, gout, lv, lt) -> dict:
    """Norm-relative errors of dx, dsrc and the 10 gradients against the twin."""
    got = cs.k9_tensors(None, ctt.coarse_layer_backward(x, src, kv, ks, gout, lv, lt, HEADS))
    torch.cuda.synchronize()
    ref = cs.k9_tensors(None, ctt.coarse_layer_backward_reference(x, src, kv, ks, gout, lv,
                                                                  HEADS))
    return {n: cs.norm_err(got[n], ref[n]) for n in got}


def main() -> int:
    do_check = "--check" in sys.argv[1:]
    t = time.time()
    _build._lib_path("coarse_transformer_train").unlink(missing_ok=True)  # rebuilt: ptxas reports
    logs = _build.build(["coarse_transformer_train"], ptxas_verbose=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{_build.CSRC.parent.parent}] build {time.time() - t:.1f} s; card {card}", flush=True)
    ptxas_report(logs.get("coarse_transformer_train", ""))
    code_report()
    occupancy_report()
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(apply=0.0, apply_bound=0.0, bwd=0.0, bwd_bound=0.0)
    kernels = {}
    for G, kind, count in CALLS:
        lv = cs.layer_values(g, C)
        lt = ctt.train_values(lv)
        x = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        src = x if kind == "self" else cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        gout = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        _, kv, ks = ctt.coarse_layer_forward(x, src, lv, HEADS)
        site = f"{kind} call [{G}, {N}, {C}]"
        if do_check:
            errs = check(x, src, kv, ks, gout, lv, lt)
            worst = max(errs, key=errs.get)
            print(f"  check {site}: dx {errs['dx']:.2e}, dsrc {errs['dsrc']:.2e}, worst {worst} "
                  f"{errs[worst]:.2e} (limit {cs.K9_TOL})", flush=True)
            if not all(v <= cs.K9_TOL for v in errs.values()):
                return 1
        bwd = lambda: ctt.coarse_layer_backward(x, src, kv, ks, gout, lv, lt, HEADS)  # noqa: E731
        split = by_kernel(bwd)
        whole = cs.cuda_ms(bwd, iters=ITERS)
        ab, aby = kb.bound_ms(*kb.coarse_train_apply_bwd_work(G, N, N, C, HEADS))
        wb, _ = kb.bound_ms(*kb.coarse_train_bwd_work(G, N, N, C, HEADS, kind == "self"))
        apply = split.get("apply_bwd_kernel", 0.0)
        totals["apply"] += count * apply
        totals["apply_bound"] += count * ab
        totals["bwd"] += count * whole
        totals["bwd_bound"] += count * wb
        for k, v in split.items():
            kernels[k] = kernels.get(k, 0.0) + count * v
        print(f"  {site} x{count}: backward {whole:.4f} ms (bound {wb:.4f}); apply_bwd "
              f"{apply:.4f} ms against its bound {ab:.4f} ms ({aby}, {apply / ab:.1f}x); "
              "by kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(f"  12 calls: apply_bwd {totals['apply']:.4f} ms (bound {totals['apply_bound']:.4f} "
          f"ms); K9 backward {totals['bwd']:.4f} ms (bound {totals['bwd_bound']:.4f} ms); by "
          "kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
