"""K8's backward (`csrc/swin_block_train.cu`: mlp_bwd, attn_bwd, the weight
gradients and the fixed-order sums) of one checkout of the port, timed on
one card by kernel, for comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/swin_block_bwd_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timers (the bounds are this script's checkout's
`utils/kernel_bounds.py`, so an older ROOT is held to the same ones). The
script builds ROOT's `swin_block_train` library anew and prints what `-Xptxas -v`
says of `attn_bwd_kernel` and `mlp_bwd_kernel` at C = 64, 128 and 256
(registers, spills, static shared memory, and any C7518 line: wgmma
serialized), the dynamic shared memory and resident blocks an SM the
runtime reports for them, and mlp_bwd's grid, blocks an SM and waves at
each width's window count (where the library exports
`fm_swin_block_train_bwd_occupancy`), then, at the six sites of
`chip_smoke.check_swin_block_train` (the training step's 13 blocks: C = 64,
128 and 256 without and with the shift mask and drop-path scales):
  - the backward's device time by kernel (the profiler over REPS calls
    after a warm-up, per call), attn_bwd's and mlp_bwd's each beside its own
    bound (`kernel_bounds.swin_block_train_attn_bwd_work`,
    `swin_block_train_mlp_bwd_work`);
  - the whole backward by CUDA events (ITERS calls after a warm-up);
  - each summed over the step's 13 launches.
With --check it first holds the backward against the plain twin's autograd
at each site (out, dx and the 13 gradients within chip_smoke.K8_TOL of each
tensor's max) and exits 1 on a disagreement. Run one tree after another in
one call on one card (old, new, new, old).
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
from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops import swin_block_train as sbt
from featurematching_tpu_torch.ops.swin_block_train import (
    PARAM_KEYS,
    _kernel_params,
    swin_block_train_bwd,
    swin_block_train_fwd,
    swin_block_train_reference,
)

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", Path(__file__).resolve().parents[1] / "featurematching_tpu_torch" / "utils"
    / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS, REPS = 20, 10
SM_REGS, THREADS = 65536, 256
# (windows, C, heads, padded map, launches a step without / with the mask)
SITES = [(2400, 64, 4, (120, 160), 2, 1), (640, 128, 8, (64, 80), 2, 1),
         (160, 256, 16, (32, 40), 4, 3)]


def ptxas_report(log: str) -> None:
    """attn_bwd's and mlp_bwd's registers, spills and static shared memory
    from ptxas, the blocks an SM the registers allow at 256 threads, and
    ptxas's C7518 lines (wgmma serialized), or that it printed none."""
    lines = log.splitlines()
    c7518 = [x.strip() for x in lines if "C7518" in x]
    print(f"  C7518 (wgmma serialized): {len(c7518)} lines" + "".join(f"\n    {x}" for x in c7518))
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?((?:attn|mlp)_bwd_kernel)ILi(\d+)E", line)
        if not m:
            continue
        info = " ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 1:i + 4]
                        if "Compiling" not in x and "Function properties" not in x)
        regs = re.search(r"Used (\d+) registers", info)
        r = int(regs.group(1)) if regs else 0
        by_regs = SM_REGS // (-(-r // 8) * 8 * THREADS) if r else 0
        print(f"  {m.group(1)}<{m.group(2)}>: {info} -> {by_regs} blocks an SM by registers")


def mlp_blocks(nwin: int, per_sm: int, sms: int) -> int:
    """mlp_bwd's grid in this tree: its own (`mlp_grid`) where it has one,
    else attn_bwd's min(windows, MAX_BLOCKS)."""
    if hasattr(sbt, "mlp_grid"):
        return sbt.mlp_grid(nwin, per_sm, sms)
    return min(nwin, sbt.MAX_BLOCKS)


def occupancy_report() -> None:
    lib = _build._load("swin_block_train")
    if not hasattr(lib, "fm_swin_block_train_bwd_occupancy"):
        print("  occupancy: not exported by this tree's library")
        return
    fn = lib.fm_swin_block_train_bwd_occupancy
    # a tree whose kernels take more than head dim 16 takes it as an argument
    with_dim = hasattr(sbt, "HEAD_DIMS")
    fn.argtypes = [_build.INT] * (1 + with_dim) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = _build.INT
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nwin, C, *_ in SITES:
        info = (ctypes.c_int * 4)()
        err = fn(C, 16, info) if with_dim else fn(C, info)
        if err:
            raise RuntimeError(f"fm_swin_block_train_bwd_occupancy({C}): CUDA error {err}")
        grid = mlp_blocks(nwin, info[3], sms)
        slots = info[3] * sms  # blocks resident at once
        waves = -(-grid // slots) * -(-nwin // grid)  # a window a block at a time
        print(f"  C={C}: attn_bwd {info[0]} bytes of dynamic shared memory, {info[1]} blocks an "
              f"SM; mlp_bwd {info[2]} bytes, {info[3]} blocks an SM; mlp_bwd's grid at {nwin} "
              f"windows: {grid} blocks, {slots} resident on {sms} SMs, {waves} waves of a "
              f"window a block, fill {nwin / (waves * slots):.0%}")


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
        k = re.split(r"[<(]", bare)[0]
        split[k] = split.get(k, 0.0) + e.device_time_total / 1e3 / REPS
    return split


def check(x, m, a, b, p, h, gout, kp) -> dict:
    """Relative errors of out, dx and the 13 gradients against the twin."""
    out, probs, x1 = swin_block_train_fwd(x, m, a, b, kp, h)
    dx, grads = swin_block_train_bwd(x, a, b, probs, x1, gout, kp, h)
    torch.cuda.synchronize()
    xr = x.detach().requires_grad_(True)
    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    ref = swin_block_train_reference(xr, m, a, b, pr, h)
    ref.backward(gout)
    errs = {"out": cs.rel_err(out, ref), "dx": cs.rel_err(dx, xr.grad)}
    errs |= {k: cs.rel_err(gr, pr[k].grad) for k, gr in zip(PARAM_KEYS, grads)}
    return errs


def main() -> int:
    do_check = "--check" in sys.argv[1:]
    t = time.time()
    _build._lib_path("swin_block_train").unlink(missing_ok=True)  # rebuilt, so ptxas reports
    logs = _build.build(["swin_block_train"], ptxas_verbose=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{_build.CSRC.parent.parent}] build {time.time() - t:.1f} s; card {card}", flush=True)
    ptxas_report(logs.get("swin_block_train", ""))
    occupancy_report()
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(attn=0.0, attn_bound=0.0, mlp=0.0, mlp_bound=0.0, bwd=0.0, bwd_bound=0.0)
    kernels = {}
    for nwin, C, h, (Hp, Wp), n_plain, n_mask in SITES:
        x = cs.rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        gout = cs.rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        p = cs.block_params(g, C, h)
        kp = _kernel_params(p, C, h)
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, 4), device="cuda")
        per_img = mask.shape[0]
        keep = 0.8
        draws = torch.rand(2, nwin // per_img, generator=g, device="cuda") < keep
        draws[:, 0], draws[:, 1] = False, True
        s1, s2 = (draws.float() / keep).repeat_interleave(per_img, dim=1)
        for m, a, b, count in ((None, None, None, n_plain), (mask, s1, s2, n_mask)):
            site = f"C={C} windows={nwin} mask={m is not None}"
            if do_check:
                errs = check(x, m, a, b, p, h, gout, kp)
                worst = max(errs, key=errs.get)
                print(f"  check {site}: out {errs['out']:.2e}, dx {errs['dx']:.2e}, worst "
                      f"{worst} {errs[worst]:.2e} (limit {cs.K8_TOL})", flush=True)
                if not all(v <= cs.K8_TOL for v in errs.values()):
                    return 1
            _, probs, x1 = swin_block_train_fwd(x, m, a, b, kp, h)
            bwd = lambda: swin_block_train_bwd(x, a, b, probs, x1, gout, kp, h)  # noqa: E731
            split = by_kernel(bwd)
            whole = cs.cuda_ms(bwd, iters=ITERS)
            nw = 0 if m is None else m.shape[0]
            ab, aby = kb.bound_ms(*kb.swin_block_train_attn_bwd_work(nwin, C, h, nw))
            mb, mby = kb.bound_ms(*kb.swin_block_train_mlp_bwd_work(nwin, C, h, nw))
            wb, _ = kb.bound_ms(*kb.swin_block_train_bwd_work(nwin, C, h, nw))
            attn = split.get("attn_bwd_kernel", 0.0)
            mlp = split.get("mlp_bwd_kernel", 0.0)
            totals["attn"] += count * attn
            totals["attn_bound"] += count * ab
            totals["mlp"] += count * mlp
            totals["mlp_bound"] += count * mb
            totals["bwd"] += count * whole
            totals["bwd_bound"] += count * wb
            for k, v in split.items():
                kernels[k] = kernels.get(k, 0.0) + count * v
            print(f"  {site} x{count}: backward {whole:.4f} ms (bound {wb:.4f}); attn_bwd "
                  f"{attn:.4f} ms against its bound {ab:.4f} ms ({aby}, {attn / ab:.1f}x); "
                  f"mlp_bwd {mlp:.4f} ms against its bound {mb:.4f} ms ({mby}, {mlp / mb:.1f}x); "
                  "by kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(f"  13 launches: attn_bwd {totals['attn']:.4f} ms (bound {totals['attn_bound']:.4f} ms); "
          f"mlp_bwd {totals['mlp']:.4f} ms (bound {totals['mlp_bound']:.4f} ms); "
          f"K8 backward {totals['bwd']:.4f} ms (bound {totals['bwd_bound']:.4f} ms); by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
