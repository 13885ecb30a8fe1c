"""The dual-softmax match statistics (K1, `csrc/dual_softmax.cu`) and its
pass 1 alone (`dual_softmax_lse`, the sparse focal loss's forward) of one
checkout of the port, timed on one card for comparing two versions of them.

    PYTHONPATH=ROOT python3 tools/dual_softmax_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the timer and the inputs' form. The script builds ROOT's `dual_softmax`
library, prints what `-Xptxas -v` says of each of its kernels (registers,
spills, shared memory) with the blocks an SM the registers allow, the work
decomposition at [4, 4800, 256] (blocks an SM, SMs, blocks a pass and waves)
and times by CUDA events (50 launches after a warm-up):
  - K1 at [4, 4800, 256] x [4, 4800, 256], the serving forward's call;
  - `dual_softmax_lse` at the same shapes, the training step's call;
  - the device time of each kernel of one call of each, by the profiler.
With --check it first holds both against their plain twins at
chip_smoke.py's tolerances (K1's max values within 1e-3 relative, each
argmax picking a plain conf >= (1 - 1e-3) x the plain max; the log-sum-exps
within 1e-3, also at a ragged [2, 1000] x [2, 777]) and exits 1 on a
disagreement. Run one tree after another in one call on one card (old, new,
new, old).
"""

import re
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops import dual_softmax as ds

ITERS = 50
SM_REGS = 65536
B, L, C, T = 4, 4800, 256, 0.1


def ptxas_report(log: str, threads: int) -> None:
    """Each kernel's registers, spills and static shared memory from ptxas,
    and the blocks an SM its registers allow at `threads` threads (ptxas does
    not count the dynamic shared memory a launch asks for)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m:
            continue
        info = " ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 1:i + 4]
                        if "Compiling" not in x and "Function properties" not in x)
        regs = re.search(r"Used (\d+) registers", info)
        r = int(regs.group(1)) if regs else 0
        by_regs = SM_REGS // (-(-r // 8) * 8 * threads) if r else 0
        print(f"  {m.group(1)}: {info} -> {by_regs} blocks an SM by registers at {threads} threads")


def inputs(g, Bp, Lp, S):
    """chip_smoke.py's form: image 1 sees most of image 0's cells again,
    shuffled, with noise."""
    f0 = cs.rnd(g, Bp, Lp, C)
    perm = torch.randperm(Lp, generator=g, device="cuda")[:S]
    f1 = (0.8 * f0[:, perm] + 0.6 * cs.rnd(g, Bp, S, C)).bfloat16()
    return f0.bfloat16(), f1


def check(g) -> bool:
    rtol, lse_atol = 1e-3, 1e-3
    f0, f1 = inputs(g, B, L, L)
    inv_temp = 1.0 / (C * T)
    got = ds.dual_softmax_match_stats(f0, f1, T)
    torch.cuda.synchronize()
    ref = ds._stats_reference(f0, f1, inv_temp)
    conf = ds.dual_softmax_confidence(f0, f1, inv_temp)
    e_r, ok_r = cs.close(got.row_max, ref.row_max, 0.0, rtol)
    e_c, ok_c = cs.close(got.col_max, ref.col_max, 0.0, rtol)
    err, ok_max = max(e_r, e_c), ok_r and ok_c
    row_pick = torch.gather(conf, 2, got.row_argmax.long()[..., None])[..., 0]
    col_pick = torch.gather(conf, 1, got.col_argmax.long()[:, None])[:, 0]
    ok_arg = bool((row_pick >= ref.row_max * (1 - rtol)).all()
                  and (col_pick >= ref.col_max * (1 - rtol)).all())
    same = float((got.row_argmax == ref.row_argmax).float().mean())
    same_c = float((got.col_argmax == ref.col_argmax).float().mean())
    del conf
    print(f"  check K1 [{B}, {L}, {C}]: max values max_abs_err {err:.3e} ({'ok' if ok_max else 'FAIL'}), "
          f"argmax picks {'ok' if ok_arg else 'FAIL'}, equal to plain: rows {same:.6f}, "
          f"cols {same_c:.6f}", flush=True)
    ok = ok_max and ok_arg
    for Bp, Lp, S in ((B, L, L), (2, 1000, 777)):
        f0, f1 = inputs(g, Bp, Lp, S)
        lr, lc = ds.dual_softmax_lse(f0, f1, inv_temp)
        rr, rc = ds._lse_reference(f0, f1, inv_temp)
        e = max(float((lr - rr).abs().max()), float((lc - rc).abs().max()))
        print(f"  check dual_softmax_lse [{Bp}, {Lp}] x [{Bp}, {S}]: max_abs_err {e:.3e}", flush=True)
        ok = ok and e <= lse_atol
    return ok


def main() -> int:
    t = time.time()
    logs = _build.build(["dual_softmax"], ptxas_verbose=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{_build.CSRC.parent.parent}] build {time.time() - t:.1f} s; card {card}", flush=True)
    threads = 256
    ptxas_report(logs.get("dual_softmax", ""), threads)
    if hasattr(ds, "plan"):
        p = ds.plan(B, L, L, C, torch.cuda.current_device())
        print(f"  plan [{B}, {L}, {C}]: {p.blocks_per_sm} blocks an SM, {p.sms} SMs, "
              f"{p.n_split} chunks of {p.chunk} column tiles, {p.units} blocks a pass, "
              f"{p.units / (p.blocks_per_sm * p.sms):.3f} waves")
    else:
        blocks = -(-L // ds.ROW_TILE) * B
        print(f"  grid [{B}, {L}, {C}]: {blocks} blocks a pass of {ds.ROW_TILE} rows "
              f"(blocks an SM: ptxas above and the kernel's dynamic shared memory)")
    g = torch.Generator(device="cuda").manual_seed(0)
    if "--check" in sys.argv[1:] and not check(g):
        return 1
    f0, f1 = inputs(g, B, L, L)
    inv_temp = 1.0 / (C * T)
    k1 = cs.cuda_ms(lambda: ds.dual_softmax_match_stats(f0, f1, T), iters=ITERS)
    lse = cs.cuda_ms(lambda: ds.dual_softmax_lse(f0, f1, inv_temp), iters=ITERS)
    print(f"  K1 dual_softmax_match_stats [{B}, {L}, {C}]: {k1:.4f} ms; "
          f"dual_softmax_lse: {lse:.4f} ms", flush=True)
    for name, fn in (("K1", lambda: ds.dual_softmax_match_stats(f0, f1, T)),
                     ("lse", lambda: ds.dual_softmax_lse(f0, f1, inv_temp))):
        parts = ", ".join(f"{n[:70]} {ms:.4f} ms x{c}" for ms, c, n in cs.kernel_times(fn))
        print(f"  {name} kernels: {parts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
