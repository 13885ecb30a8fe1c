"""K7, the softmax terms of the sparse focal loss's backward
(`sparse_focal_backward`, `csrc/sparse_focal_loss.cu`), of one checkout of
the port at the training step's shapes, timed on one card, for comparing
two versions of it.

    PYTHONPATH=ROOT python3 tools/sparse_focal_ab.py [--check] [--probe]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs' form and the timers, and its wrapper the kernel. The reports
come from `kernel_report.py` and the bound from `utils/kernel_bounds.py` of
this script's checkout, so an older ROOT is held to the same one. The
script builds ROOT's `sparse_focal_loss` library anew and prints
  - what `-Xptxas -v` says of its kernels (registers, spills, shared
    memory) and the blocks an SM its registers allow;
  - the work decomposition at [4, 4800, 256]: work units, blocks and waves
    (ROOT's `plan` where its wrapper has one, with the blocks an SM the card
    reports; else the two passes' grids of 64-row blocks);
  - K7 at the step's shapes (f0, f1 [4, 4800, 256] bf16; a and lse [4,
    4800] f32 from 1024 GT pairs an image): its time by CUDA events around
    50 wrapper calls (host work included) and each kernel's device time a
    call by the profiler, against `kernel_bounds.sparse_focal_backward_work`.
With --check it first holds K7 against its plain twin at chip_smoke.py's
tolerance (max |kernel - plain| <= 1e-2 max |plain|) at [4, 4800, 256]
and at [2, 1000, 777], and two calls bit-identical, and exits 1 on a
disagreement. With --probe it then times copies of ROOT's kernel with one
part left out each (`build/probe/sfl/VARIANT`, this script run there):
  no_exp      the two ex2 a value replaced by their argument;
  no_product2 out += dsim . tile left out (dsim kept live);
  loads_only  no product and no exponential: the tensor copies, the ring's
              hand-backs, the partials and the stores alone.
Their results are wrong by design: only their times count. Run one tree
after another in one call on one card (old, new, new, old).
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
import kernel_report as kr
from featurematching_tpu_torch.ops import sparse_focal_loss as sfl
from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_lse

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", REPO / "featurematching_tpu_torch" / "utils" / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS, REPS = 50, 20
B, L, C, G, T = 4, 4800, 256, 1024, 0.1
K7_TOL = 1e-2  # chip_smoke.check_sparse_focal_loss
SM_REGS = 65536
EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
PRODUCT1 = """      fm::wgmma_ss_n64(sim, fm::sw128_desc(own + (k / 4) * Ly::BOX + (k % 4) * 32),
                       fm::sw128_desc(slot + (k / 4) * Ly::BOX + (k % 4) * 32), k > 0);"""
PRODUCT2 = """      product2<C>(acc, af[kk], fm::sw128_mn_desc(slot + kk * 2048, Ly::BOX), kk > 0 || !begins);"""
KEEP_DSIM = "      acc[kk] += __uint_as_float(af[kk][0] ^ af[kk][1] ^ af[kk][2] ^ af[kk][3]);"
EDITS = {
    "no_exp": [(EX2, "  y = x;")],
    "no_product2": [(PRODUCT2, KEEP_DSIM)],
    "loads_only": [(EX2, "  y = x;"), (PRODUCT2, KEEP_DSIM), (PRODUCT1, "      sim[k] = 0.f;")],
}


def inputs(g, Bp, Lp, S):
    """chip_smoke.py's form: image 1 sees most of image 0's cells again,
    shuffled, with noise; a_r and a_c from GT pairs (about a fifth of the
    rows and columns), the log-sum-exps from K1's pass 1."""
    inv_temp = 1.0 / (C * T)
    f0 = cs.rnd(g, Bp, Lp, C)
    perm = torch.randperm(Lp, generator=g, device="cuda")[:S]
    f1 = (0.8 * f0[:, perm] + 0.6 * cs.rnd(g, Bp, S, C)).bfloat16()
    f0 = f0.bfloat16()
    lr, lc = dual_softmax_lse(f0, f1, inv_temp)
    gi, gj, gm = cs.gt_pairs(g, Bp, Lp, S, min(G, S), perm)
    gbar = torch.rand(Bp, gi.shape[1], generator=g, device="cuda") * gm
    a_r, a_c = sfl._scatter_rows(Lp, gi, gbar), sfl._scatter_rows(S, gj, gbar)
    return f0, f1, a_r, lr, a_c, lc, inv_temp


def check(g) -> bool:
    ok = True
    for Bp, Lp, S in ((B, L, L), (2, 1000, 777)):
        args = inputs(g, Bp, Lp, S)
        d0, d1 = sfl.sparse_focal_backward(*args)
        torch.cuda.synchronize()
        r0, r1 = sfl.sparse_focal_backward_reference(*args)
        e = max(cs.rel_err(d0, r0), cs.rel_err(d1, r1))
        x0, x1 = sfl.sparse_focal_backward(*args)
        same = torch.equal(d0, x0) and torch.equal(d1, x1)
        good = e <= K7_TOL and same
        print(f"  check K7 [{Bp}, {Lp}, {C}] x [{Bp}, {S}, {C}]: max |kernel - plain| / max |plain| "
              f"{e:.3e} (<= {K7_TOL}), bit-identical twice {same}: {'ok' if good else 'FAIL'}",
              flush=True)
        ok = ok and good
    return ok


def decomposition(log: str) -> None:
    threads = 256
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kr._entry(m.group(1), "sfl_bwd_kernel")
        r = re.search(r"Used (\d+) registers", line)
        if r and name:
            n = int(r.group(1))
            print(f"  {name}: {n} registers, {SM_REGS // (-(-n // 8) * 8 * threads)} blocks an SM "
                  f"by registers at {threads} threads")
            name = None
    if hasattr(sfl, "plan"):
        sms, per_sm = sfl._capacity(C, torch.cuda.current_device())
        p = sfl.plan(B, L, L, sms, per_sm)
        units = B * sum(p.row_blocks)
        print(f"  plan [{B}, {L}, {C}]: {per_sm} block(s) an SM (card), {sms} SMs, {p.grid} "
              f"blocks; {units} units of {sfl.UNIT_ROWS} rows, {p.total} steps, "
              f"{p.total / p.grid:.2f} steps a block, {units / p.grid:.3f} units a block "
              f"(one wave, the steps cut evenly; whole units would take "
              f"{-(-units // p.grid)} waves)", flush=True)
    else:
        blocks = B * -(-L // 64)
        print(f"  grid [{B}, {L}, {C}]: two launches of {blocks} blocks of 64 rows (waves by "
              f"the blocks an SM above)", flush=True)


def time_k7(g) -> None:
    args = inputs(g, B, L, L)
    fn = lambda: sfl.sparse_focal_backward(*args)  # noqa: E731
    ev = cs.cuda_ms(fn, iters=ITERS)

    def reps():
        for _ in range(REPS):
            fn()

    rows = cs.kernel_times(reps, {"sfl_bwd_kernel": REPS * (1 if hasattr(sfl, "plan") else 2)})
    dev = sum(t for t, _, _ in rows) / REPS
    b, by = kb.bound_ms(*kb.sparse_focal_backward_work(B, L, L, C))
    print(f"  K7 [{B}, {L}, {C}]: {dev:.4f} ms a call by the profiler ({ev:.4f} ms by events); "
          f"bound {b:.4f} ms ({by}), {b / dev:.3f} of it", flush=True)
    for t, c, n in rows:
        print(f"    {t / REPS:.4f} ms x{c // REPS} {n[:100]}", flush=True)


def probe(root: Path) -> int:
    for v, edits in EDITS.items():
        dst = REPO / "build" / "probe" / "sfl" / v
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
        cu = dst / "featurematching_tpu_torch" / "csrc" / "sparse_focal_loss.cu"
        src = cu.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"sparse_focal_ab: the source does not hold {old!r} once")
            src = src.replace(old, new)
        cu.write_text(src)
        print(f"== probe {v}", flush=True)
        env = dict(os.environ, PYTHONPATH=str(dst))
        r = subprocess.run([sys.executable, __file__], env=env)
        if r.returncode:
            return r.returncode
    return 0


def main() -> int:
    log = kr.rebuild("sparse_focal_loss")
    kr.ptxas_report(log, ("sfl_bwd_kernel", "prep_kernel"))
    decomposition(log)
    g = torch.Generator(device="cuda").manual_seed(0)
    if "--check" in sys.argv[1:] and not check(g):
        return 1
    time_k7(g)
    if "--probe" in sys.argv[1:]:
        return probe(Path(sfl.__file__).resolve().parents[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
