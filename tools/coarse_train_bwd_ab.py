"""K9's backward (`csrc/coarse_transformer_train.cu`: apply_bwd, bwd_merge,
stats_bwd, the weight gradients and the fixed-order sums) of one checkout
of the port, timed on one card by kernel, for comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/coarse_train_bwd_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timers (the bounds are this script's checkout's
`utils/kernel_bounds.py`, so an older ROOT is held to the same ones). The
script builds ROOT's `coarse_transformer_train` library anew and prints what
`-Xptxas -v` says of `apply_bwd_kernel` and `stats_bwd_kernel` at the four
(C, head dim) pairs (registers, spills, static shared memory, the blocks an
SM the registers allow), their SASS instructions (cuobjdump), and the
dynamic shared memory and resident blocks an SM the runtime reports for
each (where the library exports `fm_coarse_train_bwd_occupancy` and
`fm_coarse_train_stats_bwd_occupancy`), then, at the training step's self
call [8, 4800, 256] and cross call [4, 4800, 256] (8 heads; the step runs 4
and 8 of them):
  - the backward's device time by kernel (the profiler over REPS calls
    after a warm-up, per call), apply_bwd's and stats_bwd's each beside its
    own bound (`kernel_bounds.coarse_train_apply_bwd_work`,
    `coarse_train_stats_bwd_work`);
  - the whole backward by CUDA events (ITERS calls after a warm-up);
  - each summed over the step's 12 calls.
With --check it first holds each call against the plain twin (dx, dsrc and
the 10 gradients within chip_smoke.K9_TOL of each tensor's norm) and exits 1
on a disagreement. Run one tree after another in one call on one card (old,
new, new, old). The reports come from `tools/kernel_report.py`.
"""

import importlib.util
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from featurematching_tpu_torch.ops import coarse_transformer_train as ctt

sys.path.insert(0, str(Path(__file__).resolve().parent))
import kernel_report as kr  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", Path(__file__).resolve().parents[1] / "featurematching_tpu_torch" / "utils"
    / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS = 20
LIB = "coarse_transformer_train"
KERNELS = ("apply_bwd_kernel", "stats_bwd_kernel")
N, C, HEADS = 4800, 256, 8
CALLS = [(8, "self", 4), (4, "cross", 8)]  # (images, kind, calls a step)
WIDTHS = [(128, 16), (128, 32), (256, 16), (256, 32)]


def check(x, src, kv, ks, gout, lv, lt) -> dict:
    """Norm-relative errors of dx, dsrc and the 10 gradients against the twin."""
    got = cs.k9_tensors(None, ctt.coarse_layer_backward(x, src, kv, ks, gout, lv, lt, HEADS))
    torch.cuda.synchronize()
    ref = cs.k9_tensors(None, ctt.coarse_layer_backward_reference(x, src, kv, ks, gout, lv,
                                                                  HEADS))
    return {n: cs.norm_err(got[n], ref[n]) for n in got}


def main() -> int:
    do_check = "--check" in sys.argv[1:]
    kr.ptxas_report(kr.rebuild(LIB), KERNELS, threads=256)
    kr.code_report("|".join(KERNELS), LIB)
    kr.occupancy_report(LIB, {"apply_bwd": "fm_coarse_train_bwd_occupancy",
                              "stats_bwd": "fm_coarse_train_stats_bwd_occupancy"}, WIDTHS)
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(apply=0.0, apply_bound=0.0, stats=0.0, stats_bound=0.0, bwd=0.0, bwd_bound=0.0)
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
        split = kr.by_kernel(bwd, KERNELS)
        whole = cs.cuda_ms(bwd, iters=ITERS)
        ab, aby = kb.bound_ms(*kb.coarse_train_apply_bwd_work(G, N, N, C, HEADS))
        sb, sby = kb.bound_ms(*kb.coarse_train_stats_bwd_work(G, N, C, HEADS))
        wb, _ = kb.bound_ms(*kb.coarse_train_bwd_work(G, N, N, C, HEADS, kind == "self"))
        apply, stats = split.get("apply_bwd_kernel", 0.0), split.get("stats_bwd_kernel", 0.0)
        for key, v in (("apply", apply), ("apply_bound", ab), ("stats", stats),
                       ("stats_bound", sb), ("bwd", whole), ("bwd_bound", wb)):
            totals[key] += count * v
        for k, v in split.items():
            kernels[k] = kernels.get(k, 0.0) + count * v
        print(f"  {site} x{count}: backward {whole:.4f} ms (bound {wb:.4f}); apply_bwd "
              f"{apply:.4f} ms against its bound {ab:.4f} ms ({aby}, {apply / ab:.1f}x); "
              f"stats_bwd {stats:.4f} ms against its bound {sb:.4f} ms ({sby}, "
              f"{stats / sb:.1f}x); by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(f"  12 calls: apply_bwd {totals['apply']:.4f} ms (bound {totals['apply_bound']:.4f} "
          f"ms); stats_bwd {totals['stats']:.4f} ms (bound {totals['stats_bound']:.4f} ms); K9 "
          f"backward {totals['bwd']:.4f} ms (bound {totals['bwd_bound']:.4f} ms); by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
