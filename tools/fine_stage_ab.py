"""K6's kernel (`csrc/fine_stage.cu`, also K10's forward) of one checkout of
the port, timed on one card, for comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/fine_stage_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timers (the bounds are this script's checkout's
`utils/kernel_bounds.py`, so an older ROOT is held to the same ones). The
script builds ROOT's `fine_stage` library anew and prints what `-Xptxas -v`
says of each `fine_stage_kernel` instantiation (registers, spills, static
shared memory), its SASS instructions (cuobjdump) and, where the tree
has `fine_stage_occupancy`, the block's pairs in flight, dynamic shared
memory, blocks an SM and grid at one and two layers and head dims 8 and
16. Then, by the profiler (REPS calls after a warm-up, per call, by
kernel) and by CUDA events (ITERS calls):
  - the serving call: fold mode, 4096 pairs of [49, 64] windows, a self
    and a cross layer, 8 heads, beside `kernel_bounds.fine_stage_work`;
  - K10's forward calls of the training step (`fine_layer_forward`, plain
    mode, one layer): a self layer and a cross layer on 4096 pairs, beside
    `kernel_bounds.fine_train_fwd_work` (one encoder call over 8192 windows
    a self layer, two over 4096 a cross layer), and their sum.
With --check it first holds each call against the plain twin at
chip_smoke.py's tolerances (heatmaps HEAT_ATOL, the plain-mode windows 5e-2
+ 2e-2 |plain| and mixes 0.13 + 0.05 |plain|; K10's outputs K10_TOL of
each tensor's norm) and exits 1 on a disagreement.
Run one tree after another in one call on one card (old, new, new, old).
"""

import importlib.util
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from featurematching_tpu_torch.ops import fine_stage as fs

sys.path.insert(0, str(Path(__file__).resolve().parent))
import kernel_report as kr  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", Path(__file__).resolve().parents[1] / "featurematching_tpu_torch" / "utils"
    / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS, REPS = 20, 10
PAIRS, N, C, HEADS = 4096, 49, 64, 8  # the serving forward's windows: max_matches a pair x 4
KERNEL = r"\S*?fine_stage_kernel\S*"  # kernel_report's pattern for the whole mangled name


def occupancy() -> None:
    """The block's shape as the tree reports it (nothing where it does not)."""
    if not hasattr(fs, "fine_stage_occupancy"):
        print("  occupancy: not reported by this tree (one pair a block, three blocks an SM by "
              "its launch bounds)")
        return
    for layers in (1, 2):
        for d in fs.HEAD_DIMS:
            occ = fs.fine_stage_occupancy(layers, C // d, PAIRS)
            slots = occ["grid"] * occ["pairs_in_flight"]
            print(f"  {layers} layer(s), head dim {d}: {occ['pairs_in_flight']} pairs in flight a "
                  f"block, {occ['smem_bytes']} bytes of dynamic shared memory, "
                  f"{occ['blocks_per_sm']} block(s) an SM, grid {occ['grid']}: {PAIRS} pairs are "
                  f"{PAIRS / slots:.3f} rounds of its {slots} pair slots")


def report(site: str, fn, work) -> float:
    split = kr.by_kernel(fn, ("fine_stage_kernel",))
    whole = cs.cuda_ms(fn, iters=ITERS)
    b, by = kb.bound_ms(*work)
    kern = split.get("fine_stage_kernel", 0.0)
    print(f"  {site}: fine_stage_kernel {kern:.4f} ms (profiler), the call {whole:.4f} ms "
          f"(events), bound {b:.4f} ms ({by}, {kern / b:.2f}x); by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    return kern


def check_serving(args) -> bool:
    heat = fs.fine_stage_fused(*args, fold_softargmax=True)
    got = fs.fine_stage_fused(*args)
    torch.cuda.synchronize()
    ok = True
    for i, (a, r) in enumerate(zip(heat, fs.fine_stage_reference(*args, fold_softargmax=True),
                                   strict=True)):
        e, good = cs.close(a, r, cs.HEAT_ATOL, 0.0)
        print(f"  check serving heatmap {i}: max err {e:.3e} ({cs.HEAT_ATOL}: "
              f"{'ok' if good else 'FAILED'})")
        ok &= good
    for i, (a, r) in enumerate(zip(got, fs.fine_stage_reference(*args), strict=True)):
        tol = (5e-2, 2e-2) if i < 2 else (0.13, 0.05)
        e, good = cs.close(a, r, *tol)
        print(f"  check serving plain-mode output {i}: max err {e:.3e} ({tol[0]} + {tol[1]} "
              f"|plain|: {'ok' if good else 'FAILED'})")
        ok &= good
    return ok


def main() -> int:
    do_check = "--check" in sys.argv[1:]
    log = kr.rebuild("fine_stage")
    kr.ptxas_report(log, (KERNEL,))  # the full mangled names
    kr.code_report(KERNEL, "fine_stage")
    occupancy()
    g = torch.Generator(device="cuda").manual_seed(0)
    names = ("self", "cross")
    layers = [cs.layer_values(g, C) for _ in names]
    mixes = [(cs.rnd(g, N, scale=0.3), cs.rnd(g, 1)) for _ in range(2)]
    w0 = cs.rnd(g, PAIRS, N, C, dtype=torch.bfloat16)
    w1 = cs.rnd(g, PAIRS, N, C, dtype=torch.bfloat16)
    args = (w0, w1, layers, *mixes, names, HEADS)
    if do_check and not check_serving(args):
        return 1
    report(f"serving call (fold, {PAIRS} pairs of [{N}, {C}], self + cross)",
           lambda: fs.fine_stage_fused(*args, fold_softargmax=True),
           kb.fine_stage_work(PAIRS, N, C, HEADS, len(names)))
    k10 = 0.0
    for kind, G, calls in (("self", 2 * PAIRS, 1), ("cross", PAIRS, 2)):
        lv = layers[0] if kind == "self" else layers[1]
        if do_check:
            out = fs.fine_layer_forward(w0, w1, lv, kind, HEADS)
            torch.cuda.synchronize()
            ref = fs.fine_layer_reference(w0, w1, lv, kind, HEADS)
            errs = [cs.norm_err(a, r) for a, r in zip(out, ref, strict=True)]
            good = all(e <= cs.K10_TOL for e in errs)
            print(f"  check K10 forward ({kind}): norm errors {errs[0]:.2e}, {errs[1]:.2e} "
                  f"({cs.K10_TOL}: {'ok' if good else 'FAILED'})")
            if not good:
                return 1
        k10 += report(f"K10 forward, {kind} layer ({PAIRS} pairs, plain mode)",
                      lambda: fs.fine_layer_forward(w0, w1, lv, kind, HEADS),
                      kb.total([kb.fine_train_fwd_work(G, N, C, HEADS)] * calls))
    b, by = kb.bound_ms(*kb.total([kb.fine_train_fwd_work(2 * PAIRS, N, C, HEADS),
                                   kb.fine_train_fwd_work(PAIRS, N, C, HEADS),
                                   kb.fine_train_fwd_work(PAIRS, N, C, HEADS)]))
    print(f"  K10 forward a training step (self + cross): fine_stage_kernel {k10:.4f} ms, "
          f"bound {b:.4f} ms ({by}, {k10 / b:.2f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
