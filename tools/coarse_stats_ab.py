"""K5's stats kernel (`csrc/coarse_transformer.cu`: stats_kernel, with its
merge_kernel) of one checkout of the port, timed on one card, for comparing
two versions of it.

    PYTHONPATH=ROOT python3 tools/coarse_stats_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and timers. The reports and the profiler split come from
`kernel_report.py`, the occupancy from `coarse_apply_ab.py` and the bounds
from `utils/kernel_bounds.py` of this script's checkout, and so does the stats tolerance
(`ops/coarse_transformer.stats_errors`): an older ROOT is held to the same
ones. The script builds ROOT's `coarse_transformer` library anew and prints
what `-Xptxas -v` says of `stats_kernel` at the four (C, head dim) pairs and
of `merge_kernel`, the SASS instructions of `stats_kernel`, and the dynamic
shared memory, head groups and resident blocks an SM of a stats block (where
the library exports `fm_coarse_stats_occupancy`), then, at the serving
forward's self call [8, 4800, 256] and cross call [4, 4800, 256] (8 heads;
the forward runs 4 and 8 of them):
  - the stats blocks (the wrapper's plan) and the rounds they take on the
    card;
  - the layer's device time by kernel (the profiler over REPS calls after a
    warm-up, per call), stats + merge beside the stats' own bound
    (`kernel_bounds.coarse_stats_work`);
  - each summed over the forward's 12 calls.
With --check it first holds each call's kv and ks against the plain stats
and exits 1 on a disagreement. Run one tree after another in one call on
one card (old, new, new, old).
"""

import importlib.util
import sys
from pathlib import Path

import torch

import kernel_report as kr

HERE = Path(__file__).resolve().parent


def _here(name: str, path: Path):
    """A module of this script's checkout, loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ab = _here("coarse_apply_ab", HERE / "coarse_apply_ab.py")  # imports ROOT's chip_smoke and port
cs, ct, kb = ab.cs, ab.ct, ab.kb
stats_errors = _here("coarse_transformer_here", HERE.parent / "featurematching_tpu_torch" / "ops"
                     / "coarse_transformer.py").stats_errors

N, C, HEADS, CALLS = ab.N, ab.C, ab.HEADS, ab.CALLS
KERNELS = ("stats_kernel", "merge_kernel", "apply_kernel")
# a stats block of a library without fm_coarse_stats_occupancy (the design
# before the head-group kernel): every column, two blocks an SM
OLD_BLOCKS = 2


def plan(G: int, sms: int, groups: int):
    """(tiles a run, runs an image, blocks) of ROOT's wrapper at [G, N, C]."""
    tiles = -(-N // ct.ROW_TILE)
    if hasattr(ct, "stats_plan"):
        per, chunks = ct.stats_plan(G, N, C, sms)
    else:  # the older wrapper: about two blocks an SM
        per = -(-tiles * G // (2 * sms))
        chunks = -(-tiles // per)
    return per, chunks, G * chunks * groups


def check(x, src, lv, site: str) -> bool:
    """kv and ks of one call against the plain stats within the bounds."""
    _, kv, ks = ct.coarse_layer_with_stats(x, src, lv, HEADS)
    torch.cuda.synchronize()
    ok = True
    for name, (err, past, _, _) in stats_errors(kv, ks, src, lv, HEADS).items():
        ok = ok and past == 0
        print(f"  check {site} {name}: max err {err:.3e}, {past} entries past "
              f"stats_reference_bounds ({'ok' if past == 0 else 'FAILED'})", flush=True)
    return ok


def main() -> int:
    do_check = "--check" in sys.argv[1:]
    kr.ptxas_report(kr.rebuild(), ("stats_kernel", "merge_kernel"))
    kr.code_report("stats_kernel")
    occ = ab.occupancy("fm_coarse_stats_occupancy", "stats", "head groups",
                       f"every column, {OLD_BLOCKS} blocks an SM by its launch bounds")
    _, groups, per_sm = occ.get((C, C // HEADS), (0, 1, OLD_BLOCKS))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(stats=0.0, bound=0.0)
    kernels = {}
    for G, kind, count in CALLS:
        lv = cs.layer_values(g, C)
        x = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        src = x if kind == "self" else cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        site = f"{kind} call [{G}, {N}, {C}]"
        per, chunks, blocks = plan(G, sms, groups)
        print(f"  {site}: {blocks} stats blocks ({chunks} runs of up to {per} tiles an image, "
              f"{groups} head groups), {per_sm} an SM on {sms} SMs: "
              f"{blocks / (sms * per_sm):.3f} rounds, run in {-(-blocks // (sms * per_sm))}",
              flush=True)
        if do_check and not check(x, src, lv, site):
            return 1
        split = kr.by_kernel(lambda: ct.coarse_layer_fused(x, src, lv, HEADS))
        sb, sby = kb.bound_ms(*kb.coarse_stats_work(G, N, C, HEADS))
        stats = split.get("stats_kernel", 0.0) + split.get("merge_kernel", 0.0)
        totals["stats"] += count * stats
        totals["bound"] += count * sb
        for k in KERNELS:
            kernels[k] = kernels.get(k, 0.0) + count * split.get(k, 0.0)
        print(f"  {site} x{count}: stats + merge {stats:.4f} ms against the stats' bound "
              f"{sb:.4f} ms ({sby}, {stats / sb:.2f}x); by kernel: "
              + ", ".join(f"{k} {split.get(k, 0.0):.4f}" for k in KERNELS), flush=True)
    print(f"  12 calls: stats + merge {totals['stats']:.4f} ms against {totals['bound']:.4f} ms "
          f"({totals['stats'] / totals['bound']:.2f}x); by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
