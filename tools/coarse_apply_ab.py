"""K5's layer kernels (`csrc/coarse_transformer.cu`: stats, merge, apply) of
one checkout of the port, timed on one card by kernel, for comparing two
versions of the apply kernel.

    PYTHONPATH=ROOT python3 tools/coarse_apply_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timers (the bounds are this script's checkout's
`utils/kernel_bounds.py`, so an older ROOT is held to the same ones). The
script builds ROOT's `coarse_transformer` library anew and prints what
`-Xptxas -v` says of `apply_kernel` at the four (C, head dim) pairs
(registers, spills, static shared memory), its SASS instructions
(cuobjdump), and the dynamic shared memory, token rows and resident blocks
an SM of an apply block (from `fm_coarse_apply_occupancy` where the library
exports it), then, at the serving forward's self call [8, 4800, 256] and
cross call [4, 4800, 256] (8 heads; the forward runs 4 and 8 of them):
  - the apply blocks' waves on the card;
  - the layer's device time by kernel (the profiler over `kernel_report.REPS` calls after a
    warm-up, per call), apply's beside its own bound
    (`kernel_bounds.coarse_apply_work`);
  - the whole layer by CUDA events (ITERS calls after a warm-up);
  - each summed over the forward's 12 calls.
With --check it first holds each call against `encoder_reference` (chip_smoke.py's
per-layer tolerance, 5e-2 + 2e-2 |plain|) and exits 1 on a disagreement.
Run one tree after another in one call on one card (old, new, new, old).
"""

import ctypes
import importlib.util
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops import coarse_transformer as ct
from kernel_report import by_kernel, code_report, ptxas_report, rebuild

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", Path(__file__).resolve().parents[1] / "featurematching_tpu_torch" / "utils"
    / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS = 20
N, C, HEADS = 4800, 256, 8
CALLS = [(8, "self", 4), (4, "cross", 8)]  # (images, kind, calls a forward)
WIDTHS = [(128, 16), (128, 32), (256, 16), (256, 32)]
# an apply block of a library without fm_coarse_apply_occupancy (the design
# before the wgmma kernel): 64 token rows, two blocks an SM
OLD_ROWS, OLD_BLOCKS = 64, 2


def occupancy(export: str = "fm_coarse_apply_occupancy", what: str = "apply",
              second: str = "token rows a block",
              missing: str = f"{OLD_ROWS} rows, {OLD_BLOCKS} blocks an SM") -> dict:
    """{(C, D): (dynamic shared memory bytes, `second`, blocks an SM)} of a
    block of the kernel, as the library's `export` reports it (empty where
    the library does not export it; `missing` then says what the older
    block was)."""
    lib = _build._load("coarse_transformer")
    if not hasattr(lib, export):
        print(f"  occupancy: not exported by this tree's library (its {what} block: {missing})")
        return {}
    fn = getattr(lib, export)
    fn.argtypes = [_build.INT, _build.INT, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _build.INT
    out = {}
    for c, d in WIDTHS:
        info = (ctypes.c_int * 3)()
        err = fn(c, d, info)
        if err:
            raise RuntimeError(f"{export}({c}, {d}): CUDA error {err}")
        out[(c, d)] = tuple(info)
        print(f"  C={c}, D={d}: {what} {info[0]} bytes of dynamic shared memory, {info[1]} "
              f"{second}, {info[2]} blocks an SM")
    return out


def main() -> int:
    do_check = "--check" in sys.argv[1:]
    ptxas_report(rebuild())
    code_report()
    occ = occupancy()
    _, rows, per_sm = occ.get((C, C // HEADS), (0, OLD_ROWS, OLD_BLOCKS))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(apply=0.0, apply_bound=0.0, layer=0.0, layer_bound=0.0)
    kernels = {}
    for G, kind, count in CALLS:
        lv = cs.layer_values(g, C)
        x = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        src = x if kind == "self" else cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        site = f"{kind} call [{G}, {N}, {C}]"
        blocks = -(-N // rows) * G if rows == OLD_ROWS else -(-(-(-N // 64) * G) // 2)
        waves = blocks / (sms * per_sm)
        print(f"  {site}: {blocks} apply blocks of {rows} rows, {per_sm} an SM on {sms} SMs: "
              f"{waves:.3f} waves, run in {-(-blocks // (sms * per_sm))}", flush=True)
        if do_check:
            got = ct.coarse_layer_fused(x, src, lv, HEADS)
            torch.cuda.synchronize()
            err, ok = cs.close(got, ct.encoder_reference(x, src, lv, HEADS), 5e-2, 2e-2)
            print(f"  check {site}: max err {err:.3e} (5e-2 + 2e-2 |plain|: "
                  f"{'ok' if ok else 'FAILED'})", flush=True)
            if not ok:
                return 1
        layer = lambda: ct.coarse_layer_fused(x, src, lv, HEADS)  # noqa: E731
        split = by_kernel(layer)
        whole = cs.cuda_ms(layer, iters=ITERS)
        ab, aby = kb.bound_ms(*kb.coarse_apply_work(G, N, C, HEADS))
        lb, _ = kb.bound_ms(*kb.total([kb.coarse_stats_work(G, N, C, HEADS),
                                       kb.coarse_apply_work(G, N, C, HEADS)]))
        apply = split.get("apply_kernel", 0.0)
        totals["apply"] += count * apply
        totals["apply_bound"] += count * ab
        totals["layer"] += count * whole
        totals["layer_bound"] += count * lb
        for k, v in split.items():
            kernels[k] = kernels.get(k, 0.0) + count * v
        print(f"  {site} x{count}: layer {whole:.4f} ms (bound {lb:.4f}); apply "
              f"{apply:.4f} ms against its bound {ab:.4f} ms ({aby}, {apply / ab:.2f}x), "
              f"{apply / max(sum(split.values()), 1e-9):.3f} of the layer's kernels; by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(f"  12 calls: apply {totals['apply']:.4f} ms (bound {totals['apply_bound']:.4f} ms); "
          f"K5 {totals['layer']:.4f} ms (bound {totals['layer_bound']:.4f} ms); by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
