"""K3 (`layer_norm_chain`, `csrc/layer_norm.cu`) and K4 (`patch_expand_ln`,
`csrc/patch_expand.cu`) of one checkout of the port at the serving forward's
sites, timed on one card, for comparing two versions of them.

    PYTHONPATH=ROOT python3 tools/backbone_ln_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timers, and its wrappers the kernels. The reports come
from `kernel_report.py` and the bounds from `utils/kernel_bounds.py` of this
script's checkout, so an older ROOT is held to the same ones. The script
builds ROOT's `layer_norm` and `patch_expand` libraries anew and prints what
`-Xptxas -v` says of `ln_chain_kernel` and `patch_expand_kernel` at each
instantiation (registers, spills, shared memory) and their SASS size, then
for each serving site (640x480, batch 4: K3's patch_norm [8, 19200, 64],
norm_down0 [8, 4800, 128] and norm_down1 and 2 [8, 1200, 256]; K4's dec0,
dec1 and dec2):
  - the kernel's device time a call by the profiler (`chip_smoke.
    kernel_times` over REPS calls, which checks the launches it saw), its
    time by CUDA events around 20 calls of the wrapper (host work
    included), its bound (`kernel_bounds.layer_norm_work`,
    `patch_expand_work`) and the bound's share of the device time;
  - each kernel's total over the forward's launches (K3 4, K4 3).
The heads run without a bias, as the serving forward calls them, where
ROOT's wrapper takes `b_head=None`, else with a zero bias. With --check it
first holds each site against the plain twin (chip_smoke.py's tolerances)
and exits 1 on a disagreement. Run one tree after another in one call on
one card (old, new, new, old).
"""

import importlib.util
import sys
from pathlib import Path

import torch

import chip_smoke as cs
import kernel_report as kr
from featurematching_tpu_torch.ops import layer_norm as ln
from featurematching_tpu_torch.ops import patch_expand as pe

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", Path(__file__).resolve().parents[1] / "featurematching_tpu_torch" / "utils"
    / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

REPS = 20
# (name, shape, launches a forward)
K3_SITES = [("patch_norm", (8, 19200, 64), 1), ("norm_down0", (8, 4800, 128), 1),
            ("norm_down1+2", (8, 1200, 256), 2)]
# (name, H, W, C4, head width, LN out): dec0's linear_middle head, dec1, dec2's linear_end
K4_SITES = [("dec0", 30, 40, 128, 256, True), ("dec1", 60, 80, 64, 0, True),
            ("dec2", 120, 160, 64, 64, False)]
K3_TOL = (1.6e-2, 1.6e-2)  # chip_smoke.check_layer_norm
K4_TOL = (3e-2, 1.6e-2)  # chip_smoke.check_patch_expand


def site(name, fn, kernel, work, count) -> float:
    """Print one site's profiler and event times against its bound; return
    the profiler's ms a call."""
    def reps():
        for _ in range(REPS):
            fn()

    rows = cs.kernel_times(reps, {kernel: REPS})
    ms = sum(t for t, _, n in rows if kernel in n) / REPS
    ev = cs.cuda_ms(fn)
    b, by = kb.bound_ms(*work)
    print(f"  {name} x{count}: {ms:.4f} ms a call (profiler), {ev:.4f} ms (events), bound "
          f"{b:.4f} ms ({by}), {b / ms:.3f} of it", flush=True)
    return ms


def check(name, got, ref, tol) -> bool:
    ok, worst = True, 0.0
    for g, r in zip(got, ref, strict=True):
        e, fine = cs.close(g, r, *tol)
        ok, worst = ok and fine, max(worst, e)
    print(f"  check {name}: max err {worst:.3e} ({tol[0]} + {tol[1]} |plain|: "
          f"{'ok' if ok else 'FAILED'})", flush=True)
    return ok


def main() -> int:
    do_check = "--check" in sys.argv[1:]
    kr.ptxas_report(kr.rebuild("layer_norm", "patch_expand"),
                    ("ln_chain_kernel", "patch_expand_kernel"))
    kr.code_report("ln_chain_kernel", "layer_norm")
    kr.code_report("patch_expand_kernel", "patch_expand")
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for name, shape, count in K3_SITES:
        C = shape[-1]
        x = cs.rnd(g, *shape, dtype=torch.bfloat16)
        s, b = cs.rnd(g, C, scale=0.1, shift=1.0), cs.rnd(g, C, scale=0.1)
        fn = lambda: ln.layer_norm_chain(x, s, b)  # noqa: E731
        if do_check and not check(name, [fn()], [ln.layer_norm_chain_plain(x, s, b)], K3_TOL):
            return 1
        ms = site(name, fn, "ln_chain_kernel", kb.layer_norm_work(x.numel() // C, C), count)
        t = totals.setdefault("K3", [0.0, 0.0])
        t[0] += count * ms
        t[1] += count * kb.bound_ms(*kb.layer_norm_work(x.numel() // C, C))[0]
    no_bias = hasattr(pe, "head_image")  # the wrapper takes b_head=None
    for name, h, w, C4, CH, emit in K4_SITES:
        y = cs.rnd(g, 8, h * w, 4 * C4, dtype=torch.bfloat16)
        s1, b1 = cs.rnd(g, C4, scale=0.1, shift=1.0), cs.rnd(g, C4, scale=0.1)
        s2, b2 = cs.rnd(g, C4, scale=0.1, shift=1.0), cs.rnd(g, C4, scale=0.1)
        wh = cs.rnd(g, C4, CH, scale=C4**-0.5, dtype=torch.bfloat16) if CH else None
        bh = None if not CH or no_bias else torch.zeros(CH, device="cuda")
        args = (y, h, w, s1, b1, s2, b2, wh, bh, emit)
        fn = lambda: pe.patch_expand_ln(*args)  # noqa: E731
        if do_check and not check(name, fn(), pe.patch_expand_ln_plain(*args), K4_TOL):
            return 1
        work = kb.patch_expand_work(8, h, w, C4, CH, emit)
        ms = site(name, fn, "patch_expand_kernel", work, 1)
        t = totals.setdefault("K4", [0.0, 0.0])
        t[0] += ms
        t[1] += kb.bound_ms(*work)[0]
    for k, (ms, b) in totals.items():
        print(f"  {k}: {ms:.4f} ms a forward (profiler) against {b:.4f} ms, {b / ms:.3f} of "
              f"it", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
