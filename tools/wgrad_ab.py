"""The weight-gradient products dW = Aᵀ B (`csrc/wgrad.cuh`) of one
checkout of the port at the training step's 142 products, timed on one
card, for comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/wgrad_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py`
supplies the timers. A ROOT with `ops/wgrad.py` is timed through its
wrapper (its `wgrad` library built anew): each backward's products in one
launch (`wgrad_group`), as its backwards make them. An older ROOT, whose
`wgrad.cuh` is reached only from inside the backwards, is timed through a
small library built here from ROOT's header, one call a product with that
header's own split rule (ceil(T / 4096) splits), as its backwards made
them. The census and the bounds come from `utils/kernel_bounds.py` of this
script's checkout, so an older ROOT is held to the same ones. The script
prints
  - what `-Xptxas -v` says of the kernels (registers, spills, shared
    memory, ptxas' notes on wgmma);
  - each distinct launch of the step (a backward's products at one T): its
    launches a step, ROOT's plan where it has one, and its device time by
    the profiler (all the kernels it launches) and by CUDA events around
    ITERS of it (host work included), against
    `kernel_bounds.wgrad_group_work` (an operand two products share read
    once) and the products' `wgrad_work` summed;
  - the sums over the step's 28 launches by both;
  - each distinct (T, M, N) alone (a launch of one product), by the
    profiler, and the sums by (M, N) and over the 142 products.
With --check it first holds ROOT's kernel against the plain twin (f32 Aᵀ
B of the bf16 values) at every (M, N) of the step, at T = 1, 63, 65, 4097
and at the step's T, and every distinct launch of the step, within
CHECK_TOL of max |plain|, and two calls bit-identical, and exits 1 on a
disagreement. Run one tree after another in one call on one card (old,
new, new, old); the training step's device time and its backward are
`tools/ab_paths.py`'s.
"""

import ctypes
import importlib.util
import subprocess
import sys
from collections import Counter, defaultdict
from pathlib import Path

import torch

import chip_smoke as cs
import kernel_report as kr
from featurematching_tpu_torch.config import default_config
from featurematching_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", REPO / "featurematching_tpu_torch" / "utils" / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS, REPS = 20, 10
CHECK_TOL = 1e-4
RAGGED_T = (1, 63, 65, 4097)
OLD_SPLIT_TOKENS = 4096
SHIM = r"""
#include "wgrad.cuh"
FM_ERROR_STRING_ENTRY
extern "C" int fm_wgrad_old(const void* a, const void* b, int T, int M, int N, int splits,
                            void* part, void* out, void* stream) {
  return (int)fm::wgrad((const fm::bf16*)a, M, (const fm::bf16*)b, N, T, splits, M, N,
                        (float*)part, out, (cudaStream_t)stream);
}
"""


def old_wrapper():
    """The older ROOT's fm::wgrad, built from its header into a library of
    this script's own: (wgrad(a, b), ptxas' log)."""
    out = _build.BUILD_DIR / "libwgrad_old.so"
    src = out.with_suffix(".cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SHIM)
    cmd = [_build._nvcc(), "-Xptxas", "-v", *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"wgrad_ab: the old header did not build:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out))
    fn = lib.fm_wgrad_old
    fn.argtypes = [_build.PTR, _build.PTR] + [_build.INT] * 4 + [_build.PTR] * 3
    fn.restype = _build.INT

    def wgrad(a, b):
        T, M = a.shape
        N = b.shape[1]
        splits = max(1, -(-T // OLD_SPLIT_TOKENS))
        part = torch.empty(splits * M * N, device=a.device, dtype=torch.float32)
        o = torch.empty(M, N, device=a.device, dtype=torch.float32)
        err = fn(a.data_ptr(), b.data_ptr(), T, M, N, splits, part.data_ptr(), o.data_ptr(),
                 _build.stream())
        if err:
            raise RuntimeError(f"fm_wgrad_old: CUDA error {err}")
        return o

    return wgrad, r.stdout + r.stderr


def tree():
    """(a launch of a list of (a, b) pairs, the plan function or None, ptxas'
    log) of ROOT's kernel."""
    if (_build.CSRC.parent / "ops" / "wgrad.py").exists():
        from featurematching_tpu_torch.ops import wgrad as wg

        return wg.wgrad_group, wg.plan, kr.rebuild("wgrad")
    fn, log = old_wrapper()
    print(f"[{_build.CSRC.parent.parent}] the header's wgrad built alone; card {kr.card()}",
          flush=True)
    return (lambda pairs: [fn(a, b) for a, b in pairs]), None, log


def operands(g, group):
    """The named operands of a launch, one tensor a name, and its pairs."""
    names = {}
    for T, M, N, a, b in group:
        names.setdefault(a, cs.rnd(g, T, M, dtype=torch.bfloat16))
        names.setdefault(b, cs.rnd(g, T, N, dtype=torch.bfloat16))
    return [(names[a], names[b]) for _, _, _, a, b in group]


def check(fn, g) -> bool:
    ok = True
    cfg = default_config().model
    step_t = {}
    for T, M, N in kb.wgrad_calls(cfg):
        step_t.setdefault((M, N), T)
    launches = [[(T, M, N, "a", "b")] for (M, N), st in sorted(step_t.items())
                for T in RAGGED_T + (st,)]
    launches += list({tuple(grp): grp for grp in kb.wgrad_groups(cfg)}.values())
    for group in launches:
        pairs = operands(g, group)
        got, again = fn(pairs), fn(pairs)
        torch.cuda.synchronize()
        e = max(cs.rel_err(d, a.float().t() @ b.float()) for d, (a, b) in zip(got, pairs))
        same = all(torch.equal(d, x) for d, x in zip(got, again))
        good = e <= CHECK_TOL and same
        ok = ok and good
        if not good or len(group) > 1:
            shapes = ", ".join(f"{M}x{N}" for _, M, N, _, _ in group)
            print(f"  check T={group[0][0]} {shapes}: max |kernel - plain| / max |plain| "
                  f"{e:.3e} (<= {CHECK_TOL}), bit-identical twice {same}: "
                  f"{'ok' if good else 'FAIL'}", flush=True)
    print(f"  check at T in {RAGGED_T} and the step's, and the step's launches: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def time_launches(fn, plan, g) -> None:
    groups = Counter(tuple(grp) for grp in kb.wgrad_groups(default_config().model))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tot = [0.0, 0.0, 0.0, 0.0, 0]  # profiler, events, grouped bound, products' bounds, launches
    for group, n in groups.items():
        pairs = operands(g, group)
        dev = cs.device_ms(lambda: fn(pairs), reps=REPS)
        ev = cs.cuda_ms(lambda: fn(pairs), iters=ITERS)
        gb, _ = kb.bound_ms(*kb.wgrad_group_work(list(group)))
        pb = sum(kb.bound_ms(*kb.wgrad_work(*pr[:3]))[0] for pr in group)
        cut = ""
        if plan is not None:
            ps = plan([pr[:3] for pr in group], sms)
            cut = "; splits x stages " + ", ".join(f"{p.splits}x{p.per}" for p in ps)
        shapes = ", ".join(f"{M}x{N}" for _, M, N, _, _ in group)
        print(f"  T={group[0][0]} [{shapes}] x{n}: {dev:.4f} ms by the profiler, {ev:.4f} by "
              f"events; bound {gb:.4f} ms (products alone {pb:.4f}), {gb / dev:.3f} of it{cut}",
              flush=True)
        for i, v in enumerate((dev, ev, gb, pb, 1)):
            tot[i] += n * v
        del pairs
    dev, ev, gb, pb, n = tot
    print(f"  wgrad, the step's {n} launches (142 products): {dev:.4f} ms by the profiler, "
          f"{ev:.4f} ms by events; bound {gb:.4f} ms ({pb:.4f} with each product alone), "
          f"{gb / dev:.3f} of it", flush=True)


def time_products(fn, g) -> None:
    calls = Counter(kb.wgrad_calls(default_config().model))
    by_shape = defaultdict(lambda: [0.0, 0.0, 0])  # profiler, bound, products
    for (T, M, N), n in sorted(calls.items(), key=lambda c: (c[0][1], c[0][2], c[0][0])):
        pairs = operands(g, [(T, M, N, "a", "b")])
        dev = cs.device_ms(lambda: fn(pairs), reps=REPS)
        bound, _ = kb.bound_ms(*kb.wgrad_work(T, M, N))
        print(f"  T={T} {M}x{N} x{n} alone: {dev:.4f} ms by the profiler; bound {bound:.4f} ms, "
              f"{bound / dev:.3f} of it", flush=True)
        s = by_shape[(M, N)]
        s[0] += n * dev
        s[1] += n * bound
        s[2] += n
        del pairs
    for (M, N), (dev, bound, n) in sorted(by_shape.items()):
        print(f"  {M}x{N} x{n} alone: {dev:.4f} ms by the profiler, bound {bound:.4f}", flush=True)
    dev, bound, n = (sum(s[i] for s in by_shape.values()) for i in range(3))
    print(f"  the step's {n} products each alone: {dev:.4f} ms by the profiler; bound "
          f"{bound:.4f} ms, {bound / dev:.3f} of it", flush=True)


def main() -> int:
    fn, plan, log = tree()
    kr.ptxas_report(log, ("wgrad_kernel", "sum_parts_group_kernel", "sum_parts_kernel"))
    g = torch.Generator(device="cuda").manual_seed(0)
    if "--check" in sys.argv[1:] and not check(fn, g):
        return 1
    time_launches(fn, plan, g)
    time_products(fn, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
