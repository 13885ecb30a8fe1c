"""K10's backward (`csrc/fine_transformer_train.cu`: window_bwd, the weight
gradients and the fixed-order sums) of one checkout of the port, timed on
one card by kernel, for comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/fine_train_bwd_ab.py [--check]
        [--probe [--variant as_is|one_warpgroup|no_stash]]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timers (the bounds are this script's checkout's
`utils/kernel_bounds.py`, so an older ROOT is held to the same ones). The
script builds ROOT's `fine_transformer_train` library anew and prints what
`-Xptxas -v` says of `window_bwd_kernel` (registers, spills, static shared
memory, and any line on wgmma, such as C7518, which says ptxas serialized
the products), its SASS instructions (cuobjdump) and, where the library
reports it, the block (warpgroups, windows in flight, shared memory, grid
and fill at the step's calls). Then, at the training step's three calls
(one self call over 8192 windows of [49, 64] and two cross calls over 4096,
8 heads):
  - the backward's device time by kernel (the profiler over REPS calls after
    a warm-up, per call), window_bwd's beside its own bound
    (`kernel_bounds.fine_train_window_bwd_work`);
  - the whole backward by CUDA events (ITERS calls after a warm-up);
  - each summed over the step's three calls.
With --check it first holds each call against the plain twin (dx, dsrc and
the 9 gradients within chip_smoke.K10_TOL of each tensor's norm) and two
calls bit for bit, and exits 1 on a disagreement. With --probe it instead
copies ROOT's package and `chip_smoke.py` to `build/probe/k10_<variant>/`,
adds clock stamps to the copy's window_bwd_kernel and runs the step's self
call there, printing the mean cycles a window by phase: for the design of
one window a 256-thread block behind block barriers, thread 0 of each block
adds the cycles since its last stamp after every __syncthreads; for the
design of one window a warpgroup, thread 0 of each warpgroup stamps after
each phase of its window. Stamps change the timing a little (the probe
prints its own time). The warpgroup design's variants: `one_warpgroup`,
one window a block (what shared memory would hold beside a second image of
the transposed weights); `no_stash`, the stash's stores left out (what they
cost). Run one tree after another in one call on one card (old, new, new,
old).
"""

import ctypes
import importlib.util
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops import fine_transformer_train as ftt
from featurematching_tpu_torch.ops.coarse_transformer_train import train_values

sys.path.insert(0, str(Path(__file__).resolve().parent))
import kernel_report as kr  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", Path(__file__).resolve().parents[1] / "featurematching_tpu_torch" / "utils"
    / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS, REPS = 20, 10
N, C, HEADS = 49, 64, 8
CALLS = [(8192, "self", 1), (4096, "cross", 2)]  # (windows, kind, calls a step)
LIB, KERNEL = "fine_transformer_train", "window_bwd_kernel"
SOURCE = Path("featurematching_tpu_torch") / "csrc" / "fine_transformer_train.cu"

# the block design: one stamp after each of its 21 block barriers, labelled
BLOCK_LABELS = [
    "x, src loads", "Q and [K|V]", "K^T V, K_sum", "Z", "o", "m1 (+ o stash)", "LN1",
    "FFN1 (+ msg stash)", "FFN2 (+ h stash)", "LN2 stats", "LN2 column sums", "LN2 backward",
    "dy1 (+ dy2 stash)", "dmsg (+ dy1 stash)", "LN1 column sums", "LN1 backward",
    "do, dA, dZ (+ dm1 stash)", "dKV, dK_sum", "dqf", "dx, dv, dkf (+ dqf stash)",
    "dsrc (+ dkv stash)"]
# the warpgroup design: (anchor, label of the phase that ends there); a stamp
# goes after each anchor, which the source holds once
WG_STAMPS = [
    ("    // ---- the window's forward, recomputed ----\n", "window start, prefetches"),
    ("    // ---- K^T V and K_sum ----\n", "loads, [K|V] and Q, K and V tiles, barrier"),
    ("    // ---- Z and o ----\n", "K^T V, K_sum, barrier"),
    ("    // ---- m1, LN1, msg ----\n", "Z, o"),
    ("    // ---- h ----\n", "m1, LN1 (+ o stash)"),
    ("    // ---- y2, LN2 ----\n", "FFN1 (+ msg stash)"),
    ("    // ---- the backward: LN2 ----\n", "FFN2, LN2 statistics (+ h stash)"),
    ("    // ---- dy1 ----\n", "g, LN2 backward"),
    ("    // ---- dmsg, LN1 backward ----\n", "dy1 (+ dy2 stash)"),
    ("    // ---- do ----\n", "dmsg and dx's first product, LN1 backward (+ dy1 stash)"),
    ("    // ---- dA, dZ ----\n", "do, x wq again (+ dm1 stash)"),
    ("    // ---- dKV, dQ ----\n", "Q KV_bd again, dA, dZ, dK_sum partials, barrier"),
    ("    // ---- dV, dK ----\n", "dKV, dQ, dqf, two barriers"),
    ("    // ---- dsrc, dx ----\n", "dV, dK, src wk again, dx += dqf wq^T (+ dqf stash)"),
    ("    // ---- the window is done ----\n", "dsrc, dx and dsrc stores (+ [dkf | dv] stash)"),
]
PROBE_HEAD = """
__device__ long long fm_phase_out[1 << 16];
__device__ __forceinline__ void fm_stamp(long long* ph, int k) {
  const long long now = clock64();
  ph[k] += now - ph[31];
  ph[31] = now;
}
"""
# the warpgroup design's variants: source edits (old, new)
VARIANTS = {
    "as_is": [],
    "one_warpgroup": [("constexpr int kWarpgroups = 2;", "constexpr int kWarpgroups = 1;")],
    "no_stash": [("      if (r < N)\n        *reinterpret_cast<uint2*>(dst",
                  "      if (r < 0)\n        *reinterpret_cast<uint2*>(dst")],
}
READER = """
extern "C" int fm_read_phases(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, fm_phase_out, n * sizeof(long long));
}
"""


def occupancy_report() -> dict:
    """The block the tree reports for the step's calls ({} where it reports none)."""
    if not hasattr(ftt, "window_bwd_occupancy"):
        print("  occupancy: not reported by this tree (one window a 256-thread block, two "
              "blocks an SM by its launch bounds)")
        return {}
    occ = {}
    for G, kind, _ in CALLS:
        occ[G] = ftt.window_bwd_occupancy(HEADS, G)
        cs.print_window_bwd_block(occ[G], G)
    return occ


# older trees' wrapper also takes the packed transposes (TrainValues)
TAKES_LT = len(inspect.signature(ftt.fine_layer_backward).parameters) == 6


def backward(x, src, gout, lv):
    """One call of ROOT's K10 backward wrapper."""
    if TAKES_LT:
        return ftt.fine_layer_backward(x, src, gout, lv, train_values(lv), HEADS)
    return ftt.fine_layer_backward(x, src, gout, lv, HEADS)


def check(x, src, gout, lv) -> bool:
    """The call against the twin by K10_TOL, and twice bit for bit."""
    got = cs.k9_tensors(None, backward(x, src, gout, lv))
    again = cs.k9_tensors(None, backward(x, src, gout, lv))
    torch.cuda.synchronize()
    ref = cs.k9_tensors(None, ftt.fine_layer_backward_reference(x, src, gout, lv, HEADS))
    errs = {n: cs.norm_err(got[n], ref[n]) for n in got}
    same = all(torch.equal(got[n], again[n]) for n in got)
    worst = max(errs, key=errs.get)
    ok = same and all(v <= cs.K10_TOL for v in errs.values())
    print(f"  check G={x.shape[0]}: dx {errs['dx']:.2e}, worst {worst} {errs[worst]:.2e} "
          f"(limit {cs.K10_TOL}), bit-identical twice {same}: {'ok' if ok else 'FAILED'}",
          flush=True)
    return ok


def inputs(g, G, kind):
    lv = cs.layer_values(g, C)
    x = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
    src = x if kind == "self" else cs.rnd(g, G, N, C, dtype=torch.bfloat16)
    return x, src, cs.rnd(g, G, N, C), lv


def ab(do_check: bool) -> int:
    log = kr.rebuild(LIB)
    kr.ptxas_report(log, (KERNEL,))
    kr.code_report(KERNEL, LIB)
    occupancy_report()
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(win=0.0, win_bound=0.0, bwd=0.0)
    kernels = {}
    for G, kind, count in CALLS:
        args = inputs(g, G, kind)
        if do_check and not check(*args):
            return 1
        bwd = lambda: backward(*args)  # noqa: E731
        split = kr.by_kernel(bwd, (KERNEL,))
        whole = cs.cuda_ms(bwd, iters=ITERS)
        b, by = kb.bound_ms(*kb.fine_train_window_bwd_work(G, N, C, HEADS, kind == "self"))
        win = split.get(KERNEL, 0.0)
        totals["win"] += count * win
        totals["win_bound"] += count * b
        totals["bwd"] += count * whole
        for k, v in split.items():
            kernels[k] = kernels.get(k, 0.0) + count * v
        print(f"  {kind} call [{G}, {N}, {C}] x{count}: backward {whole:.4f} ms (events); "
              f"window_bwd {win:.4f} ms against its bound {b:.4f} ms ({by}, {win / b:.2f}x); "
              "by kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(f"  the step's 3 calls: window_bwd {totals['win']:.4f} ms (bound "
          f"{totals['win_bound']:.4f} ms, {totals['win'] / totals['win_bound']:.2f}x); K10 "
          f"backward {totals['bwd']:.4f} ms (events); by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()), flush=True)
    return 0


def _once(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise SystemExit(f"fine_train_bwd_ab --probe: the source does not hold {old!r} once")
    return s.replace(old, new)


def stamp_blocks(s: str) -> str:
    """Stamps after each block barrier of the block design's kernel."""
    head, body = s.split("window_bwd_kernel(Io io) {", 1)
    body, tail = body.split("\n}\n", 1)
    parts = body.split("__syncthreads();")
    if len(parts) != len(BLOCK_LABELS) + 1:
        raise SystemExit(f"fine_train_bwd_ab --probe: {len(parts) - 1} block barriers, "
                         f"expected {len(BLOCK_LABELS)}")
    body = parts[0] + "".join(f"__syncthreads(); if (threadIdx.x == 0) fm_stamp(ph, {k});"
                              + rest for k, rest in enumerate(parts[1:]))
    body = _once(body, "  extern __shared__ __align__(128) unsigned char smem[];\n", """\
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long ph[32];
  if (threadIdx.x == 0) {
    for (int k = 0; k < 31; ++k) ph[k] = 0;
    ph[31] = clock64();
  }
""")
    body += """
  if (threadIdx.x == 0)
    for (int k = 0; k < 32; ++k) fm_phase_out[blockIdx.x * 32 + k] = ph[k];"""
    head = _once(head, "namespace {\n", "namespace {\n" + PROBE_HEAD)
    return head + "window_bwd_kernel(Io io) {" + body + "\n}\n" + tail + READER


def stamp_warpgroups(s: str) -> str:
    """Stamps after each phase of the warpgroup design's window."""
    s = _once(s, "namespace {\n", "namespace {\n" + PROBE_HEAD)
    s = _once(s, "  // ---- the block's windows ----\n", """\
  __shared__ long long fm_ph[4][32];
  if ((threadIdx.x & 127) == 0) {
    for (int k = 0; k < 31; ++k) fm_ph[threadIdx.x >> 7][k] = 0;
    fm_ph[threadIdx.x >> 7][31] = clock64();
  }
  // ---- the block's windows ----
""")
    for k, (anchor, _) in enumerate(WG_STAMPS):
        s = _once(s, anchor, anchor + f"    if (wt == 0) fm_stamp(fm_ph[wg], {k});\n")
    s = _once(s, "  // ---- the block's windows are done ----\n", """\
  if (wt == 0)
    for (int k = 0; k < 32; ++k) fm_phase_out[(blockIdx.x * 4 + wg) * 32 + k] = fm_ph[wg][k];
  // ---- the block's windows are done ----
""")
    return s + READER


def probe(variant: str) -> int:
    root = _build.CSRC.parents[1]
    dst = Path(__file__).resolve().parents[1] / "build" / "probe" / f"k10_{variant}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
    src = (dst / SOURCE).read_text()
    warpgroups = "// ---- the block's windows ----" in src
    if variant != "as_is" and not warpgroups:
        raise SystemExit(f"fine_train_bwd_ab --probe: {variant} is for the warpgroup design")
    for old, new in VARIANTS[variant]:
        src = _once(src, old, new)
    (dst / SOURCE).write_text(stamp_warpgroups(src) if warpgroups else stamp_blocks(src))
    env = dict(os.environ, PYTHONPATH=str(dst))
    return subprocess.run([sys.executable, __file__, "--measure", variant], env=env,
                          cwd=dst).returncode


def measure() -> int:
    """In the probe copy: the self call's time and its cycles a window by phase."""
    import numpy as np

    _build.build([LIB])
    lib = _build._load(LIB)
    lib.fm_read_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    G, kind, _ = CALLS[0]
    args = inputs(g, G, kind)
    bwd = lambda: backward(*args)  # noqa: E731
    split = kr.by_kernel(bwd, (KERNEL,))
    bwd()
    torch.cuda.synchronize()
    if hasattr(ftt, "window_bwd_occupancy"):  # one set of counters a warpgroup
        occ = ftt.window_bwd_occupancy(HEADS, G)
        grid, slots = occ["grid"], occ["warpgroups"]
        labels = [lab for _, lab in WG_STAMPS]
        wins = np.array([[len(range(b + w * grid, G, grid * slots)) for w in range(slots)]
                         for b in range(grid)], dtype=np.float64).reshape(-1)
        shape, unit = (grid, 4, 32), "warpgroup"
    else:  # one a block, two blocks an SM
        grid = min(2 * torch.cuda.get_device_properties(0).multi_processor_count, G)
        slots, labels = 1, BLOCK_LABELS
        wins = np.array([len(range(b, G, grid)) for b in range(grid)], dtype=np.float64)
        shape, unit = (grid, 1, 32), "block"
    buf = np.zeros(int(np.prod(shape)), dtype=np.int64)
    if lib.fm_read_phases(buf.ctypes.data, buf.size):
        raise RuntimeError("fm_read_phases failed")
    ph = buf.reshape(shape)[:, :slots, :len(labels)].reshape(-1, len(labels)).astype(np.float64)
    keep = wins > 0
    per = (ph[keep] / wins[keep, None]).mean(0)
    tot = ph[keep].sum(1)
    print(f"[probe {sys.argv[-1]}] {kind} call [{G}, {N}, {C}]: window_bwd {split.get(KERNEL, 0.0):.4f} ms "
          f"with the stamps (profiler); a {unit} {tot.mean():.0f} cycles (min {tot.min():.0f}, "
          f"max {tot.max():.0f}) over {wins[keep].mean():.2f} windows; a window "
          f"{per.sum():.0f} cycles of its {unit}", flush=True)
    print("  cycles a window: " + ", ".join(f"{n} {v:.0f}" for n, v in zip(labels, per)),
          flush=True)
    return 0


def main() -> int:
    argv = sys.argv[1:]
    if "--measure" in argv:
        return measure()
    if "--probe" in argv:
        variant = argv[argv.index("--variant") + 1] if "--variant" in argv else "as_is"
        return probe(variant)
    return ab("--check" in argv)


if __name__ == "__main__":
    sys.exit(main())
