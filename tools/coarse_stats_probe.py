"""Where K5's stats kernel (`csrc/coarse_transformer.cu` `stats_kernel`, the
head-group design) spends a tile's time: cycles by phase, from clock stamps
in a copy of one checkout's port.

    python3 tools/coarse_stats_probe.py ROOT

copies ROOT's `featurematching_tpu_torch` and `chip_smoke.py` (ROOT: `.`, or
another commit unpacked with `git archive` into a directory `.gitignore`
lists) to `build/probe/stats/`, adds the stamps to the copy's
`coarse_transformer.cu` (thread 0 of each warpgroup adds the cycles since
its last stamp to its phase's counter in shared memory) and runs the
serving forward's self call [8, 4800, 256] and cross call [4, 4800, 256]
(8 heads) there, printing each call's stats kernel time (the profiler,
with the stamps), the cycles of a block by warpgroup, and the mean cycles
a tile of each phase. Stamps change the timing a little (PERF.md gives the
probe's time beside the kernel's).
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N, C, HEADS = 4800, 256, 8
CALLS = [(8, "self"), (4, "cross")]
REFILL = "    if (k + NS < n && wt == 0) fill_slot<C>(slot, &src, row0 + (k + NS) * T, &full[s]);"
# (anchor, stamp placed before it or after it, phase)
MARKS = [
    ("#pragma unroll 1\n  for (int k = wg; k < n; k += 2) {", "before", "0"),
    ("    fm::mbar_wait(&full[s], (k / NS) & 1);", "after", "1"),
    ("      fm::named_barrier(1 + wg, 128);  // every warp's product has read the slot",
     "before", "k < 2 ? 3 : 2"),
    ("      // K | V over the source; rows past S carry no mass", "before", "4"),
    ("    fm::named_barrier(1 + wg, 128);\n    // K^T (A[f][token]", "before", "5"),
    ("    const bf16* kvt = reinterpret_cast<const bf16*>(slot);", "before", "6"),
    ("    fm::named_barrier(1 + wg, 128);  // every warp's reads of the slot are done",
     "before", "7"),
    (REFILL, "before", "8"),
    (REFILL, "after", "9"),
]
LABELS = ["setup (once a block)", "slot wait", "product", "product, first tile (weights' waits)",
          "barrier 1", "epilogue (K | V into the slot)", "barrier 2", "K^T V + K_sum",
          "barrier 3", "refill (copies started)", "exchange + block barrier (once a block)"]
PH = 16
READER = """
extern "C" int fm_read_phases(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, fm_phase_out, n * sizeof(long long));
}
"""


def _replace(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise SystemExit(f"coarse_stats_probe: the source does not hold {old!r} once")
    return s.replace(old, new)


def stamp(s: str) -> str:
    s = _replace(s, "namespace {\n", f"""namespace {{
__device__ long long fm_phase_out[4096 * 2 * {PH}];
__shared__ long long fm_ph[2][{PH}];
__device__ __forceinline__ void fm_stamp(int k) {{
  if ((threadIdx.x & 127) == 0) {{
    const int w = threadIdx.x >> 7;
    const long long now = clock64();
    fm_ph[w][k] += now - fm_ph[w][{PH - 1}];
    fm_ph[w][{PH - 1}] = now;
  }}
}}
""")
    row0 = "  const int row0 = img * S + t0 * T;  // the item's first source row in [G S, C]\n"
    s = _replace(s, row0, row0 + f"""
  if ((threadIdx.x & 127) == 0) {{
    for (int k = 0; k < {PH - 1}; ++k) fm_ph[wg][k] = 0;
    fm_ph[wg][{PH - 1}] = clock64();
  }}
""")
    for anchor, where, k in MARKS:
        first = anchor.split("\n")[0]
        indent = first[:len(first) - len(first.lstrip())]
        st = f"{indent}fm_stamp({k});"
        s = _replace(s, anchor, f"{st}\n{anchor}" if where == "before" else f"{anchor}\n{st}")
    s = _replace(s, "  __syncthreads();\n  if (wg == 1) return;\n", f"""  __syncthreads();
  fm_stamp(10);
  if ((threadIdx.x & 127) == 0)
    for (int k = 0; k < {PH}; ++k)
      fm_phase_out[((blockIdx.y * gridDim.x + blockIdx.x) * 2 + wg) * {PH} + k] = fm_ph[wg][k];
  if (wg == 1) return;
""")
    return s + READER


def make_copy(root: Path) -> Path:
    dst = REPO / "build" / "probe" / "stats"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
    cu = dst / "featurematching_tpu_torch" / "csrc" / "coarse_transformer.cu"
    cu.write_text(stamp(cu.read_text()))
    return dst


def measure() -> None:
    """Run in the probe copy (on sys.path): time the calls and print the phases."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from featurematching_tpu_torch.ops import _build
    from featurematching_tpu_torch.ops import coarse_transformer as ct

    _build.build(["coarse_transformer"])
    lib = _build._load("coarse_transformer")
    lib.fm_read_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = C // ct.STATS_GROUP
    for G, kind in CALLS:
        lv = cs.layer_values(g, C)
        src = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        fn = lambda: ct.coarse_layer_with_stats(src, src, lv, HEADS)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.device_time_total for e in prof.key_averages()
                 if re.search(r"\bstats_kernel\b", e.key)) / 1e3 / 10
        per, chunks = ct.stats_plan(G, N, C, sms)
        blocks = G * chunks * groups
        tiles_img = -(-N // ct.ROW_TILE)
        # tiles a warpgroup: block x = img * chunks + c takes tiles [c per, min(...))
        n = np.array([min(tiles_img, c * per + per) - c * per
                      for _ in range(groups) for _ in range(G) for c in range(chunks)])
        tiles = np.stack([(n + 1) // 2, n // 2], axis=1).astype(np.float64)  # [blocks, 2]
        buf = np.zeros(blocks * 2 * PH, dtype=np.int64)
        if lib.fm_read_phases(buf.ctypes.data, buf.size):
            raise RuntimeError("fm_read_phases failed")
        ph = buf.reshape(blocks, 2, PH)[:, :, :len(LABELS)].astype(np.float64)
        tot = ph.sum(2)
        print(f"[probe] {kind} call [{G}, {N}, {C}]: stats_kernel {ms:.4f} ms with the stamps "
              f"(profiler); {blocks} blocks, a block's warpgroups {tot[:, 0].mean():.0f} / "
              f"{tot[:, 1].mean():.0f} cycles (max {tot.max():.0f}) over {tiles[:, 0].mean():.2f} "
              f"/ {tiles[:, 1].mean():.2f} tiles", flush=True)
        for w in range(2):
            once = {0, 3, 10}  # phases a block (or a warpgroup's first tile) runs once
            # the product of a warpgroup's first tile is phase 3, of the others phase 2
            count = {2: np.maximum(tiles[:, w] - 1, 1)}
            per_tile = [ph[:, w, k].mean() if k in once else
                        (ph[:, w, k] / count.get(k, np.maximum(tiles[:, w], 1))).mean()
                        for k in range(len(LABELS))]
            print(f"  warpgroup {w}, cycles a tile (once-a-block phases a block): " + ", ".join(
                f"{lab} {v:.0f}" for lab, v in zip(LABELS, per_tile)), flush=True)


def main() -> int:
    if "--measure" in sys.argv[1:]:
        measure()
        return 0
    root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    copy = make_copy(root)
    env = dict(os.environ, PYTHONPATH=str(copy))
    return subprocess.run([sys.executable, __file__, "--measure"], env=env, cwd=copy).returncode


if __name__ == "__main__":
    sys.exit(main())
