"""Where K6's kernel (`csrc/fine_stage.cu`) spends a window pair's time:
cycles by phase, from clock stamps in a copy of one checkout's port.

    python3 tools/fine_stage_probe.py ROOT [--variant as_is|no_weights]

copies ROOT's `featurematching_tpu_torch` and `chip_smoke.py` (ROOT: `.`, or
another commit unpacked with `git archive` into a directory `.gitignore`
lists) to `build/probe/<variant>/`, adds the stamps to the copy's
`fine_stage.cu` and runs the serving call there (fold, 4096 pairs of [49,
64], self + cross, 8 heads; for the warpgroup design also K10's self call,
plain, one layer), printing its time (CUDA events) and the mean cycles a
pair by phase, each encoder phase summed over the pair's encoder calls.
Two designs are known by their source:
  - one pair a block behind block barriers (before PR 15): thread 0 of each
    block adds the cycles since its last stamp after every __syncthreads;
    `--variant no_weights` also reads every weight fragment from one fixed
    tile (`tiles.cuh` `packed_tile`), which prices the weights' L2 reads;
  - one pair a warpgroup (PR 15): thread 0 of each warpgroup stamps after
    each phase of its pair; a named-barrier wait is a phase of its own.
Stamps change the timing a little (PERF.md gives the probe's time beside
the kernel's).
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PAIRS, N, C, HEADS = 4096, 49, 64, 8

# one pair a block: the phase of each __syncthreads() in file order, the
# encoder's nine, then the kernel's four (setup, window load, mix, pair end)
BLOCK_PHASES = [1, 2, 3, 4, 5, 5, 6, 7, 7, 10, 0, 8, 9]
BLOCK_LABELS = ["window load", "Q and [K|V]", "K^T V + K_sum", "Z", "o", "merge + LN1",
                "FFN1", "FFN2 + LN2", "mix", "heatmaps", "setup (once a block)"]
# one pair a warpgroup: (anchor, stamp placed before it or after it, phase)
WG_MARKS = [
    ("    fm::mbar_wait(bar, 0);  // the images are in", "after", 0),
    ("  // Q = bf16(elu(x . wq) + 1), as fragments", "before", 1),
    ("  fm::named_barrier(1 + wg, 128);\n  // warp w: the diagonal", "before", 2),
    ("  // warp w: the diagonal", "before", 3),
    ("  // Z = Q_h . K_sum_h over the quad; o = Q . KV_bd * (N / (Z + eps)), as fragments",
     "before", 4),
    ("  // msg = bf16(LN1(bf16(o . wmerge))), as fragments", "before", 5),
    ("  // hidden = bf16(relu(x . w1[:C] + msg . w1[C:])), as fragments, in two", "before", 6),
    ("  // x = x + bf16(LN2(bf16(hidden . w2)))", "before", 7),
    ("    if (a.fold) {\n      // heat_s", "before", 9),
]
WG_LABELS = ["load + image wait", "[K|V] product + epilogue", "Q", "barrier 1",
             "K^T V + K_sum + barrier 2", "Z, o", "merge + LN1", "FFN1", "FFN2 + LN2 + residual",
             "mix", "heatmaps / store"]
READER = """
extern "C" int fm_read_phases(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, fm_phase_out, n * sizeof(long long));
}
"""


def _replace(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise SystemExit(f"fine_stage_probe: the source does not hold {old!r} once")
    return s.replace(old, new)


def stamp_blocks(s: str) -> str:
    parts = s.split("__syncthreads();")
    if len(parts) != len(BLOCK_PHASES) + 1:
        raise SystemExit(f"fine_stage_probe: {len(parts) - 1} block barriers, expected "
                         f"{len(BLOCK_PHASES)}")
    s = parts[0] + "".join(f"__syncthreads(); fm_stamp({k});" + rest
                           for k, rest in zip(BLOCK_PHASES, parts[1:]))
    s = _replace(s, "namespace {\n", """namespace {
__device__ long long fm_phase_out[4096 * 16];
__shared__ long long fm_ph[17];
__device__ __forceinline__ void fm_stamp(int k) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    fm_ph[k] += now - fm_ph[16];
    fm_ph[16] = now;
  }
}
""")
    s = _replace(s, "  extern __shared__ __align__(128) unsigned char smem[];\n  bf16* win[2]",
                 """  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) {
    for (int k = 0; k < 16; ++k) fm_ph[k] = 0;
    fm_ph[16] = clock64();
  }
  bf16* win[2]""")
    s = _replace(s, "    __syncthreads(); fm_stamp(9);\n  }\n}\n",
                 "    __syncthreads(); fm_stamp(9);\n  }\n  if (threadIdx.x == 0)\n"
                 "    for (int k = 0; k < 16; ++k) fm_phase_out[blockIdx.x * 16 + k] = fm_ph[k];\n"
                 "}\n")
    return s + READER


def stamp_warpgroups(s: str) -> str:
    s = _replace(s, "namespace {\n", """namespace {
__device__ long long fm_phase_out[4096 * 16];
__shared__ long long fm_ph[4][16];
__device__ __forceinline__ void fm_stamp(int k) {
  if ((threadIdx.x & 127) == 0) {
    const int w = threadIdx.x >> 7;
    const long long now = clock64();
    fm_ph[w][k] += now - fm_ph[w][15];
    fm_ph[w][15] = now;
  }
}
""")
    for anchor, where, k in WG_MARKS:
        indent = anchor[:len(anchor) - len(anchor.lstrip())]
        stamp = f"{indent}fm_stamp({k});"
        s = _replace(s, anchor, f"{stamp}\n{anchor}" if where == "before" else f"{anchor}\n{stamp}")
    s = _replace(s, """        x[kk][r] = *reinterpret_cast<const uint32_t*>(&sum);
      }
  }
}""", """        x[kk][r] = *reinterpret_cast<const uint32_t*>(&sum);
      }
  }
  fm_stamp(8);
}""")
    s = _replace(s, """      store_window(x1, a.wout[1], pair, N, th);
    }
  }
}""", """      store_window(x1, a.wout[1], pair, N, th);
    }
    fm_stamp(10);
  }
  if ((threadIdx.x & 127) == 0)
    for (int k = 0; k < 16; ++k) fm_phase_out[(blockIdx.x * 4 + wg) * 16 + k] = fm_ph[wg][k];
}""")
    s = _replace(s, "  __syncthreads();\n  const float mb0", """  if ((threadIdx.x & 127) == 0) {
    for (int k = 0; k < 15; ++k) fm_ph[wg][k] = 0;
    fm_ph[wg][15] = clock64();
  }
  __syncthreads();
  const float mb0""")
    return s + READER


def make_copy(root: Path, variant: str) -> Path:
    dst = REPO / "build" / "probe" / variant
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
    csrc = dst / "featurematching_tpu_torch" / "csrc"
    src = (csrc / "fine_stage.cu").read_text()
    warpgroups = "encoder<D>(x0, x1" in src
    (csrc / "fine_stage.cu").write_text(stamp_warpgroups(src) if warpgroups else stamp_blocks(src))
    if variant == "no_weights":
        if warpgroups:
            raise SystemExit("fine_stage_probe: no_weights is for the block design (its weights "
                             "are read from L2 for every window)")
        tiles = csrc / "tiles.cuh"
        tiles.write_text(_replace(tiles.read_text(),
                                  "  return w + ((size_t)nt * (K / 16) + kt) * 256;",
                                  "  return w;  // probe: every B fragment from one fixed tile"))
    return dst


def measure(variant: str) -> None:
    """Run in the probe copy (on sys.path): time the calls and print the phases."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from featurematching_tpu_torch.ops import _build
    from featurematching_tpu_torch.ops import fine_stage as fs

    _build.build(["fine_stage"])
    lib = _build._load("fine_stage")
    lib.fm_read_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    names = ("self", "cross")
    layers = [cs.layer_values(g, C) for _ in names]
    mixes = [(cs.rnd(g, N, scale=0.3), cs.rnd(g, 1)) for _ in range(2)]
    w0 = cs.rnd(g, PAIRS, N, C, dtype=torch.bfloat16)
    w1 = cs.rnd(g, PAIRS, N, C, dtype=torch.bfloat16)
    warpgroups = hasattr(fs, "fine_stage_occupancy")
    sites = [("serving call", 2, lambda: fs.fine_stage_fused(w0, w1, layers, *mixes, names,
                                                             HEADS, fold_softargmax=True))]
    if warpgroups:
        sites.append(("K10 self call", 1,
                      lambda: fs.fine_layer_forward(w0, w1, layers[0], "self", HEADS)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for site, nl, fn in sites:
        ms = cs.cuda_ms(fn, iters=20)
        fn()
        torch.cuda.synchronize()
        if warpgroups:  # one set of counters a warpgroup
            occ = fs.fine_stage_occupancy(nl, HEADS, PAIRS)
            grid, slots, labels = occ["grid"], occ["pairs_in_flight"], WG_LABELS
            pairs = np.array([[len(range(b + w * grid, PAIRS, slots * grid)) for w in range(slots)]
                              for b in range(grid)], dtype=np.float64).reshape(-1)
            shape, unit = (grid, 4, 16), "warpgroup"
        else:  # one a block, three blocks an SM
            grid, slots, labels = min(3 * sms, PAIRS), 1, BLOCK_LABELS
            pairs = np.array([len(range(b, PAIRS, grid)) for b in range(grid)], dtype=np.float64)
            shape, unit = (grid, 1, 16), "block"
        buf = np.zeros(grid * shape[1] * 16, dtype=np.int64)
        if lib.fm_read_phases(buf.ctypes.data, buf.size):
            raise RuntimeError("fm_read_phases failed")
        ph = buf.reshape(shape)[:, :slots, :len(labels)].reshape(-1, len(labels))
        ph = ph.astype(np.float64)
        per = (ph / pairs[:, None]).mean(0)
        tot = ph.sum(1)
        print(f"[{variant}] {site}: {ms:.4f} ms with the stamps (events); a {unit} "
              f"{tot.mean():.0f} cycles (min {tot.min():.0f}, max {tot.max():.0f}) over "
              f"{pairs.mean():.2f} pairs; a pair {per.sum():.0f} cycles of its {unit}", flush=True)
        print("  cycles a pair: " + ", ".join(f"{n} {v:.0f}" for n, v in zip(labels, per)),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--variant", choices=("as_is", "no_weights"), default="as_is")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.variant)
        return 0
    copy = make_copy(Path(args.root).resolve(), args.variant)
    env = dict(os.environ, PYTHONPATH=str(copy))
    return subprocess.run([sys.executable, __file__, "--measure", "--variant", args.variant],
                          env=env, cwd=copy).returncode


if __name__ == "__main__":
    sys.exit(main())
