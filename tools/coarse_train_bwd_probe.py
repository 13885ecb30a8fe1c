"""Where K9's apply backward spends its time (`apply_bwd_kernel`,
`csrc/coarse_transformer_train.cu`), by clock stamps at its phases:

    python3 tools/coarse_train_bwd_probe.py [--variant V] [--width C] [ROOT]

ROOT (default: this checkout) is a checkout of the port. Its package is
copied to `build/probe/k9_<V>/` and the copy's kernel source gets
  - a device pointer `fm_probe_stamps` and a C entry `fm_probe_set` that
    sets it;
  - after each anchor line of the kernel (the end of a phase, most of them a
    barrier), thread 0 of each block stamping clock64() into
    fm_probe_stamps[block][stamp];
  - for the variant V (the redesign only): as_is, the kernel unchanged;
    no_weights, the products' B fragments made up in registers instead of
    read from L2 (the time the weights' way from L2 costs); ln1bwd_twice,
    the LN1 backward run twice in a rolled loop (its second pass finds its
    code in the instruction cache). Their results are garbage.
The anchors of the kernel's first design and of its redesign are below;
the set whose anchors all occur in the source is taken. The copy's library
is built, and one self call [8, 4800, C] and one cross call [4, 4800, C]
of `coarse_layer_backward` (chip_smoke.check_coarse_train's inputs; C 256
with 8 heads, or --width 128 with 4) run with the stamps on. For each call
it prints the mean cycles a block (a 64-token tile) spends in each phase,
the blocks' mean total, the time of apply_bwd alone from the profiler, and
the SM clock nvidia-smi reads. The stamps' stores cost a few cycles a
phase; the outputs are not checked.
"""

import shutil
import subprocess
import sys
from pathlib import Path

ARGS = sys.argv[1:]
OPTS = {k: ARGS[ARGS.index(k) + 1] for k in ("--variant", "--width") if k in ARGS}
VARIANT = OPTS.get("--variant", "as_is")
WIDTH = int(OPTS.get("--width", 256))
POSITIONAL = [a for i, a in enumerate(ARGS) if a not in OPTS and a not in OPTS.values()]
ROOT = Path(POSITIONAL[0] if POSITIONAL else Path(__file__).resolve().parents[1]).resolve()
SOURCE = Path("featurematching_tpu_torch/csrc/coarse_transformer_train.cu")
PROBE = """
__device__ long long* fm_probe_stamps;
#define FM_STAMP(i)                                                                         \\
  do {                                                                                      \\
    if (threadIdx.x == 0)                                                                   \\
      fm_probe_stamps[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NSTAMP + (i)] = clock64(); \\
  } while (0)
extern "C" int fm_probe_set(void* p) {
  return (int)cudaMemcpyToSymbol(fm_probe_stamps, &p, sizeof(p));
}
"""
# (anchor the stamp follows, name of the phase that ends there), in order;
# the first entry's stamp is the block's start
FIRST_STAMPS = [
    ("  const float s_f = (float)S;\n", "start"),
    ("mask[i] = 0u;\n  __syncthreads();\n", "x, K_sum and K^T V into shared memory"),
    ("qs[r * LD1 + c] = __float2bfloat16(fm::elu1(v));\n  });\n  __syncthreads();\n", "Q"),
    ("    zs[e] = z;\n  }\n  __syncthreads();\n", "Z (T.H threads)"),
    ("(zs[row * H + h] + kEps)));\n      });\n  }\n  __syncthreads();\n", "o"),
    ("  fm::copy_rows_from_smem(io.o + row0 * C, C, rb, LD1, valid, C);\n  __syncthreads();\n",
     "m1"),
    ("xa + C, LD2, warp, lane);\n  __syncthreads();\n", "LN1"),
    ("          rb[r * LD1 + c] = __float2bfloat16(v);\n        });\n    }\n  }\n"
     "  __syncthreads();\n", "FFN (h and y2)"),
    ("// dy2 over y2\n  __syncthreads();\n", "LN2 backward"),
    ("__float2bfloat16(on ? v : 0.f);\n                                         });\n"
     "  __syncthreads();\n", "dy1"),
    ("{ rbf[r * LDF + c] = v; });\n  __syncthreads();\n", "dmsg"),
    ("// dm1 over m1\n  __syncthreads();\n", "LN1 backward"),
    ("      dzs[(tm * 16 + (lane >> 2) + 8) * H + h] = dz_hi;\n    }\n  }\n  __syncthreads();\n",
     "do and dZ units"),
    ("// x again, over dm1\n  __syncthreads();\n", "partials (dK^T V, dK_sum)"),
    ("(qf > 0.f ? 1.0f : expf(qf)));\n      }\n    }\n  }\n  __syncthreads();\n", "dQ units"),
    ("__float2bfloat16(gval(r, c) + v);\n      });\n", "dx"),
]
# the redesign: a stamp that follows no barrier is thread 0's warp's view,
# and the wait for the other warps falls into the next phase
REDESIGN_STAMPS = [
    ("  const float s_f = (float)S;\n", "start"),
    ("  kvl.store(ks4);\n  __syncthreads();\n", "x, K_sum, K^T V and Q"),
    ("io.wmerge, S1, 0, 0, warp, lane);  // m1 = bf16(o . wmerge)\n", "Z, o and m1"),
    ("  stash(io.msg, C, os, LD1, C);\n", "LN1"),
    ("io.w2, S2, 0, ch * HC, warp, lane);\n  }\n", "FFN (h and y2)"),
    ("  stash(io.dy2, C, ks4, LD1, C);\n", "LN2 backward"),
    ("    product<C, HC>(acc2, dy1s + ch * HC, LD2, dy1s + ch * HC, LD2, io.w1mt, S2, 0, ch * HC,\n"
     "                   warp, lane);\n  }\n", "dy1 and dmsg"),
    ("  stash(io.dm1, C, ms, LD1, C);\n", "LN1 backward"),
    ("  kvl.store(ks4);  // over dy2, which no warp reads any more\n", "K^T V again and do"),
    ("    col_total<C, 1>(colp, io.part_ks + tile * C);\n  }\n", "Q.KV, dopre, dZ and dK_sum"),
    ("  __syncthreads();  // every warp has read Q\n", "dK^T V partials"),
    ("  stash(io.dqf, C, qs, LD1, C);\n", "dQ, x.wq and dqf"),
    ("gv.y + acc[i][j].c[2 * jp + 1]);\n  });\n", "dx"),
]
STAMP_SETS = [FIRST_STAMPS, REDESIGN_STAMPS]
# the products' B fragment reads and the LN1 backward's head, which the
# variants change
B_FIRST = "fb[p][j] = __ldg(b + ((size_t)j * steps + p) * 32);"
B_NEXT = "fb[p][j] = __ldg(b + ((size_t)j * steps + kk + PF) * 32);"
LN1_BWD = "  {  // the LN1 backward of dmsg (acc2, f32), a warp a row, dmsg through the\n"
VARIANTS = {
    "as_is": {},
    "no_weights": {B_FIRST: "fb[p][j] = make_uint4(lane, p, j, 0);",
                   B_NEXT: "fb[p][j] = make_uint4(lane, kk, j, 0);"},
    "ln1bwd_twice": {LN1_BWD: "#pragma unroll 1\n  for (int rep = 0; rep < 2; ++rep) {"
                              "  // the LN1 backward, twice\n"},
}


def make_copy():
    dst = ROOT / "build" / "probe" / f"k9_{VARIANT}"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    src = (dst / SOURCE).read_text()
    stamps = next((s for s in STAMP_SETS if all(src.count(a) == 1 for a, _ in s)), None)
    if stamps is None:
        raise SystemExit(f"no stamp set matches {ROOT / SOURCE}")
    for cut, keep in VARIANTS[VARIANT].items():
        if src.count(cut) != 1:
            raise SystemExit(f"variant {VARIANT} does not apply to {ROOT / SOURCE}")
        src = src.replace(cut, keep)
    for i, (anchor, _) in enumerate(stamps):
        # the last stamp waits for every warp; the others follow a barrier or the start
        pre = "  __syncthreads();\n" if i == len(stamps) - 1 else ""
        src = src.replace(anchor, anchor + pre + f"  FM_STAMP({i});\n")
    head = '#include "wgrad.cuh"\n'
    src = src.replace(head, head + f"constexpr int NSTAMP = {len(stamps)};\n" + PROBE, 1)
    (dst / SOURCE).write_text(src)
    return dst, [name for _, name in stamps]


def main() -> int:
    copy, names = make_copy()
    sys.path.insert(0, str(copy))
    import torch

    import chip_smoke as cs
    from featurematching_tpu_torch.ops import _build
    from featurematching_tpu_torch.ops import coarse_transformer_train as ctt

    assert Path(_build.__file__).resolve().is_relative_to(copy)
    _build.build(["coarse_transformer_train"])
    lib = _build._load("coarse_transformer_train")
    lib.fm_probe_set.argtypes = [_build.PTR]
    lib.fm_probe_set.restype = _build.INT
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
           "--format=csv,noheader"]
    card = subprocess.run(smi, capture_output=True, text=True).stdout.strip()
    print(f"[{ROOT}, {VARIANT}, C={WIDTH}] card {card}")
    g = torch.Generator(device="cuda").manual_seed(0)
    N, C, h = 4800, WIDTH, WIDTH // 32
    for G, kind in ((8, "self"), (4, "cross")):
        lv = cs.layer_values(g, C)
        lt = ctt.train_values(lv)
        x = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        src = x if kind == "self" else cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        gout = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        _, kv, ks = ctt.coarse_layer_forward(x, src, lv, h)
        tiles = G * -(-N // 64)
        stamps = torch.zeros(tiles, len(names), dtype=torch.int64, device="cuda")
        err = lib.fm_probe_set(stamps.data_ptr())
        if err:
            raise RuntimeError(f"fm_probe_set: CUDA error {err}")
        bwd = lambda: ctt.coarse_layer_backward(x, src, kv, ks, gout, lv, lt, h)  # noqa: E731
        for _ in range(3):
            bwd()
        torch.cuda.synchronize()
        clock = subprocess.run(smi, capture_output=True, text=True).stdout.strip()
        _, rows = cs.profile_ms(bwd)
        apply_ms = sum(ms for ms, _, name in rows if "apply_bwd_kernel" in name)
        d = (stamps[:, 1:] - stamps[:, :-1]).double()
        total = (stamps[:, -1] - stamps[:, 0]).double()
        print(f"  {kind} call [{G}, {N}, {C}], {tiles} tiles: apply_bwd {apply_ms:.4f} ms "
              f"(stamped); a tile {float(total.mean()):.0f} cycles (min {float(total.min()):.0f},"
              f" max {float(total.max()):.0f}); card now {clock}")
        for i, name in enumerate(names[1:]):
            mean = float(d[:, i].mean())
            print(f"    {name:42s} {mean:9.0f} cycles  {mean / float(total.mean()):6.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
