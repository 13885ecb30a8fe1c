"""Where K9's stats_bwd (`stats_bwd_kernel`, `csrc/coarse_transformer_train.cu`)
spends its time, by variants of the kernel that leave one part out:

    python3 tools/coarse_stats_bwd_probe.py [ROOT] [--variants a,b,..]

ROOT (default: this checkout) is a checkout of the port. For each variant
its package and `chip_smoke.py` are copied to `build/probe/sb_<variant>/`,
the copy's kernel source is patched (VARIANTS: each a list of (text, its
replacement), every text found exactly once), the copies' libraries are
built at once, and a child process on each copy in turn times stats_bwd alone by the profiler
(`tools/kernel_report.by_kernel`) in `coarse_layer_backward` at the
training step's self call [8, 4800, 256] and cross call [4, 4800, 256] (8
heads), printing both and their sum over the step's 12 calls (4 self, 8
cross). as_is is the kernel unchanged; the other variants' outputs are
garbage and not checked:
  - no_stash: the stash's [dkf | dv] not stored;
  - no_heads: no per-head dV and dK products (dkf and dv made from K and V);
  - no_dsrc: no dsrc products (its accumulator stays 0);
  - no_kv: no [K | V] products (the unit's accumulator stays 0);
  - no_exp: elu and its derivative without the exponential;
  - stamps: the kernel unchanged but for globaltimer stamps (ns) a block
    at its start and a warpgroup at each tile's start (its source tile in)
    and end (dsrc stored); the child prints, at each call, the blocks'
    mean start-up (block start to its first tile's start), the mean time of
    a tile that both warpgroups run at once (a pair round) and of one run
    alone, and the spread of the blocks' ends from the first block's start.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = Path("featurematching_tpu_torch/csrc/coarse_transformer_train.cu")
MAXT = 8  # tiles a warpgroup stamps
_KEEP = []
NSTAMP = 1 + 4 * MAXT
PROBE = f"""constexpr int MAXT = {MAXT}, NSTAMP = {NSTAMP};
__device__ long long* fm_probe_stamps;
__device__ __forceinline__ long long fm_probe_now() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
}}  // namespace
extern "C" int fm_probe_set(void* p) {{
  return (int)cudaMemcpyToSymbol(fm_probe_stamps, &p, sizeof(p));
}}
namespace {{
"""
VARIANTS = {
    "as_is": [],
    "no_stash": [
        ("          store16(st + 16 * n, 2 * C, af[u][n], r0, valid, t);\n"
         "          store16(st + C + 16 * n, 2 * C, af[u][2 + n], r0, valid, t);\n", ""),
    ],
    "no_heads": [
        ("            fm::mma16(dv, kfr[gu][gk], fb);\n", ""),
        ("            fm::mma16(dk, vfr[gu][gk], ft);\n", ""),
        ("            fm::load_b(fb, dkvp + fd * LDKV + e0, LDKV, lane);\n", ""),
        ("            load_b_t(ft, dkvp + (h * D + e0) * LDKV + 16 * dd, LDKV, lane);\n", ""),
    ],
    "no_dsrc": [
        ("            fm::wgmma_rs_n256<1>(ds, af[u][kk], mdesc(slot + kk * 2048), 1);\n",
         "            fm::fence_regs(ds);\n"),
        ("            fm::wgmma_rs_n128<1>(ds, af[u][kk], mdesc(slot + kk * 2048), 1);\n",
         "            fm::fence_regs(ds);\n"),
    ],
    "no_kv": [
        ("          fm::wgmma_ss_n64(acc, kdesc(ssrc + at), kdesc(slot + at), 1);\n",
         "          fm::fence_regs(acc);\n"),
    ],
    "stamps": [
        ("  const int items = rounds * UNITS;  // the units the ring brings in\n",
         "  const int items = rounds * UNITS;  // the units the ring brings in\n"
         "  long long* stamp = fm_probe_stamps + (size_t)blockIdx.x * NSTAMP;\n"
         "  if (threadIdx.x == 0) stamp[0] = fm_probe_now();\n"),
        ("    fm::mbar_wait(&sfull[wg], k & 1);\n",
         "    fm::mbar_wait(&sfull[wg], k & 1);\n"
         "    if (wt == 0 && k < MAXT) stamp[1 + 2 * (wg * MAXT + k)] = fm_probe_now();\n"),
        ("      store16(dst + 16 * n, C, f, r0, valid, t);\n    }\n",
         "      store16(dst + 16 * n, C, f, r0, valid, t);\n    }\n"
         "    if (wt == 0 && k < MAXT) stamp[2 + 2 * (wg * MAXT + k)] = fm_probe_now();\n"),
        ("constexpr int SU = 32;", PROBE + "constexpr int SU = 32;"),
    ],
    "no_exp": [
        ("const float e0 = __expf(fminf(acc[a], 0.f)), e1 = __expf(fminf(acc[a + 1], 0.f));",
         "const float e0 = fminf(acc[a], 0.f), e1 = fminf(acc[a + 1], 0.f);"),
    ],
}
G_CALLS = [(8, "self", 4), (4, "cross", 8)]  # (images, kind, calls a step)
N, C, HEADS = 4800, 256, 8


def timeline(bwd, G: int, kind: str) -> None:
    """One call with the stamps on: start-up, pair and lone tiles, ends."""
    import ctypes

    import torch

    from featurematching_tpu_torch.ops import _build
    from featurematching_tpu_torch.ops import coarse_transformer_train as ctt

    blocks = min(G * -(-N // 64), torch.cuda.get_device_properties(0).multi_processor_count
                 * ctt.stats_bwd_occupancy(C, C // HEADS)["blocks_per_sm"])
    held = torch.zeros(blocks, NSTAMP, dtype=torch.int64, device="cuda")
    _KEEP.append(held)  # later launches stamp it too
    _build.launch("coarse_transformer_train", "fm_probe_set", [ctypes.c_void_p], held.data_ptr())
    bwd()
    torch.cuda.synchronize()
    st = held.cpu().double()
    t0 = st[:, 0].min()
    tiles = st[:, 1:].reshape(blocks, 2, MAXT, 2)  # [block, wg, k, start | end]
    ran = tiles[..., 1] > 0
    dur = (tiles[..., 1] - tiles[..., 0]) / 1e3
    pair = ran[:, 0] & ran[:, 1]  # [block, k]: both warpgroups run their k-th tile
    alone = ran[:, 0] & ~ran[:, 1]
    start = (tiles[:, 0, 0, 0] - st[:, 0]) / 1e3
    ends = (tiles[..., 1].amax(dim=(1, 2)) - t0) / 1e3
    print(f"  {kind}: {blocks} blocks; start-up {float(start.mean()):.2f} us; a pair round "
          f"{float(dur[:, 0][pair].mean()):.2f} / {float(dur[:, 1][pair].mean()):.2f} us (wg 0 / "
          f"1, {int(pair.sum())}), a tile alone {float(dur[:, 0][alone].mean()):.2f} us "
          f"({int(alone.sum())}); blocks end {float(ends.min()):.2f}-{float(ends.max()):.2f} us "
          f"(mean {float(ends.mean()):.2f}) after the first start", flush=True)


def child(stamped: bool) -> None:
    """In the copy: stats_bwd's device ms at each call, and over the step."""
    import torch

    import chip_smoke as cs
    from featurematching_tpu_torch.ops import coarse_transformer_train as ctt

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kernel_report as kr

    g = torch.Generator(device="cuda").manual_seed(0)
    total = 0.0
    parts = []
    for G, kind, count in G_CALLS:
        lv = cs.layer_values(g, C)
        lt = ctt.train_values(lv)
        x = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        src = x if kind == "self" else cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        gout = cs.rnd(g, G, N, C, dtype=torch.bfloat16)
        _, kv, ks = ctt.coarse_layer_forward(x, src, lv, HEADS)
        bwd = lambda: ctt.coarse_layer_backward(x, src, kv, ks, gout, lv, lt, HEADS)  # noqa: E731
        if stamped:
            timeline(bwd, G, kind)
        split = kr.by_kernel(bwd, ("stats_bwd_kernel",))
        ms = split["stats_bwd_kernel"]
        total += count * ms
        parts.append(f"{kind} {ms:.4f}")
    print(f"stats_bwd: {', '.join(parts)} ms a call; {total:.4f} ms over the step's 12 calls",
          flush=True)


def main() -> int:
    args = sys.argv[1:]
    if "--build" in args:  # in the copy: its two libraries
        from featurematching_tpu_torch.ops import _build

        _build.build(["coarse_transformer_train", "coarse_transformer"])
        return 0
    if "--child" in args:
        child("--stamped" in args)
        return 0
    names = list(VARIANTS)
    if "--variants" in args:
        names = args[args.index("--variants") + 1].split(",")
        del args[args.index("--variants"):args.index("--variants") + 2]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1]).resolve()
    here = Path(__file__).resolve().parents[1]
    dsts = {}
    for name in names:
        dst = dsts[name] = here / "build" / "probe" / f"sb_{name}"
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
        path = dst / SOURCE
        src = path.read_text()
        for old, new in VARIANTS[name]:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} found {src.count(old)} times")
            src = src.replace(old, new)
        path.write_text(src)
    me = str(Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--build"], cwd=dst,
                               env=dict(os.environ, PYTHONPATH=str(dst))) for dst in dsts.values()]
    if any(b.wait() for b in builds):
        return 1
    for name, dst in dsts.items():
        print(f"[{name}]", flush=True)
        r = subprocess.run([sys.executable, me, "--child"] + (["--stamped"] if name == "stamps"
                                                               else []),
                           env=dict(os.environ, PYTHONPATH=str(dst)), cwd=dst)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
