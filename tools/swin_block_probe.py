"""Where the Swin block body's time goes (K2, `csrc/swin_block.cuh`), by
variants of this checkout's header, each built into a copy of the port under
`build/probe/<variant>/` and timed at K2's six sites of the 640x480 batch-4
serving forward (chip_smoke.check_swin_block's inputs, CUDA events):

    python3 tools/swin_block_probe.py

  - as_is: the header unchanged;
  - no_copy: the weight stream issues no copies, so the products run on
    whatever the ring holds: the time the weights' way from L2 costs;
  - no_copy_no_barrier: no copies and no barrier a slice: the products,
    attention, LayerNorms and epilogues alone;
  - phases: the header unchanged but for thread 0 of each block stamping
    clock64() at the boundaries of the block's phases into a device array,
    which a C entry added to the copy's swin_block.cu reads back: the mean
    cycles a block spends in each phase (its own warp's view: a phase that
    ends without a barrier is thread 0's warp's, and the wait for the other
    warps falls into the next).
The variants' outputs are not checked (no_copy computes on stale weights).
Run in one call on one card; each variant runs in its own process.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = Path("featurematching_tpu_torch/csrc/swin_block.cuh")
COPY_LINE = "        fm::cp_async16(dst + row * LDX + c, src + (size_t)row * ld + c);\n"
BARRIER = "    fm::cp_async_wait<kStages - 2>();\n    __syncthreads();\n"
# phase stamps: (line of the kernel the stamp follows, stamp), in order
STAMPS = [
    ("  const int win = blockIdx.x;\n", 0),
    ("  layer_norm_rows<C>(xs, hs, ln1s, ln1b, warp, lane);\n", 1),
    ("__floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);\n    });\n  }\n  __syncthreads();\n", 2),
    ("    fm::attention_unit<D, MASKED>(qkv, LDQ, C, hd, tm, 0.25f, rel_bias, mv, lane, "
     "probs);\n", 3),
    ("                               xv.y + fm::round_bf16((v1 + bb.y) * sc1));\n  });\n"
     "  __syncthreads();\n", 4),
    ("  layer_norm_rows<C>(xs, hs, ln2s, ln2b, warp, lane);\n", 5),
    ("    product<C>(acc2, hid, LDX, ws, warp, lane);\n  }\n", 6),
    ("        *reinterpret_cast<const uint4*>(xs + r * LDX + c);\n  }\n}\n", 7),
]
PHASES = ["tokens, x and LN1", "qkv", "attention (warp 0)", "proj", "x1 and LN2", "MLP",
          "output"]
MAX_BLOCKS = 2400


def make_variant(name: str) -> Path:
    dst = ROOT / "build" / "probe" / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    h = (dst / HEADER).read_text()

    def sub(old, new):
        nonlocal h
        if h.count(old) != 1:
            raise SystemExit(f"{name}: the header no longer has exactly one {old!r}")
        h = h.replace(old, new)

    if name in ("no_copy", "no_copy_no_barrier"):
        sub(COPY_LINE, "")
    if name == "no_copy_no_barrier":
        sub(BARRIER, "    fm::cp_async_wait<kStages - 2>();\n")
    if name == "phases":
        sub("namespace swin {\n", "namespace swin {\n\n"
            f"__device__ long long g_phase[{MAX_BLOCKS} * 8];\n")
        for line, k in STAMPS:
            stamp = (f"  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) "
                     f"g_phase[blockIdx.x * 8 + {k}] = clock64();\n")
            if line.endswith("}\n}\n"):  # the kernel's last line: stamp before its brace
                sub(line, line[:-2] + stamp + "}\n")
            else:
                sub(line, line + stamp)
        cu = dst / "featurematching_tpu_torch/csrc/swin_block.cu"
        cu.write_text(cu.read_text() + (
            "\nextern \"C\" int fm_swin_phases(void* dst, int n) {\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(dst, swin::g_phase, "
            "n * sizeof(long long)));\n}\n"))
    (dst / HEADER).write_text(h)
    return dst


def worker(name: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
    from featurematching_tpu_torch.ops import _build
    from featurematching_tpu_torch.ops.swin_block import swin_block_fused

    _build.build(["swin_block"])
    g = torch.Generator(device="cuda").manual_seed(0)
    total = 0.0
    for nwin, C, h, (Hp, Wp), n_plain, n_mask in [
            (2400, 64, 4, (120, 160), 2, 1), (640, 128, 8, (64, 80), 2, 1),
            (160, 256, 16, (32, 40), 4, 3)]:
        x = cs.rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        p = cs.block_params(g, C, h)
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, 4), device="cuda")
        for m, count in ((None, n_plain), (mask, n_mask)):
            ms = cs.cuda_ms(lambda: swin_block_fused(x, m, p, h), iters=50)
            total += count * ms
            line = f"  {name}: C={C} mask={m is not None}: {ms:.4f} ms x{count}"
            if name == "phases":
                swin_block_fused(x, m, p, h)
                torch.cuda.synchronize()
                n = min(nwin, MAX_BLOCKS)
                buf = np.zeros(n * 8, dtype=np.int64)
                lib = _build._load("swin_block")
                lib.fm_swin_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.fm_swin_phases.restype = ctypes.c_int
                if lib.fm_swin_phases(buf.ctypes.data, n * 8) != 0:
                    raise SystemExit("reading the phase stamps failed")
                d = np.diff(buf.reshape(n, 8), axis=1).mean(axis=0)
                line += "; cycles a block: " + ", ".join(
                    f"{p_} {v:.0f}" for p_, v in zip(PHASES, d))
            print(line, flush=True)
    print(f"  {name}: 13 launches {total:.4f} ms", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card {card}", flush=True)
    rc = 0
    for name in ("as_is", "no_copy", "no_copy_no_barrier", "phases"):
        root = make_variant(name)
        env = dict(os.environ, PYTHONPATH=str(root))
        rc |= subprocess.run([sys.executable, __file__, "--worker", name], env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
