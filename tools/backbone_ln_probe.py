"""Where K4 (`csrc/patch_expand.cu`) spends its time at the serving sites:
the kernel with one part taken out at a time, beside plain copies that move
each site's bytes.

    python3 tools/backbone_ln_probe.py ROOT [VARIANT ...]

copies ROOT's `featurematching_tpu_torch` and `chip_smoke.py` (ROOT: `.`, or
another commit unpacked with `git archive` into a directory `.gitignore`
lists) to `build/probe/ln/VARIANT/` for each variant, edits the copy's
`patch_expand.cu` and runs `tools/backbone_ln_ab.py` there (each site's
device time by the profiler). Variants (the first five by default):
  as_is          the kernel as it is;
  no_product     the head's products and their B fragments left out (the
                 accumulators take one A value, so the A loads stay);
  no_head_store  the head's stores to device memory left out;
  no_ln_store    the LN output's stores left out;
  no_ln          both LNs left out (the loaded rows go on as they are);
  min_blocks_3, ck32, ck32_min_blocks_3
                 other blockings, whole and right: registers held to three
                 blocks an SM, accumulators of 32 columns, or both.
The results of no_product, no_head_store, no_ln_store and no_ln are wrong
by design: only their times count. Then, in ROOT, the device time of `Tensor.copy_` of each site's
input (as many bytes read as written) and of `Tensor.zero_` of each site's
outputs (writes alone), by the profiler: what the memory system gives for
the site's reads and writes without the kernel.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PRODUCT = """        uint32_t fb[4];
        fm::load_b(fb, sw + k * 16 * S::LDW + c0 + n0 + n * 16, S::LDW, lane);
        fm::mma16(acc[n], fa, fb);"""
EDITS = {
    "as_is": [],
    "no_product": [(PRODUCT, "        acc[n].c[0] += __uint_as_float(fa[0]);")],
    "no_head_store": [("          if (q < total)\n            *reinterpret_cast<uint4*>(head_out",
                       "          if (q < 0)\n            *reinterpret_cast<uint4*>(head_out")],
    "no_ln_store": [("if (ln_out && q < total)", "if (ln_out && q < 0)")],
    "no_ln": [("    ln(v);\n", "")],
    # other blockings: three blocks an SM where the registers allow it, or
    # accumulators of 32 columns
    "min_blocks_3": [("static constexpr int kMinBlocks = 2;", "static constexpr int kMinBlocks = 3;")],
    "ck32": [("static constexpr int CK = CW < 64 ? CW : 64;",
              "static constexpr int CK = CW < 32 ? CW : 32;")],
    "ck32_min_blocks_3": [
        ("static constexpr int kMinBlocks = 2;", "static constexpr int kMinBlocks = 3;"),
        ("static constexpr int CK = CW < 64 ? CW : 64;",
         "static constexpr int CK = CW < 32 ? CW : 32;")],
}
DEFAULT = ["as_is", "no_product", "no_head_store", "no_ln_store", "no_ln"]
# (site, input shape, output shapes): dec0, dec1, dec2 of the serving forward
SITES = [("dec0", (8, 1200, 512), [(8, 4800, 128), (8, 4800, 256)]),
         ("dec1", (8, 4800, 256), [(8, 19200, 64)]),
         ("dec2", (8, 19200, 256), [(8, 76800, 64)])]


def make_copy(root: Path, variant: str) -> Path:
    dst = REPO / "build" / "probe" / "ln" / variant
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
    cu = dst / "featurematching_tpu_torch" / "csrc" / "patch_expand.cu"
    src = cu.read_text()
    for old, new in EDITS[variant]:
        if src.count(old) != 1:
            raise SystemExit(f"backbone_ln_probe: the source does not hold {old!r} once")
        src = src.replace(old, new)
    cu.write_text(src)
    return dst


def copies() -> None:
    """The plain copies of each site's bytes, by the profiler."""
    import torch

    import chip_smoke as cs

    for site, shape, outs in SITES:
        x = torch.randn(*shape, device="cuda").bfloat16()
        y = torch.empty_like(x)
        o = [torch.empty(*s, device="cuda", dtype=torch.bfloat16) for s in outs]
        cp = cs.device_ms(lambda: y.copy_(x))
        zs = [cs.device_ms(lambda t=t: t.zero_()) for t in o]
        mb = x.numel() * 2 / 1e6
        print(f"  {site}: copy_ of its input ({mb:.1f} MB read, {mb:.1f} MB written) "
              f"{cp:.4f} ms; zero_ of its outputs ("
              + ", ".join(f"{t.numel() * 2 / 1e6:.1f} MB {z:.4f} ms" for t, z in zip(o, zs))
              + ")", flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--copies":
        copies()
        return 0
    root = Path(sys.argv[1]).resolve()
    variants = sys.argv[2:] or DEFAULT
    for v in variants:
        dst = make_copy(root, v)
        print(f"== {v}", flush=True)
        env = dict(os.environ, PYTHONPATH=str(dst))
        r = subprocess.run([sys.executable, str(REPO / "tools" / "backbone_ln_ab.py")], env=env)
        if r.returncode:
            return r.returncode
    print("== plain copies", flush=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run([sys.executable, __file__, "--copies"], env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
