"""Faults planted in K8's, K9's and K10's backwards at head dim 64, each
to be caught by `chip_smoke.py`'s check of that backward:

    python3 tools/train_bwd_faults.py [ROOT] [--variants a,b,..]

ROOT (default: this checkout) is a checkout of the port. For each fault its
package and `chip_smoke.py` are copied to `build/probe/faults/<fault>/`,
the copy's kernel source is patched (FAULTS: the source, then (text, its
replacement) pairs, every text found exactly once) and the copy's wrapper
allocates with torch.zeros where it had torch.empty (so what a fault
leaves unwritten reads as zero, not as stale memory). The copies'
libraries are built at once, then a child process on each copy in turn
runs chip_smoke's check of that backward at tpu_optimized_config()'s
widths: `check_swin_block_train` with heads 1/2/4, `check_coarse_train`
with 4 heads and `check_fine_train` with one head. A fault is caught
where the check raises its AssertionError. Exits 1 if a fault is not
caught or its run fails otherwise (a build error, another exception).
  - k8_window: attn_bwd leaves each launch's last window out;
  - k8_column_part: at C = 256 (head dim 64: a row tile's two warps each
    own two of its four key tiles) the second column part writes none of
    its key tiles of the dS strip and of the rel_bias partial;
  - k9_query_tile: apply_bwd at head dim 64 leaves each image's last query
    tile out;
  - k9_source_tile: stats_bwd at head dim 64 leaves the last source tile
    out;
  - k9_unit: stats_bwd at head dim 64 reads a head's k-steps all from the
    first of its two units (the second unit's K and V left out of dV and
    dK);
  - k10_kstep: window_bwd at head dim 64 leaves a row's last k-step out of
    the head sums of Z and dZ.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path("featurematching_tpu_torch/csrc")
OPS = Path("featurematching_tpu_torch/ops")
# kernel: (its library, the libraries its check builds, its wrapper)
KERNELS = {
    "k8": ("swin_block_train", ["swin_block_train"], "swin_block_train.py"),
    "k9": ("coarse_transformer_train", ["coarse_transformer_train", "coarse_transformer"],
           "coarse_transformer_train.py"),
    "k10": ("fine_transformer_train", ["fine_transformer_train", "fine_stage"],
            "fine_transformer_train.py"),
}
FAULTS = {
    "k8_window": ("k8", [
        ("  ws.start((num_windows - (int)blockIdx.x",
         "  ws.start((num_windows - 1 - (int)blockIdx.x"),
        ("  for (int win = blockIdx.x; win < num_windows; win += gridDim.x) {",
         "  for (int win = blockIdx.x; win < num_windows - 1; win += gridDim.x) {"),
    ]),
    "k8_column_part": ("k8", [
        ("      if (!mine) continue;", "      if (!mine || (C == 256 && cp == 1)) continue;"),
        ("          if (kt / U::KT == cp)", "          if (kt / U::KT == cp && !(C == 256 && cp == 1))"),
    ]),
    "k9_query_tile": ("k9", [
        ("apply_bwd_kernel<C, D><<<dim3(tiles_l, G),",
         "apply_bwd_kernel<C, D><<<dim3(tiles_l - (D == 64), G),"),
    ]),
    "k9_source_tile": ("k9", [
        ("                G * ((S + T - 1) / T)};", "                G * ((S + T - 1) / T) - (D == 64)};"),
    ]),
    "k9_unit": ("k9", [
        ("gu = fd / SU - q, gk", "gu = 0, gk"),
    ]),
    "k10_kstep": ("k10", [
        ("      for (int kk = 1; kk < 4; ++kk) s[i] += v[kk][i] + v[kk][i + 2];",
         "      for (int kk = 1; kk < 3; ++kk) s[i] += v[kk][i] + v[kk][i + 2];"),
    ]),
}


def child(kernel: str) -> int:
    """In the copy: the kernel's head-dim-64 check; 0 where it raises."""
    import torch

    import chip_smoke as cs

    g = torch.Generator(device="cuda").manual_seed(0)
    rec = cs.Record()
    check = {"k8": lambda: cs.check_swin_block_train(rec, g, (1, 2, 4), "@hd64"),
             "k9": lambda: cs.check_coarse_train(rec, g, 4, "@hd64"),
             "k10": lambda: cs.check_fine_train(rec, g, 1, "@hd64")}[kernel]
    try:
        check()
    except AssertionError as e:
        print(f"  caught: {e}", flush=True)
        return 0
    print("  NOT caught: the check passed", flush=True)
    return 3


def main() -> int:
    args = sys.argv[1:]
    if "--build" in args:  # in the copy: its kernel's libraries
        from featurematching_tpu_torch.ops import _build

        _build.build(KERNELS[args[args.index("--build") + 1]][1])
        return 0
    if "--child" in args:
        return child(args[args.index("--child") + 1])
    names = list(FAULTS)
    if "--variants" in args:
        names = args[args.index("--variants") + 1].split(",")
        del args[args.index("--variants"):args.index("--variants") + 2]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1]).resolve()
    here = Path(__file__).resolve().parents[1]
    dsts = {}
    for name in names:
        kernel, edits = FAULTS[name]
        lib, _, wrapper = KERNELS[kernel]
        dst = dsts[name] = here / "build" / "probe" / "faults" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
        path = dst / CSRC / f"{lib}.cu"
        src = path.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} found {src.count(old)} times")
            src = src.replace(old, new)
        path.write_text(src)
        path = dst / OPS / wrapper
        path.write_text(path.read_text().replace("torch.empty", "torch.zeros"))
    me = str(Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--build", FAULTS[name][0]], cwd=dst,
                               env=dict(os.environ, PYTHONPATH=str(dst)))
              for name, dst in dsts.items()]
    if any(b.wait() for b in builds):
        return 1
    missed = []
    for name, dst in dsts.items():
        print(f"[{name}]", flush=True)
        r = subprocess.run([sys.executable, me, "--child", FAULTS[name][0]],
                           env=dict(os.environ, PYTHONPATH=str(dst)), cwd=dst)
        if r.returncode:
            missed.append(name)
    print(f"faults caught: {len(names) - len(missed)} of {len(names)}"
          + (f"; not caught or failed: {', '.join(missed)}" if missed else ""), flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
