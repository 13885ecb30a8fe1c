"""K11, the window attention of the per-op Swin block (`window_attention`,
`csrc/window_attention.cu`), of one checkout of the port at the evaluation
step's 13 sites, timed on one card, for comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/window_attention_ab.py [--check] [--probe]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the sites (`backbone_blocks`: 640x480, batch 4, the shift mask on odd
blocks) and the timers, and its wrapper the kernel. The reports come from
`kernel_report.py` and the bound from `utils/kernel_bounds.py` of this
script's checkout, so an older ROOT is held to the same one. The script
builds ROOT's `window_attention` library anew and prints
  - what `-Xptxas -v` says of the kernel at each instantiation (registers,
    spills) and the blocks an SM its registers allow;
  - the kernel's dynamic shared memory, ring slots and resident blocks an
    SM at each head dim, with and without a mask (ROOT's `occupancy` where
    its wrapper has one; else one block a window with its q|k|v rows);
  - at every site of `default_config()` (head dim 16, 13 launches) and of
    `tpu_optimized_config()` (head dim 64): ROOT's plan (head groups, runs,
    blocks, windows a run) where it has one, the kernel's device time a
    launch by the profiler and by CUDA events, the host's time a call
    (the host clock around HOST_CALLS calls issued with no wait for the
    card), and its bound (`kernel_bounds.window_attention_work`); then each
    configuration's sum over its 13 launches against the sum of the bounds.
With --check it first holds the kernel against its plain twin at every
site of both configurations and at head dim 32 (chip_smoke.py's K11_ATOL /
K11_RTOL) and two calls bit for bit, and exits 1 on a disagreement. With
--probe it then times copies of ROOT's kernel with one part left out each
(`build/probe/k11/VARIANT`, this script run there at default_config()'s
sites):
  no_bias      the bias's registers zeros, not loaded;
  no_mask      the mask's reads from the slot and its adds (its copies stay);
  no_exp       the softmax's exponentials replaced by their argument;
  no_products  the mma.sync products replaced by an xor of their fragments;
  copies_only  no unit: the ring's tensor copies and hand-backs alone.
Their results are wrong by design: only their times count. Run one tree
after another in one call on one card (old, new, new, old).
"""

import importlib.util
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
import kernel_report as kr
from featurematching_tpu_torch.config import default_config, tpu_optimized_config
from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
from featurematching_tpu_torch.ops import window_attention as wa

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "kernel_bounds", REPO / "featurematching_tpu_torch" / "utils" / "kernel_bounds.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

ITERS, HOST_CALLS = 50, 200
KERNEL = "window_attention_kernel"
MMA_S = "fm::mma16(s[kt], qa[kc], kb);"
MMA_O = "fm::mma16(o, pa[kt], vb);"
EDITS = {
    "no_bias": [("      if (live)\n        b = ", "      if (false)\n        b = ")],
    "no_mask": [("      if (MASKED) {\n        const int row",
                 "      if (false) {\n        const int row")],
    "no_exp": [("ex2(__fmaf_rn(s[kt].c[j], kLog2e, off[i]))",
                "__fmaf_rn(s[kt].c[j], kLog2e, off[i])")],
    "no_products": [
        (MMA_S, "s[kt].c[0] += __uint_as_float(qa[kc][0] ^ qa[kc][1] ^ qa[kc][2] ^ qa[kc][3] ^ "
                "kb[0] ^ kb[1] ^ kb[2] ^ kb[3]);"),
        (MMA_O, "o.c[0] += __uint_as_float(pa[kt][0] ^ pa[kt][1] ^ pa[kt][2] ^ pa[kt][3] ^ "
                "vb[0] ^ vb[1] ^ vb[2] ^ vb[3]);")],
    "copies_only": [("    if (live) {\n      unit<", "    if (false) {\n      unit<")],
}


def sites(cfg):
    """[(launches, windows, C, heads, the padded map of the shift mask or
    None)] of the backbone's blocks at 640x480, batch 4, as chip_smoke.py
    checks them."""
    out = []
    for count, hw, C, h, shift in cs.backbone_blocks(cfg):
        Hp, Wp = cs.padded(hw)
        out.append((count, 2 * cs.B * (Hp // 8) * (Wp // 8), C, h, (Hp, Wp) if shift else None))
    return out


def inputs(g, nwin, C, h, hw):
    qkv = cs.rnd(g, nwin, 64, 3 * C, dtype=torch.bfloat16)
    bias = cs.rnd(g, h, 64, 64, scale=0.02)
    mask = torch.as_tensor(_shift_attn_mask(*hw, 8, 4), device="cuda") if hw else None
    return qkv, bias, mask, h, (C // h) ** -0.5


def block_report(log: str) -> None:
    new = hasattr(wa, "plan")
    kr.ptxas_report(log, (KERNEL,), threads=544 if new else 256)
    for d in wa.HEAD_DIMS:
        for masked in (False, True):
            if new:
                nbytes, slots, per_sm = wa.occupancy(d, masked)
                print(f"  D={d} mask={masked}: {nbytes} bytes of dynamic shared memory, {slots} "
                      f"ring slots of {3 * 8192 + (16384 if masked else 0)} bytes, {per_sm} "
                      f"block(s) an SM", flush=True)
    if not new:
        print("  one block a window: 64 x (3C + 8) x 2 bytes of shared memory "
              f"({', '.join(f'C={c}: {64 * (3 * c + 8) * 2}' for c in (64, 128, 256))})",
              flush=True)


def plan_line(nwin, C, h, masked) -> str:
    if not hasattr(wa, "plan"):
        return f"grid {nwin} (a block a window)"
    p = wa.launch_plan(nwin, C, h, masked)
    sizes = [b - a for a, b in (wa.run_windows(r, p.runs, nwin) for r in range(p.runs))]
    return (f"plan {p.groups} group(s) x {p.runs} runs = {p.grid} blocks, "
            f"{min(sizes)}-{max(sizes)} windows a run")


def check(g) -> bool:
    ok = True
    cases = [(n, C, h, hw) for cfg in (default_config().model, tpu_optimized_config().model)
             for _, n, C, h, hw in sites(cfg)] + [(640, 128, 4, (64, 80))]
    for nwin, C, h, hw in cases:
        args = inputs(g, nwin, C, h, hw)
        got = wa.window_attention(*args)
        torch.cuda.synchronize()
        err, good = cs.close(got, wa.window_attention_reference(*args), cs.K11_ATOL, cs.K11_RTOL)
        same = torch.equal(got, wa.window_attention(*args))
        print(f"  check {nwin} windows C={C} heads {h} mask={hw is not None}: max_abs_err "
              f"{err:.3e} (<= {cs.K11_ATOL} + {cs.K11_RTOL} |plain|: {good}), bit-identical "
              f"twice {same}: {'ok' if good and same else 'FAIL'}", flush=True)
        ok = ok and good and same
    return ok


def host_us(fn) -> float:
    """The host's microseconds a call of fn(), issued HOST_CALLS times with
    no wait for the card."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


def time_sites(g, label, cfg) -> None:
    total = events = bound = host = 0.0
    launches = 0
    for count, nwin, C, h, hw in sites(cfg):
        args = inputs(g, nwin, C, h, hw)
        fn = lambda: wa.window_attention(*args)  # noqa: E731
        dev = kr.by_kernel(fn, (KERNEL,))[KERNEL]
        ev = cs.cuda_ms(fn, iters=ITERS)
        us = host_us(fn)
        b, by = kb.bound_ms(*kb.window_attention_work(nwin, C, h, 0 if hw is None else
                                                      args[2].shape[0]))
        print(f"  {label} x{count} {nwin} windows C={C} heads {h} mask={hw is not None}: "
              f"{dev:.4f} ms a launch by the profiler ({ev:.4f} by events, host {us:.1f} µs a "
              f"call), bound {b:.4f} ms ({by}), {b / dev:.3f} of it; "
              f"{plan_line(nwin, C, h, hw is not None)}",
              flush=True)
        total += count * dev
        events += count * ev
        bound += count * b
        host += count * us / 1e3
        launches += count
    print(f"  {label}: K11 over {launches} launches {total:.4f} ms by the profiler "
          f"({events:.4f} by events, host {host:.4f} ms), bound {bound:.4f} ms, "
          f"{bound / total:.3f} of it", flush=True)


def probe(root: Path) -> int:
    for v, edits in EDITS.items():
        dst = REPO / "build" / "probe" / "k11" / v
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(root / "featurematching_tpu_torch", dst / "featurematching_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
        cu = dst / "featurematching_tpu_torch" / "csrc" / "window_attention.cu"
        src = cu.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"window_attention_ab: the source does not hold {old!r} once")
            src = src.replace(old, new)
        cu.write_text(src)
        print(f"== probe {v}", flush=True)
        r = subprocess.run([sys.executable, __file__, "--default-only"],
                           env=dict(os.environ, PYTHONPATH=str(dst)))
        if r.returncode:
            return r.returncode
    return 0


def main() -> int:
    args = sys.argv[1:]
    block_report(kr.rebuild("window_attention"))
    g = torch.Generator(device="cuda").manual_seed(0)
    if "--check" in args and not check(g):
        return 1
    time_sites(g, "default_config()", default_config().model)
    if "--default-only" in args:
        return 0
    time_sites(g, "tpu_optimized_config()", tpu_optimized_config().model)
    if "--probe" in args:
        return probe(Path(wa.__file__).resolve().parents[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
