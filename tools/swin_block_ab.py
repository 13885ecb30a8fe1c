"""The Swin block body (K2, K8's forward and K12, all on
`csrc/swin_block.cuh`) of one checkout of the port, timed on one card for
comparing two versions of it.

    PYTHONPATH=ROOT python3 tools/swin_block_ab.py [--check]

ROOT is a checkout of the port (`.`, or another commit unpacked with `git
archive` into a directory `.gitignore` lists); its `chip_smoke.py` supplies
the inputs and the timer. The script builds ROOT's three libraries of the
body, prints what `-Xptxas -v` says of each block kernel (registers, spills,
shared memory) with the blocks an SM those allow, and times by CUDA events
(50 launches after a warm-up):
  - K2 at the six sites of `chip_smoke.check_swin_block` (C = 64, 128 and 256
    of the 640x480 batch-4 backbone, without and with the shift mask) and
    the serving forward's 13 launches in all;
  - K8's forward at the same sites (the training step's: drop-path scales on
    the masked sites, probabilities and x1 saved) and its 13 launches;
  - K2 at C = 256 on 132, 160 and 264 windows: what the serving forward's
    160 windows cost against one full wave of 132 SMs and two;
  - K12 over the backbone's 13 blocks on the real maps.
With --check it first holds each against its plain twin (chip_smoke.py's
tolerances) and exits 1 on a disagreement. Run one tree after another in one
call on one card (old, new, new, old).
"""

import re
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from featurematching_tpu_torch.config import default_config
from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.swin_block import swin_block_fused, swin_block_reference
from featurematching_tpu_torch.ops.swin_block_image import (
    pad_image,
    swin_block_fused_image,
    swin_block_image_reference,
)
from featurematching_tpu_torch.ops.swin_block_train import (
    _kernel_params,
    swin_block_train_fwd,
    swin_block_train_reference,
)

ITERS = 50
SM_REGS, THREADS = 65536, 256
# (windows, C, heads, padded map, launches a forward without / with the mask)
SITES = [(2400, 64, 4, (120, 160), 2, 1), (640, 128, 8, (64, 80), 2, 1),
         (160, 256, 16, (32, 40), 4, 3)]


def ptxas_report(logs: dict) -> None:
    """Each block kernel's registers and spills from ptxas, and the blocks an
    SM its registers allow at 256 threads (ptxas does not count the dynamic
    shared memory a launch asks for: Smem<C>::bytes)."""
    for lib, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S*swin_block_kernel\S*)'", line)
            if not m:
                continue
            info = " ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 1:i + 4]
                            if "Compiling" not in x and "Function properties" not in x)
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            r = int(regs.group(1)) if regs else 0
            by_regs = SM_REGS // (-(-r // 8) * 8 * THREADS) if r else 0
            print(f"  [{lib}] {m.group(1)}: {info} -> {by_regs} blocks an SM by registers"
                  f"{'' if not spill else ', spills ' + spill.group(1) + ' bytes'}")


def main() -> int:
    check = "--check" in sys.argv[1:]
    t = time.time()
    logs = _build.build(["swin_block", "swin_block_train", "swin_block_image"],
                        ptxas_verbose=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{_build.CSRC.parent.parent}] build {time.time() - t:.1f} s; card {card}", flush=True)
    ptxas_report(logs)
    g = torch.Generator(device="cuda").manual_seed(0)
    k2_total = k8_total = 0.0
    for nwin, C, h, (Hp, Wp), n_plain, n_mask in SITES:
        x = cs.rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        p = cs.block_params(g, C, h)
        kp = _kernel_params(p, C, h)
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, 4), device="cuda")
        per_img = mask.shape[0]
        keep = 0.8
        draws = torch.rand(2, nwin // per_img, generator=g, device="cuda") < keep
        draws[:, 0], draws[:, 1] = False, True
        s1, s2 = (draws.float() / keep).repeat_interleave(per_img, dim=1)
        for m, a, b, count in ((None, None, None, n_plain), (mask, s1, s2, n_mask)):
            if check:
                err, ok = cs.close(swin_block_fused(x, m, p, h),
                                   swin_block_reference(x, m, p, h), 5e-2, 2e-2)
                out, _, _ = swin_block_train_fwd(x, m, a, b, kp, h)
                e8 = cs.rel_err(out, swin_block_train_reference(x, m, a, b, p, h))
                print(f"  check C={C} mask={m is not None}: K2 max_abs_err {err:.3e}, "
                      f"K8 forward {e8:.3e} of max |plain|", flush=True)
                if not (ok and e8 <= cs.K8_TOL):
                    return 1
            k2 = cs.cuda_ms(lambda: swin_block_fused(x, m, p, h), iters=ITERS)
            k8 = cs.cuda_ms(lambda: swin_block_train_fwd(x, m, a, b, kp, h), iters=ITERS)
            k2_total += count * k2
            k8_total += count * k8
            print(f"  C={C} windows={nwin} mask={m is not None}: K2 {k2:.4f} ms x{count}, "
                  f"K8 forward {k8:.4f} ms x{count}", flush=True)
    print(f"  K2 13 launches {k2_total:.4f} ms; K8 forward 13 launches {k8_total:.4f} ms")
    # the C = 256 tail: 160 windows on 132 SMs against one and two full waves
    x = cs.rnd(g, 264, 64, 256, dtype=torch.bfloat16)
    p = cs.block_params(g, 256, 16)
    tail = {n: cs.cuda_ms(lambda: swin_block_fused(x[:n], None, p, 16), iters=ITERS)
            for n in (132, 160, 264)}
    print("  K2 C=256 unmasked by window count: "
          + ", ".join(f"{n} windows {ms:.4f} ms" for n, ms in tail.items()))
    k12_total = 0.0
    for count, (Hh, Ww), C, h, shift in cs.backbone_blocks(default_config().model):
        x = cs.rnd(g, 2 * cs.B, Hh * Ww, C, dtype=torch.bfloat16)
        p = cs.block_params(g, C, h)
        xp, _ = pad_image(x, Hh, Ww, 8, shift)
        if check:
            err, ok = cs.close(swin_block_fused_image(xp, p, h, 8, shift),
                               swin_block_image_reference(xp, p, h, 8, shift), 5e-2, 2e-2)
            if not ok:
                print(f"  check K12 {Hh}x{Ww} C={C} shift={shift}: max_abs_err {err:.3e}")
                return 1
        ms = cs.cuda_ms(lambda: swin_block_fused_image(xp, p, h, 8, shift), iters=ITERS)
        k12_total += count * ms
        print(f"  K12 {2 * cs.B}x{Hh}x{Ww} C={C} shift={shift}: {ms:.4f} ms x{count}")
    print(f"  K12 13 blocks {k12_total:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
