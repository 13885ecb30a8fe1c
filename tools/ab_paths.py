"""The device time of the port's three paths in one checkout, for comparing
two commits on one card.

    python3 tools/ab_paths.py ROOT

imports `chip_smoke.py` and the port from the checkout at ROOT (another
commit unpacked with `git archive` into a directory `.gitignore` lists, or
`.`), builds that checkout's kernels and prints:
  - the serving forward (`default_config()`, 640x480, batch 4, bf16): its
    device time by the profiler over one forward after a warm-up, its
    launches, and the time of K5's kernels (stats, merge, apply) and of
    K6's (fine_stage_kernel) in it;
  - the training step (`chip_smoke.training_step`: step time, device time
    of the forward, backward and optimizer, launches);
  - the evaluation step with the per-op block (`chip_smoke.eval_forward`:
    step time, device time, launches);
  - the device time of K6's kernel (K10's forward) in the profile of the
    whole training step and of the whole evaluation step.
Run it once for each tree in turns (old, new, new, old) in one call on one
card.
"""

import importlib
import re
import subprocess
import sys
import time

ROOT = sys.argv[1]
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from featurematching_tpu_torch.config import default_config  # noqa: E402
from featurematching_tpu_torch.models.fast_inference import FastMatcher  # noqa: E402
from featurematching_tpu_torch.ops import _build  # noqa: E402

# the module of `featurematching_tpu_torch.ops` that holds each wrapper
MODULES = {
    "swin_block_fused": "swin_block", "layer_norm_chain": "layer_norm",
    "patch_expand_ln": "patch_expand", "dual_softmax_match_stats": "dual_softmax",
    "dual_softmax_lse": "dual_softmax", "coarse_transformer_fused": "coarse_transformer",
    "fine_stage_fused": "fine_stage", "swin_block_train_fwd": "swin_block_train",
    "swin_block_train_bwd": "swin_block_train", "sparse_focal_backward": "sparse_focal_loss",
    "coarse_layer_forward": "coarse_transformer_train",
    "coarse_layer_backward": "coarse_transformer_train",
    "fine_layer_forward": "fine_stage", "fine_layer_backward": "fine_transformer_train",
    "window_attention": "window_attention", "swin_block_fused_image": "swin_block_image",
}
K5_KERNELS = ("stats_kernel", "merge_kernel", "apply_kernel")
K6_KERNEL = "fine_stage_kernel"
_profiles = []  # the rows of each chip_smoke.profile_ms call
_profile_ms = cs.profile_ms


def _recording_profile_ms(fn):
    busy, rows = _profile_ms(fn)
    _profiles.append(rows)
    return busy, rows


cs.profile_ms = _recording_profile_ms


def kernel_ms(rows, name: str) -> float:
    return sum(ms for ms, _, n in rows if re.search(rf"\b{name}\b", n))


def serving_forward() -> None:
    model = FastMatcher(default_config().model, device="cuda", seed=0)
    gi = torch.Generator(device="cuda").manual_seed(1)
    img0 = torch.rand(cs.B, cs.H, cs.W, 3, generator=gi, device="cuda")
    img1 = torch.roll(img0, shifts=16, dims=2)
    with torch.no_grad():
        model(img0, img1)  # warm-up: builds and packs
        busy, rows = cs.profile_ms(lambda: model(img0, img1))
    k5 = {k: kernel_ms(rows, k) for k in K5_KERNELS}
    print(f"  serving forward: {busy:.3f} ms of device time, {sum(r[1] for r in rows)} "
          f"launches; K5 {sum(k5.values()):.4f} ms (" + ", ".join(
              f"{k} {v:.4f}" for k, v in k5.items()) + f"); K6 {kernel_ms(rows, K6_KERNEL):.4f} ms",
          flush=True)


def main() -> None:
    t = time.time()
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{ROOT}] build {time.time() - t:.1f} s; card {card}", flush=True)
    wrappers = {n: getattr(importlib.import_module(f"featurematching_tpu_torch.ops.{MODULES[n]}"),
                           n) for n in cs.EXPECTED_PER_STEP}
    serving_forward()
    cs.training_step(wrappers, {})
    print(f"  K6's kernel (K10's forward) in the training step: "
          f"{kernel_ms(_profiles[-1], K6_KERNEL):.4f} ms", flush=True)
    cs.eval_forward(wrappers, {})
    print(f"  K6's kernel (K10's forward) in the evaluation step: "
          f"{kernel_ms(_profiles[-1], K6_KERNEL):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
