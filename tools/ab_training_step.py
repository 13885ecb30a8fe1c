"""The training step of one checkout of the port, for comparing two commits
on one card.

    python3 tools/ab_training_step.py ROOT

imports `chip_smoke.py` and the port from the checkout at ROOT (another
commit unpacked with `git archive` into a directory `.gitignore` lists, or
`.`), builds that checkout's kernels and runs its `chip_smoke.training_step`:
the 640x480 batch-4 bf16 step with its launch counts, step time and device
time of the forward, backward and optimizer. Run it once for each tree in
turns (old, new, new, old) in one call on one card.
"""

import importlib
import subprocess
import sys
import time

ROOT = sys.argv[1]
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
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

t = time.time()
_build.build()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip()
print(f"[{ROOT}] build {time.time() - t:.1f} s; card {card}", flush=True)
wrappers = {n: getattr(importlib.import_module(f"featurematching_tpu_torch.ops.{MODULES[n]}"), n)
            for n in cs.EXPECTED_PER_STEP}
cs.training_step(wrappers, {})
