"""The window attention kernel (K11) at two sites of the 640x480 batch-4
backbone, with no mask, an all-zero mask, the shift mask and the shift mask
divided by 10, timed by CUDA events and by the profiler: a mask's values,
not its reads, decide the time when they slow the softmax.

    PYTHONPATH=ROOT python3 tools/window_attention_mask_probe.py

ROOT is a checkout of the port (`.` or a tree unpacked under `build/`); run
one tree after another in one call on one card to compare them.
"""

import torch

import chip_smoke as cs
from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
from featurematching_tpu_torch.ops.window_attention import window_attention

g = torch.Generator(device="cuda").manual_seed(0)
for nwin, C, h, (Hp, Wp) in [(2400, 64, 4, (120, 160)), (160, 256, 16, (32, 40))]:
    qkv = cs.rnd(g, nwin, 64, 3 * C, dtype=torch.bfloat16)
    bias = cs.rnd(g, h, 64, 64, scale=0.02)
    shift = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, 4), device="cuda")
    for name, m in (("none", None), ("zeros", torch.zeros_like(shift)), ("shift", shift),
                    ("shift/10", shift / 10)):
        ms = cs.cuda_ms(lambda: window_attention(qkv, bias, m, h, 0.25), iters=50)
        dev, _ = cs.profile_ms(lambda: [window_attention(qkv, bias, m, h, 0.25)
                                        for _ in range(10)])
        print(f"C={C} mask {name}: events {ms:.4f} ms, profiler {dev / 10:.4f} ms a launch")
