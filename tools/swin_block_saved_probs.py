"""K8's saved attention probabilities against the plain twin's softmax on
random inputs, on one card:

    python3 tools/swin_block_saved_probs.py

At C = 64, 128 and 256 (133 windows, the shift mask of a 16x24 map, seeded
random weights as chip_smoke.py makes them) it counts the probabilities
more than one bf16 ulp from the twin's f32 softmax, and for a few of them
prints how near the twin's q and k entries of that query and key lie to a
bf16 rounding tie (in ulps): where the twin's f32 q or k sits at a tie, the
twin and the kernel round it to different bf16 neighbours, and the two
softmaxes differ by more than the probabilities' own rounding.
"""

import torch

import chip_smoke as cs
from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain_plain
from featurematching_tpu_torch.ops.swin_block_train import _kernel_params, swin_block_train_fwd


def bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-126))) - 7)


def tie_distance(v32):
    """Least distance, in ulps, of any of v32's entries from a bf16 rounding tie."""
    lo = v32.to(torch.bfloat16).float()
    return float((0.5 - (v32 - lo).abs() / bf16_ulp(lo)).abs().min())


def main() -> None:
    for C in (64, 128, 256):
        g = torch.Generator(device="cuda").manual_seed(0)
        h, nwin = C // 16, 133
        x = cs.rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        p = cs.block_params(g, C, h)
        mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
        ones = torch.ones(nwin, device="cuda")
        _, probs, _ = swin_block_train_fwd(x, mask, ones, ones, _kernel_params(p, C, h), h)
        hx = layer_norm_chain_plain(x, p["ln1_scale"], p["ln1_bias"])
        qkv32 = hx.float() @ p["w_qkv"] + p["b_qkv"]
        qkv = qkv32.to(x.dtype).float()
        q, k = (qkv[..., i * C:(i + 1) * C].reshape(nwin, 64, h, 16).transpose(1, 2)
                for i in range(2))
        s = (q @ k.transpose(-1, -2)) * 0.25 + p["rel_bias"][None]
        s = s + mask[torch.arange(nwin, device="cuda") % mask.shape[0]][:, None]
        ref = torch.softmax(s, dim=-1)
        ratio = (probs.float() - ref).abs() / bf16_ulp(ref)
        bad = ratio > 1
        print(f"C={C}: {int(bad.sum())} of {ref.numel()} beyond one ulp, largest "
              f"{float(ratio.max()):.3f} ulp, beyond two {int((ratio > 2).sum())}", flush=True)
        for w, hd, r, kk in bad.nonzero()[:4].tolist():
            qv = qkv32[w, r, hd * 16:(hd + 1) * 16]
            kv = qkv32[w, kk, C + hd * 16:C + (hd + 1) * 16]
            print(f"  window {w} head {hd} query {r} key {kk}: {float(ratio[w, hd, r, kk]):.3f} "
                  f"ulp; the twin's q and k nearest a tie: {tie_distance(qv):.4f}, "
                  f"{tie_distance(kv):.4f} ulp")


if __name__ == "__main__":
    main()
