"""A whole Swin block in window space: LN1 -> window MSA (relative-position
bias, optional shift mask) -> proj + residual -> LN2 -> exact-GELU MLP ->
residual.

Port of `featurematching_tpu/ops/pallas_swin_block.py · swin_block_fused`.
On a CUDA tensor it launches `csrc/swin_block.cu` (one thread block per 8x8
window, everything on chip, bf16 tensor cores; bound by tensor-core
operations) at a head dim in HEAD_DIMS; on a CPU tensor it runs
`swin_block_reference`.

`params` has the JAX package's keys and layouts: ln1_scale, ln1_bias, w_qkv
[C, 3C], b_qkv, rel_bias [h, N, N], w_proj [C, C], b_proj, ln2_scale,
ln2_bias, w_mlp1 [C, HID], b_mlp1, w_mlp2 [HID, C], b_mlp2.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain_plain

WINDOW_TOKENS = 64
HEAD_DIMS = (16, 32, 64)  # head dims the block body takes (csrc/swin_block.cuh)
_ARGTYPES = (
    [_build.PTR, _build.PTR, _build.INT] + [_build.PTR] * 14 + [_build.INT] * 3 + [_build.PTR]
)


def _dense(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product and f32 bias, as the kernel accumulates; result in f32."""
    return v.float() @ w.float() + b.float()


def swin_block_reference(
    x: torch.Tensor,
    mask: Optional[torch.Tensor],
    params: Dict[str, torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """Plain version over window-space inputs x [B_, N, C]; mask [nW, N, N]
    additive or None (window w uses mask[w % nW]). Rounds to x's dtype where
    the kernel does: after each biased product, the probabilities, the head
    outputs and each residual add."""
    B_, N, C = x.shape
    h = num_heads
    d = C // h
    dt = x.dtype
    hx = layer_norm_chain_plain(x, params["ln1_scale"], params["ln1_bias"])
    qkv = _dense(hx, params["w_qkv"], params["b_qkv"]).to(dt)
    q, k, v = (
        qkv[..., i * C : (i + 1) * C].reshape(B_, N, h, d).transpose(1, 2)
        for i in range(3)
    )
    s = (q.float() @ k.float().transpose(-1, -2)) * d**-0.5
    s = s + params["rel_bias"].float()[None]
    if mask is not None:
        wid = torch.arange(B_, device=x.device) % mask.shape[0]
        s = s + mask.float()[wid][:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.float() @ v.float()).to(dt).transpose(1, 2).reshape(B_, N, C)
    x = x + _dense(o, params["w_proj"], params["b_proj"]).to(dt)
    h2 = layer_norm_chain_plain(x, params["ln2_scale"], params["ln2_bias"])
    y = F.gelu(_dense(h2, params["w_mlp1"], params["b_mlp1"])).to(dt)
    return x + _dense(y, params["w_mlp2"], params["b_mlp2"]).to(dt)


def swin_block_fused(
    x: torch.Tensor,
    mask: Optional[torch.Tensor],
    params: Dict[str, torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """Fused block over window-space activations x [B_, 64, C]."""
    if x.device.type == "cpu":
        return swin_block_reference(x, mask, params, num_heads)
    B_, N, C = x.shape
    if (N != WINDOW_TOKENS or C not in (64, 128, 256) or C % num_heads
            or C // num_heads not in HEAD_DIMS):
        raise ValueError(
            f"swin_block_fused kernel takes 8x8 windows, C in (64, 128, 256) and a head "
            f"dim in {HEAD_DIMS}; got N={N}, C={C}, heads={num_heads}"
        )
    _build.check_cuda(x, "x", torch.bfloat16)
    hid = params["w_mlp1"].shape[1]
    if hid != 4 * C:
        raise ValueError(f"swin_block_fused kernel takes an MLP width of 4*C, got {hid}")
    f32, bf = _build.f32, _build.bf16
    if mask is not None:
        mask = f32(mask)
        _build.check_cuda(mask, "mask", torch.float32, (mask.shape[0], N, N))
    p = [
        f32(params["ln1_scale"]), f32(params["ln1_bias"]),
        bf(params["w_qkv"]), f32(params["b_qkv"]), f32(params["rel_bias"]),
        bf(params["w_proj"]), f32(params["b_proj"]),
        f32(params["ln2_scale"]), f32(params["ln2_bias"]),
        bf(params["w_mlp1"]), f32(params["b_mlp1"]),
        bf(params["w_mlp2"]), f32(params["b_mlp2"]),
    ]
    for t, shape in zip(p, [(C,), (C,), (C, 3 * C), (3 * C,), (num_heads, N, N),
                            (C, C), (C,), (C,), (C,), (C, hid), (hid,), (hid, C), (C,)]):
        _build.check_cuda(t, "param", shape=shape)
    out = torch.empty_like(x)
    _build.launch(
        "swin_block", "fm_swin_block", _ARGTYPES,
        x.data_ptr(), mask.data_ptr() if mask is not None else None,
        mask.shape[0] if mask is not None else 0,
        *[t.data_ptr() for t in p], out.data_ptr(), B_, C, C // num_heads, _build.stream(),
    )
    swin_block_fused.launches += 1
    return out


swin_block_fused.launches = 0
