"""Window multi-head attention over 8x8 windows: scores, relative-position
bias, optional shift mask, softmax and P.V for every head of every window.

Port of `featurematching_tpu/ops/pallas_window_attention.py ·
window_attention_pallas`, the kernel of the per-op Swin block's
`fused_attention` branch. On a CUDA tensor it launches
`csrc/window_attention.cu` (one thread block a window, bf16 tensor cores,
scores and probabilities in registers; bound by device-memory bytes); on a
CPU tensor it runs `window_attention_reference`.

Layouts are the JAX package's: qkv [B_, N, 3C] as the qkv Dense writes it
([q | k | v] blocks, heads d-contiguous within each), bias [h, N, N], mask
[nW, N, N] additive (window b takes mask[b % nW]) or None; out [B_, N, C].
"""

from __future__ import annotations

from typing import Optional

import torch

from featurematching_tpu_torch.ops import _build

WINDOW_TOKENS = 64
HEAD_DIMS = (16, 32, 64)
MAX_C = 256
_ARGTYPES = [_build.PTR] * 3 + [_build.INT, _build.PTR, _build.INT, _build.INT, _build.INT,
                                _build.FLOAT, _build.PTR]


def window_attention_supported(N: int, C: int, heads: int) -> bool:
    """What the kernel takes: 8x8 windows, a head dim in HEAD_DIMS, C <= 256."""
    return (N == WINDOW_TOKENS and heads > 0 and C % heads == 0
            and C // heads in HEAD_DIMS and C <= MAX_C)


def window_attention_reference(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version, rounding where the TPU kernel does: q.k summed in f32,
    then * scale + bias in f32, then + mask, softmax in f32, p cast to the
    qkv dtype, p.v summed in f32 and the output cast. (The per-op attention
    scales q in its dtype before the product; at head dims 16 and 64 the
    scale is a power of two and the two orders agree.)"""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    d = C // h
    dt = qkv.dtype
    q, k, v = (qkv[..., i * C: (i + 1) * C].reshape(B_, N, h, d).transpose(1, 2)
               for i in range(3))
    s = (q.float() @ k.float().transpose(-1, -2)) * scale + bias.float()[None]
    if mask is not None:
        wid = torch.arange(B_, device=qkv.device) % mask.shape[0]
        s = s + mask.float()[wid][:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.float() @ v.float()).to(dt)
    return o.transpose(1, 2).reshape(B_, N, C)


def window_attention(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Attention of every window. qkv [B_, N, 3C] -> [B_, N, C]."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, num_heads, scale)
    B_, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or not window_attention_supported(N, C, num_heads):
        raise ValueError(
            f"window_attention kernel takes 8x8 windows, head dim in {HEAD_DIMS} and C <= "
            f"{MAX_C}; got N={N}, C={C3 / 3:g}, heads={num_heads}")
    _build.check_cuda(qkv, "qkv", torch.bfloat16)
    bias = _build.f32(bias)
    _build.check_cuda(bias, "bias", torch.float32, (num_heads, N, N))
    if mask is not None:
        mask = _build.f32(mask)
        _build.check_cuda(mask, "mask", torch.float32, (mask.shape[0], N, N))
    out = torch.empty(B_, N, C, dtype=qkv.dtype, device=qkv.device)
    _build.launch(
        "window_attention", "fm_window_attention", _ARGTYPES,
        qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
        mask.shape[0] if mask is not None else 0, out.data_ptr(), B_, C, num_heads,
        float(scale), _build.stream(),
    )
    window_attention.launches += 1
    return out


window_attention.launches = 0
