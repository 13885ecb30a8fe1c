"""LayerNorm chain: LN(x) or LN2(LN1(x)) in one pass over the map.

Port of `featurematching_tpu/ops/pallas_ln.py · layer_norm_chain`. On a CUDA
tensor it launches the hand-written kernel `csrc/layer_norm.cu` (one warp a
row, f32 statistics in registers; bound by device-memory bytes); on a CPU
tensor it runs the plain version below. eps is 1e-6, the model's value.
"""

from __future__ import annotations

from typing import Optional

import torch

from featurematching_tpu_torch.ops import _build

EPS = 1e-6
_ARGTYPES = [_build.PTR] * 6 + [_build.INT] * 3 + [_build.PTR]


def layer_norm_f32(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + EPS) * scale.float() + bias.float()


def layer_norm_chain_plain(
    x: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    scale2: Optional[torch.Tensor] = None,
    bias2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel (also the port's plain LN): f32 statistics,
    both LNs in f32, one rounding to x's dtype at the end."""
    y = layer_norm_f32(x.float(), scale1, bias1)
    if scale2 is not None:
        y = layer_norm_f32(y, scale2, bias2)
    return y.to(x.dtype)


def layer_norm_chain(
    x: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    scale2: Optional[torch.Tensor] = None,
    bias2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LN(x) or LN2(LN1(x)) over the last axis. x: [..., C], any leading dims."""
    if x.device.type == "cpu":
        return layer_norm_chain_plain(x, scale1, bias1, scale2, bias2)
    C = x.shape[-1]
    if C not in (64, 128, 256):
        raise ValueError(f"layer_norm_chain kernel takes C in (64, 128, 256), got {C}")
    _build.check_cuda(x, "x", torch.bfloat16)
    two = scale2 is not None
    s1, b1 = _build.f32(scale1), _build.f32(bias1)
    s2, b2 = (_build.f32(scale2), _build.f32(bias2)) if two else (s1, b1)
    y = torch.empty_like(x)
    rows = x.numel() // C
    _build.launch(
        "layer_norm", "fm_layer_norm_chain", _ARGTYPES,
        x.data_ptr(), s1.data_ptr(), b1.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), rows, C, int(two), _build.stream(),
    )
    layer_norm_chain.launches += 1
    return y


layer_norm_chain.launches = 0
