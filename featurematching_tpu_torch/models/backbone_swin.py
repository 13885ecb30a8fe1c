"""Swin-UNet window helpers and parameter modules.

Port of the window helpers of `featurematching_tpu/models/backbone_swin.py`
(window_partition, window_reverse, _shift_attn_mask,
_rel_pos_bias_from_table) and of its parameter layout: the modules here hold
a block's weights under the JAX tree's names (norm1, attn.qkv, attn.proj,
attn.rel_pos_bias, norm2, mlp1, mlp2); `models/fast_inference` runs them.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
from torch import nn


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C] (H, W divisible by w), batch-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    """[B*nW, w*w, C] -> [B, H, W, C]."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // w) * (W // w))
    x = windows.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(Hp: int, Wp: int, w: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask [nW, w*w, w*w] (0 / -100) on the padded map."""
    img = np.zeros((Hp, Wp), dtype=np.int32)
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rel_pos_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"), 0).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1)


def _rel_pos_bias_from_table(table: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """[(2w-1)^2, h] learned table -> [h, N, N] additive bias (N = w*w)."""
    N = w * w
    idx = torch.as_tensor(_rel_pos_index(w), device=table.device)
    return table[idx].reshape(N, N, h).permute(2, 0, 1)


class WindowAttentionParams(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))


class SwinBlockParams(nn.Module):
    """One Swin block's weights, named as in the JAX tree."""

    def __init__(self, dim: int, num_heads: int, window: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        hid = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttentionParams(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp1 = nn.Linear(dim, hid)
        self.mlp2 = nn.Linear(hid, dim)

    def kernel_params(self) -> Dict[str, torch.Tensor]:
        """The block's weights in `ops.swin_block` form ([in, out] products)."""
        return {
            "ln1_scale": self.norm1.weight, "ln1_bias": self.norm1.bias,
            "w_qkv": self.attn.qkv.weight.t(), "b_qkv": self.attn.qkv.bias,
            "rel_bias": _rel_pos_bias_from_table(
                self.attn.rel_pos_bias, self.window, self.num_heads
            ),
            "w_proj": self.attn.proj.weight.t(), "b_proj": self.attn.proj.bias,
            "ln2_scale": self.norm2.weight, "ln2_bias": self.norm2.bias,
            "w_mlp1": self.mlp1.weight.t(), "b_mlp1": self.mlp1.bias,
            "w_mlp2": self.mlp2.weight.t(), "b_mlp2": self.mlp2.bias,
        }


class PatchMergingParams(nn.Module):
    """2x2 space-to-depth + LN + 4C -> 2C linear (no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class PatchExpandParams(nn.Module):
    """Linear C -> scale*C (no bias) + depth-to-space x2 + LN."""

    def __init__(self, dim: int, dim_scale: int):
        super().__init__()
        self.expand = nn.Linear(dim, dim_scale * dim, bias=False)
        self.norm = nn.LayerNorm(dim_scale * dim // 4, eps=1e-6)
