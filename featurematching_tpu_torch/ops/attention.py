"""Linear attention over [B, N, H, D] tensors.

Port of `featurematching_tpu/ops/attention.py` (elu_feature_map,
linear_attention). `linear_attention_packed` of the JAX package computes the
same function for short sequences, so this one form serves both the coarse
and the fine transformer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1, a positive feature map."""
    return F.elu(x) + 1.0


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """O(N) linear attention. q: [B, L, H, D], k/v: [B, S, H, D] -> [B, L, H, D].

    Values are divided by S before the KV product and multiplied back at the
    end (a low-precision overflow guard); K_sum and the normaliser Z are f32,
    and every product accumulates in f32.
    """
    dt = q.dtype
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    v_length = v.shape[1]
    v = v / v_length
    KV = torch.einsum("bshd,bshv->bhdv", K.float(), v.float()).to(dt)
    K_sum = K.float().sum(dim=1)  # [B, H, D]
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Q.float(), K_sum) + eps)
    out = torch.einsum("blhd,bhdv->blhv", Q.float(), KV.float())
    return (out * Z[..., None] * v_length).to(dt)
