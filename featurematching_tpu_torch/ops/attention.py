"""Linear attention over [B, N, H, D] tensors.

Port of `featurematching_tpu/ops/attention.py` (elu_feature_map,
linear_attention, linear_attention_packed, _PACKED_MAX_LEN). The two forms
compute the same function and differ only in where they round in a low
precision: `linear_attention` rounds once, at the end;
`linear_attention_packed` (the form flax's EncoderLayer takes when both
sequences are at most `PACKED_MAX_LEN` tokens long, the fine windows among
them) rounds the attention output to the input dtype and then multiplies it
by the rounded `Z * S`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# sequences at or below this length take the packed form (flax's rule)
PACKED_MAX_LEN = 256


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


def linear_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """The head-packed form for short sequences, with its rounding points:
    the [C, C] cross-head K'ᵀV' kept on its diagonal [D, D] blocks and
    rounded to the input dtype, out = Q'·KV rounded, then multiplied in that
    dtype by the rounded Z·S. Same shapes as `linear_attention`."""
    B, L, H, D = q.shape
    S = k.shape[1]
    C = H * D
    dt = q.dtype
    Q = elu_feature_map(q).reshape(B, L, C)
    K = elu_feature_map(k).reshape(B, S, C)
    V = (v / S).reshape(B, S, C)
    head_of = torch.arange(C, device=q.device) // D
    blockmask = (head_of[:, None] == head_of[None, :]).float()
    kv = (torch.einsum("bsc,bsd->bcd", K.float(), V.float()) * blockmask).to(dt)
    K_sum = K.float().sum(dim=1)  # [B, C]
    Z = 1.0 / ((Q.float() * K_sum[:, None]).reshape(B, L, H, D).sum(-1) + eps)  # [B, L, H]
    out = torch.einsum("blc,bcd->bld", Q.float(), kv.float()).to(dt)
    return out.reshape(B, L, H, D) * (Z * S).to(dt)[..., None]
