"""LoFTR-style local feature transformer (linear attention).

Port of `featurematching_tpu/models/transformer.py` (EncoderLayer,
LocalFeatureTransformer): Q/K/V projections without bias, linear attention
(the head-packed form when both sequences are at most 256 tokens long, as
flax picks it), merge, post-LN, concat-MLP FFN, post-LN, residual. It runs
where the fused kernels do not: configurations that fail their gates, and
the training Matcher while K9 and K10 are not ported. Parameters are held in
float32 and cast to the activation dtype at use, as flax does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from featurematching_tpu_torch.ops.attention import (
    PACKED_MAX_LEN,
    linear_attention,
    linear_attention_packed,
)
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain_plain


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype))


def attention_form(L: int, S: int):
    """flax's rule: the packed form when both lengths are at most
    PACKED_MAX_LEN, else the per-head form."""
    short = L <= PACKED_MAX_LEN and S <= PACKED_MAX_LEN
    return linear_attention_packed if short else linear_attention


class EncoderLayer(nn.Module):
    """One self- or cross-attention encoder layer."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        C = d_model
        self.nhead = nhead
        self.q_proj = nn.Linear(C, C, bias=False)
        self.k_proj = nn.Linear(C, C, bias=False)
        self.v_proj = nn.Linear(C, C, bias=False)
        self.merge = nn.Linear(C, C, bias=False)
        self.norm1 = nn.LayerNorm(C, eps=1e-6)
        self.mlp1 = nn.Linear(2 * C, 2 * C, bias=False)
        self.mlp2 = nn.Linear(2 * C, C, bias=False)
        self.norm2 = nn.LayerNorm(C, eps=1e-6)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """x: [B, L, C] queries; source: [B, S, C] keys/values."""
        bs, _, C = x.shape
        h = self.nhead
        q = _linear(x, self.q_proj).reshape(bs, -1, h, C // h)
        k = _linear(source, self.k_proj).reshape(bs, -1, h, C // h)
        v = _linear(source, self.v_proj).reshape(bs, -1, h, C // h)
        msg = attention_form(x.shape[1], source.shape[1])(q, k, v).reshape(bs, -1, C)
        msg = layer_norm_chain_plain(_linear(msg, self.merge), self.norm1.weight, self.norm1.bias)
        y = torch.relu(_linear(torch.cat([x, msg], dim=-1), self.mlp1))
        y = layer_norm_chain_plain(_linear(y, self.mlp2), self.norm2.weight, self.norm2.bias)
        return x + y


class LocalFeatureTransformer(nn.Module):
    """Alternating self/cross stack; layer i is `layer_{i}`."""

    def __init__(self, d_model: int, nhead: int, layer_names: Sequence[str],
                 attention: str = "linear"):
        super().__init__()
        if attention != "linear":
            raise ValueError(f"only linear attention is ported, got {attention!r}")
        for name in layer_names:
            if name not in ("self", "cross"):
                raise ValueError(f"unknown layer name {name!r}")
        self.layer_names = tuple(layer_names)
        for i in range(len(layer_names)):
            self.add_module(f"layer_{i}", EncoderLayer(d_model, nhead))

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor):
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer_{i}")
            if name == "self":
                if feat0.shape == feat1.shape:
                    # both self layers share weights: one call on the stack
                    both = torch.cat([feat0, feat1], dim=0)
                    feat0, feat1 = layer(both, both).chunk(2, dim=0)
                else:
                    feat0, feat1 = layer(feat0, feat0), layer(feat1, feat1)
            else:
                # feat1 attends to the UPDATED feat0, as the reference does
                feat0 = layer(feat0, feat1)
                feat1 = layer(feat1, feat0)
        return feat0, feat1
