"""LoFTR-style local feature transformer (linear attention).

Port of `featurematching_tpu/models/transformer.py` (EncoderLayer,
LocalFeatureTransformer): Q/K/V projections without bias, linear attention
(the head-packed form when both sequences are at most 256 tokens long, as
flax picks it), merge, post-LN, concat-MLP FFN, post-LN, residual.
Parameters are held in float32 and cast to the activation dtype at use, as
flax does.

`use_fused_train` is flax's switch of the same name: when it is set, the
features have one shape and `coarse_train_supported` holds, the stack runs
as the differentiable kernel K9 (`ops/coarse_transformer_train`; its plain
twin on the CPU); where the coarse gate fails and the fine gate
(`fine_train_supported`) holds, it runs as the differentiable fine window
transformer K10 (`ops/fine_transformer_train`; its plain twin on the CPU),
as flax does. With no gradient to take (an evaluation forward) the gates
take the widths of the forward's kernels, K5's and K6's, which K9's and
K10's forwards run; with one, those of the backward's. Otherwise, and
always without the switch, the per-op stack runs (the serving forward's
fallback where its fused kernels do not apply).
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
from featurematching_tpu_torch.ops.coarse_transformer_train import (
    coarse_train_supported,
    coarse_transformer_train,
)
from featurematching_tpu_torch.ops.fine_stage import fine_train_supported
from featurematching_tpu_torch.ops.fine_transformer_train import fine_transformer_train
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
                 attention: str = "linear", use_fused_train: bool = False):
        super().__init__()
        if attention != "linear":
            raise ValueError(f"only linear attention is ported, got {attention!r}")
        for name in layer_names:
            if name not in ("self", "cross"):
                raise ValueError(f"unknown layer name {name!r}")
        self.d_model, self.nhead = d_model, nhead
        self.layer_names = tuple(layer_names)
        self.use_fused_train = use_fused_train
        for i in range(len(layer_names)):
            self.add_module(f"layer_{i}", EncoderLayer(d_model, nhead))

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor):
        if self.use_fused_train and feat0.shape == feat1.shape:
            grad = torch.is_grad_enabled() and (feat0.requires_grad or feat1.requires_grad or any(
                p.requires_grad for p in self.parameters()))
            args = (self.layer_names, self.d_model, self.nhead, feat0.shape[1], not grad)
            if coarse_train_supported(*args):
                return coarse_transformer_train(feat0, feat1, self, self.layer_names, self.nhead)
            if fine_train_supported(*args):
                return fine_transformer_train(feat0, feat1, self, self.layer_names, self.nhead)
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
