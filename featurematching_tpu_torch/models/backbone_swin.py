"""Swin-UNet backbone: window helpers, parameter modules and the forward of
training and evaluation.

Port of `featurematching_tpu/models/backbone_swin.py`: the window helpers
(window_partition, window_reverse, _shift_attn_mask,
_rel_pos_bias_from_table), the parameter layout (a block's weights under the
JAX tree's names: norm1, attn.qkv, attn.proj, attn.rel_pos_bias, norm2, mlp1,
mlp2), and `SwinUNet`, the linen SwinUNet with both of its block forms: the
`fused_block` form, every block through `ops/swin_block_train.swin_block_train`
(kernel K8 on the card), and the per-op form (the linen `SwinBlock` with
`use_fused_block=False`: LN1, then the window padding, the roll and the
linen `WindowAttention`, whose `fused_attention` branch runs
`ops/window_attention.window_attention`, kernel K11 on the card). Both take
drop-path; the patch embed, PatchMerging, the linen PatchExpand (Dense,
depth-to-space, LN), the stage LNs and the two heads are plain PyTorch ops
under autograd, as they are plain XLA ops in the JAX package.
`SwinUNetParams` holds the weights and the window plumbing; `SwinUNet` and
the serving `models/fast_inference.SwinBackbone` each extend it with their
forward.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain_plain
from featurematching_tpu_torch.ops.swin_block_train import swin_block_train
from featurematching_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_supported,
)


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


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """Product rounded to x's dtype, then the bias added in that dtype (flax
    Dense with dtype = x's dtype)."""
    y = F.linear(x, lin.weight.to(x.dtype))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def window_attention_per_op(x: torch.Tensor, mask: Optional[torch.Tensor],
                            attn: WindowAttentionParams, num_heads: int, window: int,
                            fused: bool) -> torch.Tensor:
    """The linen WindowAttention on windows x [B_, N, C] (mask [nW, N, N] or
    None): the qkv Dense, then K11 where `fused`, else the per-op math (q
    scaled in the dtype, f32 scores, bias, mask, softmax cast to the dtype,
    f32 P.V cast), then the proj Dense."""
    B_, N, C = x.shape
    h = num_heads
    d = C // h
    dt = x.dtype
    scale = d**-0.5
    qkv = dense(x, attn.qkv)
    bias = _rel_pos_bias_from_table(attn.rel_pos_bias, window, h)
    if fused:
        return dense(window_attention(qkv.contiguous(), bias, mask, h, scale), attn.proj)
    q, k, v = qkv.reshape(B_, N, 3, h, d).permute(2, 0, 3, 1, 4)
    s = (q * scale).float() @ k.float().transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, h, N, N) + mask.float()[None, :, None]).reshape(B_, h, N, N)
    p = torch.softmax(s, dim=-1).to(dt)
    out = (p.float() @ v.float()).to(dt).transpose(1, 2).reshape(B_, N, C)
    return dense(out, attn.proj)


def drop_path_draws(batch: int, rate: float, train: bool,
                    generator: Optional[torch.Generator], device) -> Optional[torch.Tensor]:
    """A block's drop-path keep draws, [2, batch] bool (attention branch, MLP
    branch), one per image; None when nothing is dropped. Both block forms
    take them in this order from the generator, so one generator state gives
    both forms the same masks."""
    if not train or rate <= 0:
        return None
    return torch.rand(2, batch, generator=generator, device=device) < 1.0 - rate


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax LayerNorm: f32 statistics, output in x's dtype."""
    return layer_norm_chain_plain(x, ln.weight, ln.bias)


def patch_merge(x: torch.Tensor, H: int, W: int, p: PatchMergingParams) -> torch.Tensor:
    """2x2 space-to-depth (odd sizes padded), LN, 4C -> 2C. x: [B, H*W, C]."""
    B, L, C = x.shape
    xi = x.reshape(B, H, W, C)
    if H % 2 or W % 2:
        xi = F.pad(xi, (0, 0, 0, W % 2, 0, H % 2))
    cat = torch.cat(
        [xi[:, 0::2, 0::2], xi[:, 1::2, 0::2], xi[:, 0::2, 1::2], xi[:, 1::2, 1::2]], dim=-1
    ).reshape(B, -1, 4 * C)
    return dense(layer_norm(cat, p.norm), p.reduction)


def patch_expand(x: torch.Tensor, H: int, W: int, p: PatchExpandParams) -> torch.Tensor:
    """The linen PatchExpand: Dense C -> scale*C, 2x2 depth-to-space, LN.
    x: [B, H*W, C] -> [B, 4*H*W, scale*C/4]."""
    B = x.shape[0]
    y = dense(x, p.expand)
    Ce = y.shape[-1]
    y = y.reshape(B, H, W, Ce)
    y0 = y[..., : Ce // 2].reshape(B, H, 2 * W, Ce // 4)
    y1 = y[..., Ce // 2:].reshape(B, H, 2 * W, Ce // 4)
    y = torch.stack([y0, y1], dim=2).reshape(B, 4 * H * W, Ce // 4)
    return layer_norm(y, p.norm)


def drop_path_rates(depths, depths_up, rate: float):
    """(encoder rates per stage, decoder rates per stage): a linspace over the
    encoder's blocks; the decoder takes the JAX package's slice of it (stage
    j reads dpr[sum(depths_up[:n-1-j]) : sum(depths_up[:n-j])], 0 past its end)."""
    dpr = list(np.linspace(0, rate, sum(depths)))
    enc = [[float(dpr[sum(depths[:i]) + b]) for b in range(d)] for i, d in enumerate(depths)]
    n_up = len(depths_up)
    dec = []
    for j in range(n_up):
        sl = dpr[sum(depths_up[: n_up - 1 - j]): sum(depths_up[: n_up - j])]
        dec.append([float(sl[b]) if b < len(sl) else 0.0
                    for b in range(depths_up[n_up - 1 - j])])
    return enc, dec


class SwinUNetParams(nn.Module):
    """Swin-UNet (swin_v1) weights under the JAX tree's names, the patch
    embed and the window plumbing the forwards share; no forward of its own."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        s = cfg.swin
        self.cfg = s
        self.patch_embed = nn.Conv2d(
            cfg.input_channels, s.embed_dim, s.patch_size, stride=s.patch_size
        )
        self.patch_norm = nn.LayerNorm(s.embed_dim, eps=1e-6)
        n = len(s.depths)
        for i in range(n):
            dim = s.embed_dim * 2**i
            for b in range(s.depths[i]):
                self.add_module(f"enc{i}_blk{b}", SwinBlockParams(
                    dim, s.num_heads[i], s.window_size, s.mlp_ratio))
            if i < n - 1:
                self.add_module(f"enc{i}_merge", PatchMergingParams(dim))
            self.add_module(f"norm_down{i}", nn.LayerNorm(dim * (2 if i < n - 1 else 1), eps=1e-6))
        n_up = len(s.depths_up)
        for j in range(n_up):
            dim = s.embed_dim * 2 ** (n_up - 1 - j)
            for b in range(s.depths_up[n_up - 1 - j]):
                self.add_module(f"dec{j}_blk{b}", SwinBlockParams(
                    dim, s.num_heads[n_up - 1 - j], s.window_size, s.mlp_ratio))
            scale = 2 if j < n_up - 1 else 4
            self.add_module(f"dec{j}_expand", PatchExpandParams(dim, scale))
            self.add_module(f"norm_up{j}", nn.LayerNorm(scale * dim // 4, eps=1e-6))
            if j == 0:
                self.linear_middle = nn.Linear(scale * dim // 4, 256, bias=False)
            elif j == n_up - 1:
                self.linear_end = nn.Linear(scale * dim // 4, 64, bias=False)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _shift_mask(self, Hp: int, Wp: int, shift: int, device) -> torch.Tensor:
        key = (Hp, Wp, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                _shift_attn_mask(Hp, Wp, self.cfg.window_size, shift), device=device
            )
        return self._masks[key]

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """4x4 patch-embed convolution in x's dtype; [B, H, W, C_in] -> [B, Wh, Ww, E]."""
        dt = x.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2), self.patch_embed.weight.to(dt),
                     stride=self.cfg.patch_size)
        return y.permute(0, 2, 3, 1) + self.patch_embed.bias.to(dt)

    def _in_windows(self, x: torch.Tensor, H: int, W: int, shift: int, fn) -> torch.Tensor:
        """x [B, H*W, C] -> the map padded with zeros to a multiple of the
        window, rolled by -shift, as windows [B*nW, w*w, C]; fn(windows, shift
        mask or None, nW) runs the block (or the per-op block's attention) on
        them; the result is rolled back and cropped."""
        B, L, C = x.shape
        w = self.cfg.window_size
        xi = x.reshape(B, H, W, C)
        pad_b, pad_r = (w - H % w) % w, (w - W % w) % w
        if pad_b or pad_r:
            xi = F.pad(xi, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            xi = torch.roll(xi, shifts=(-shift, -shift), dims=(1, 2))
            mask = self._shift_mask(Hp, Wp, shift, x.device)
        ow = fn(window_partition(xi, w).contiguous(), mask, (Hp // w) * (Wp // w))
        oi = window_reverse(ow, w, Hp, Wp)
        if shift > 0:
            oi = torch.roll(oi, shifts=(shift, shift), dims=(1, 2))
        return oi[:, :H, :W].reshape(B, H * W, C)


class SwinUNet(SwinUNetParams):
    """The differentiable forward of training and evaluation over the
    Swin-UNet weights.

    forward(x, train, generator, fused_block, fused_attention): x [B, H, W,
    C_in] NHWC in the compute dtype -> (coarse [B, H/8, W/8, 256], fine [B,
    H/2, W/2, 64]). `fused_block` runs every block in the fused form (K8),
    else in the per-op form, whose attention takes K11 where
    `fused_attention` (and the kernel's limits) hold in evaluation, as the
    linen SwinUNet dispatches. With `train` and a drop_path_rate > 0 each
    block draws its two drop-path masks per image from `generator` (a
    torch.Generator on x's device)."""

    def _block(self, x: torch.Tensor, H: int, W: int, blk: SwinBlockParams, shift: int,
               rate: float, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        """One block in the fused form: the window padding enters before LN1
        (inside the block); drop-path scales are drawn per image, repeated
        over its windows and divided by keep, for both branches or neither."""
        B = x.shape[0]

        def run(xw, mask, nW):
            s1 = s2 = None
            draws = drop_path_draws(B, rate, train, generator, x.device)
            if draws is not None:
                s1, s2 = (draws.float() / (1.0 - rate)).repeat_interleave(nW, dim=1)
            return swin_block_train(xw, mask, s1, s2, blk.kernel_params(), blk.num_heads)

        return self._in_windows(x, H, W, shift, run)

    def _block_per_op(self, x: torch.Tensor, H: int, W: int, blk: SwinBlockParams, shift: int,
                      rate: float, train: bool, generator: Optional[torch.Generator],
                      fused_attention: bool) -> torch.Tensor:
        """One block in the per-op form (the linen SwinBlock with
        use_fused_block=False): LN1, then the window plumbing on the LN's
        output (so the padding is zeros after the LN) around the window
        attention (K11 where `fused_attention` and the kernel's limits hold,
        in evaluation only); the shortcut with drop-path, then LN2, mlp1,
        exact GELU, mlp2 and drop-path again, each Dense rounded to the dtype."""
        B, L, C = x.shape
        w = self.cfg.window_size
        draws = drop_path_draws(B, rate, train, generator, x.device)
        keep = 1.0 - rate

        def drop(y, i):
            return y if draws is None else y / keep * draws[i].to(y.dtype)[:, None, None]

        fused = (fused_attention and not train
                 and window_attention_supported(w * w, C, blk.num_heads))
        a = self._in_windows(layer_norm(x, blk.norm1), H, W, shift, lambda xw, mask, nW:
                             window_attention_per_op(xw, mask, blk.attn, blk.num_heads, w, fused))
        x = x + drop(a, 0)
        y = dense(F.gelu(dense(layer_norm(x, blk.norm2), blk.mlp1)), blk.mlp2)
        return x + drop(y, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, fused_block: bool = True,
                fused_attention: bool = False):
        s = self.cfg

        def block(y, H, W, blk, b, rate):
            shift = 0 if b % 2 == 0 else s.window_size // 2
            if fused_block:
                return self._block(y, H, W, blk, shift, rate, train, generator)
            return self._block_per_op(y, H, W, blk, shift, rate, train, generator,
                                      fused_attention)

        B = x.shape[0]
        y = self._embed(x)
        Wh, Ww = y.shape[1], y.shape[2]
        y = layer_norm(y.reshape(B, Wh * Ww, s.embed_dim), self.patch_norm)
        enc_rates, dec_rates = drop_path_rates(s.depths, s.depths_up, s.drop_path_rate)
        n = len(s.depths)
        for i in range(n):
            for b in range(s.depths[i]):
                y = block(y, Wh, Ww, getattr(self, f"enc{i}_blk{b}"), b, enc_rates[i][b])
            if i < n - 1:
                y = patch_merge(y, Wh, Ww, getattr(self, f"enc{i}_merge"))
                Wh, Ww = (Wh + 1) // 2, (Ww + 1) // 2
            y = layer_norm(y, getattr(self, f"norm_down{i}"))
        out_c = out_f = None
        n_up = len(s.depths_up)
        for j in range(n_up):
            for b in range(s.depths_up[n_up - 1 - j]):
                y = block(y, Wh, Ww, getattr(self, f"dec{j}_blk{b}"), b, dec_rates[j][b])
            y = patch_expand(y, Wh, Ww, getattr(self, f"dec{j}_expand"))
            Wh, Ww = Wh * 2, Ww * 2
            y = layer_norm(y, getattr(self, f"norm_up{j}"))
            if j == 0:
                out_c = dense(y, self.linear_middle).reshape(B, Wh, Ww, -1)
            elif j == n_up - 1:
                out_f = dense(y, self.linear_end).reshape(B, Wh, Ww, -1)
        return out_c, out_f
