"""The serving forward: image pair -> coarse matches -> refined keypoints.

Port of `featurematching_tpu/models/fast_inference.py` (swin_backbone_fast
and make_fast_matcher_fn). At `default_config()` the forward runs six
kernels, as the JAX package does on its accelerator: the backbone through
swin_block_fused (13 launches), layer_norm_chain (4) and patch_expand_ln (3),
the coarse transformer through coarse_transformer_fused (once, 8 layers),
the coarse matching through dual_softmax_match_stats (once) and the fine
stage through fine_stage_fused in its fold mode (once). Where a
configuration fails the fused gates (`use_fused_coarse`, `use_fused_fine`:
pure functions of the config and the shapes), the plain
LocalFeatureTransformer, window mix and fine_soft_argmax run instead, as the
JAX package's plain branches do.

`FastMatcher(cfg)` runs on `cuda` and raises when no GPU is present;
`device="cpu"` runs every kernel's plain version instead. Inputs and outputs
keep the JAX package's layouts: NHWC images, [B, L, C] tokens.

Usage:
    model = FastMatcher(default_config().model)          # seeded init
    load_jax_params(model, jax_variables["params"])       # or JAX weights
    out = model(image0, image1)                           # MatcherOutput
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.matching.coarse import (
    CoarseMatches,
    extract_matches_from_stats,
    ids_to_keypoints,
)
from featurematching_tpu_torch.matching.fine import (
    FineMatches,
    fine_from_heatmaps,
    fine_soft_argmax,
    gather_fine_windows,
)
from featurematching_tpu_torch.models.backbone_swin import (
    PatchExpandParams,
    PatchMergingParams,
    SwinBlockParams,
    _shift_attn_mask,
    window_partition,
    window_reverse,
)
from featurematching_tpu_torch.models.matcher import MatcherOutput
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops.coarse_transformer import (
    coarse_transformer_fused,
    coarse_transformer_supported,
    pack_layers,
)
from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_match_stats
from featurematching_tpu_torch.ops.fine_stage import (
    fine_stage_fused,
    fine_stage_supported,
    window_mix,
)
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain, layer_norm_chain_plain
from featurematching_tpu_torch.ops.patch_expand import patch_expand_ln
from featurematching_tpu_torch.ops.swin_block import swin_block_fused
from featurematching_tpu_torch.utils.weights import init_weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU"
        )
    return dev


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """Product rounded to x's dtype, then the bias added in that dtype."""
    y = F.linear(x, lin.weight.to(x.dtype))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def _patch_merge(x: torch.Tensor, H: int, W: int, p: PatchMergingParams) -> torch.Tensor:
    B, L, C = x.shape
    xi = x.reshape(B, H, W, C)
    if H % 2 or W % 2:
        xi = F.pad(xi, (0, 0, 0, W % 2, 0, H % 2))
    cat = torch.cat(
        [xi[:, 0::2, 0::2], xi[:, 1::2, 0::2], xi[:, 0::2, 1::2], xi[:, 1::2, 1::2]], dim=-1
    ).reshape(B, -1, 4 * C)
    return _dense(layer_norm_chain_plain(cat, p.norm.weight, p.norm.bias), p.reduction)


class SwinBackbone(nn.Module):
    """Swin-UNet (swin_v1) weights under the JAX tree's names, and the fused
    forward over them. Returns (coarse [B, H/8, W/8, 256], fine [B, H/2, W/2, 64])."""

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

    def _run_block(self, x: torch.Tensor, H: int, W: int, blk: SwinBlockParams,
                   shift: int) -> torch.Tensor:
        """One Swin block via the fused kernel in window space. x: [B, H*W, C].
        The map is padded to a multiple of the window before the roll."""
        B, L, C = x.shape
        w = blk.window
        xi = x.reshape(B, H, W, C)
        pad_b, pad_r = (w - H % w) % w, (w - W % w) % w
        if pad_b or pad_r:
            xi = F.pad(xi, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            xi = torch.roll(xi, shifts=(-shift, -shift), dims=(1, 2))
            mask = self._shift_mask(Hp, Wp, shift, x.device)
        xw = window_partition(xi, w).contiguous()
        ow = swin_block_fused(xw, mask, blk.kernel_params(), blk.num_heads)
        oi = window_reverse(ow, w, Hp, Wp)
        if shift > 0:
            oi = torch.roll(oi, shifts=(shift, shift), dims=(1, 2))
        return oi[:, :H, :W].reshape(B, H * W, C).contiguous()

    def _patch_expand(self, x: torch.Tensor, H: int, W: int, j: int,
                      head: Optional[nn.Linear], emit_ln: bool):
        pe = getattr(self, f"dec{j}_expand")
        nu = getattr(self, f"norm_up{j}")
        y = _dense(x, pe.expand)
        w_head = b_head = None
        if head is not None:  # the heads have no bias
            w_head = head.weight.t()
            b_head = torch.zeros(head.out_features, device=x.device)
        return patch_expand_ln(
            y, H, W, pe.norm.weight, pe.norm.bias, nu.weight, nu.bias,
            w_head=w_head, b_head=b_head, emit_ln=emit_ln,
        )

    def forward(self, x: torch.Tensor):
        """x: [B, H, W, C_in] in the compute dtype (NHWC)."""
        s = self.cfg
        B = x.shape[0]
        dt = x.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2), self.patch_embed.weight.to(dt), stride=s.patch_size)
        y = y.permute(0, 2, 3, 1) + self.patch_embed.bias.to(dt)
        Wh, Ww = y.shape[1], y.shape[2]
        y = y.reshape(B, Wh * Ww, s.embed_dim).contiguous()
        y = layer_norm_chain(y, self.patch_norm.weight, self.patch_norm.bias)

        n = len(s.depths)
        for i in range(n):
            for b in range(s.depths[i]):
                shift = 0 if b % 2 == 0 else s.window_size // 2
                y = self._run_block(y, Wh, Ww, getattr(self, f"enc{i}_blk{b}"), shift)
            if i < n - 1:
                y = _patch_merge(y, Wh, Ww, getattr(self, f"enc{i}_merge"))
                Wh, Ww = (Wh + 1) // 2, (Ww + 1) // 2
            nd = getattr(self, f"norm_down{i}")
            y = layer_norm_chain(y, nd.weight, nd.bias)

        out_c = out_f = None
        n_up = len(s.depths_up)
        for j in range(n_up):
            for b in range(s.depths_up[n_up - 1 - j]):
                shift = 0 if b % 2 == 0 else s.window_size // 2
                y = self._run_block(y, Wh, Ww, getattr(self, f"dec{j}_blk{b}"), shift)
            last = j == n_up - 1
            head = self.linear_middle if j == 0 else (self.linear_end if last else None)
            outs = self._patch_expand(y, Wh, Ww, j, head, emit_ln=not last)
            Wh, Ww = Wh * 2, Ww * 2
            if j == 0:
                y, oc = outs
                out_c = oc.reshape(B, Wh, Ww, -1)
            elif last:
                out_f = outs[0].reshape(B, Wh, Ww, -1)
            else:
                y = outs[0]
        return out_c, out_f


class FastMatcher(nn.Module):
    """The serving forward over the Matcher's weights (eval only).

    Weights come from a seeded init (`seed`) or from `load_jax_params`.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if cfg.backbone_type != "swin_v1":
            raise ValueError("the fast forward implements the swin_v1 backbone")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.backbone = SwinBackbone(cfg)
        c, f = cfg.coarse, cfg.fine
        self.coarse_transformer = LocalFeatureTransformer(
            c.d_model, c.nhead, c.layer_names, c.attention)
        self.fine_down_proj = nn.Linear(c.d_model, f.d_model)
        self.fine_merge = nn.Linear(2 * f.d_model, f.d_model)
        self.fine_transformer = LocalFeatureTransformer(
            f.d_model, f.nhead, f.layer_names, f.attention)
        ww = f.window_size**2
        self.mix_feat_0 = nn.Linear(ww, 1)
        self.mix_feat_1 = nn.Linear(ww, 1)
        init_weights(self, seed)
        self.to(dev)
        self.eval()

    def use_fused_coarse(self, n_tokens: int) -> bool:
        c = self.cfg.coarse
        return c.attention == "linear" and coarse_transformer_supported(
            c.layer_names, c.d_model, c.nhead, n_tokens)

    def use_fused_fine(self) -> bool:
        f = self.cfg.fine
        return f.attention == "linear" and fine_stage_supported(
            f.layer_names, f.d_model, f.nhead)

    def coarse_stage(self, feat_c0: torch.Tensor, feat_c1: torch.Tensor):
        """The coarse transformer on [B, L, C] tokens: the fused kernels when
        the gate holds, else the plain LocalFeatureTransformer."""
        if not self.use_fused_coarse(feat_c0.shape[1]):
            return self.coarse_transformer(feat_c0, feat_c1)
        c = self.cfg.coarse
        return coarse_transformer_fused(
            feat_c0, feat_c1, pack_layers(self.coarse_transformer, feat_c0.dtype),
            c.layer_names, c.nhead)

    def coarse_matching(self, feat_c0: torch.Tensor, feat_c1: torch.Tensor,
                        grid_c: Tuple[int, int]) -> CoarseMatches:
        """Dual-softmax mutual nearest neighbours, a fixed top-K with a mask."""
        mc = self.cfg.match_coarse
        sc = float(self.cfg.resolution[0])
        stats = dual_softmax_match_stats(feat_c0, feat_c1, temperature=mc.dsmax_temperature)
        i_ids, j_ids, mask, mconf = extract_matches_from_stats(
            stats, grid_c, grid_c, mc.thr, mc.border_rm, mc.max_matches
        )
        return CoarseMatches(i_ids=i_ids, j_ids=j_ids, mask=mask, mconf=mconf,
                             mkpts0_c=ids_to_keypoints(i_ids, grid_c[1], sc),
                             mkpts1_c=ids_to_keypoints(j_ids, grid_c[1], sc))

    def fine_stage(self, feat_f0: torch.Tensor, feat_f1: torch.Tensor,
                   feat_c0: torch.Tensor, feat_c1: torch.Tensor,
                   matches: CoarseMatches, grid_c: Tuple[int, int]) -> FineMatches:
        """Gather the windows at the coarse matches, merge in the coarse
        context, refine (the fused kernel in fold mode when the gate holds)
        and take the soft-argmax. feat_f*: [B, Hf, Wf, Cf]; grid_c: (hc, wc)."""
        cfg = self.cfg
        sc, sf = cfg.resolution
        B = feat_f0.shape[0]
        Cc, Cf = feat_c0.shape[-1], feat_f0.shape[-1]
        i_ids, j_ids = matches.i_ids, matches.j_ids
        Wf = cfg.fine.window_size
        stride = sc // sf
        win0 = gather_fine_windows(feat_f0, i_ids, grid_c, Wf, stride)
        win1 = gather_fine_windows(feat_f1, j_ids, grid_c, Wf, stride)
        # coarse context: down-projected coarse feature at the match, merged into each tap
        c0 = torch.gather(feat_c0, 1, i_ids[..., None].expand(-1, -1, Cc))
        c1 = torch.gather(feat_c1, 1, j_ids[..., None].expand(-1, -1, Cc))
        c0 = _dense(c0, self.fine_down_proj)[:, :, None, :]
        c1 = _dense(c1, self.fine_down_proj)[:, :, None, :]
        win0 = _dense(torch.cat([win0, c0.expand_as(win0)], dim=-1), self.fine_merge)
        win1 = _dense(torch.cat([win1, c1.expand_as(win1)], dim=-1), self.fine_merge)
        K = win0.shape[1]
        ww = Wf * Wf
        w0, w1 = win0.reshape(B * K, ww, Cf), win1.reshape(B * K, ww, Cf)
        mix0 = (self.mix_feat_0.weight[0], self.mix_feat_0.bias)
        mix1 = (self.mix_feat_1.weight[0], self.mix_feat_1.bias)
        if self.use_fused_fine():
            f = cfg.fine
            heat0, heat1 = fine_stage_fused(
                w0, w1, pack_layers(self.fine_transformer, w0.dtype), mix0, mix1,
                f.layer_names, f.nhead, fold_softargmax=True,
            )
            return fine_from_heatmaps(
                heat0.reshape(B, K, ww), heat1.reshape(B, K, ww),
                matches.mkpts0_c, matches.mkpts1_c, Wf, float(sf),
            )
        w0, w1 = self.fine_transformer(w0, w1)
        m0, m1 = window_mix(w0, mix0), window_mix(w1, mix1)
        return fine_soft_argmax(
            m0.reshape(B, K, Cf).float(), m1.reshape(B, K, Cf).float(),
            w0.reshape(B, K, ww, Cf).float(), w1.reshape(B, K, ww, Cf).float(),
            matches.mkpts0_c, matches.mkpts1_c, Wf, float(sf),
        )

    @torch.no_grad()
    def forward(self, image0: torch.Tensor, image1: torch.Tensor) -> MatcherOutput:
        """image*: [B, H, W, C_in] NHWC, H and W divisible by the coarse stride."""
        cfg = self.cfg
        dev = self.mix_feat_0.weight.device
        B, H, W, _ = image0.shape
        if image1.shape != image0.shape:
            raise ValueError(f"image shapes differ: {tuple(image0.shape)} vs {tuple(image1.shape)}")
        sc, _ = cfg.resolution
        if H % sc or W % sc:
            raise ValueError(f"image size {H}x{W} must be divisible by {sc}")
        hc, wc = H // sc, W // sc

        imgs = torch.cat([image0, image1], dim=0).to(device=dev, dtype=self.dtype)
        feat_c, feat_f = self.backbone(imgs)
        Cc = feat_c.shape[-1]
        feat_c0 = feat_c[:B].reshape(B, hc * wc, Cc)
        feat_c1 = feat_c[B:].reshape(B, hc * wc, Cc)
        feat_c0, feat_c1 = self.coarse_stage(feat_c0, feat_c1)

        matches = self.coarse_matching(feat_c0, feat_c1, (hc, wc))
        fine = self.fine_stage(feat_f[:B], feat_f[B:], feat_c0, feat_c1, matches, (hc, wc))
        return MatcherOutput(
            coarse=matches, fine=fine, conf_matrix=None, feat_c0=feat_c0, feat_c1=feat_c1,
            fine_ids=(matches.i_ids, matches.j_ids, matches.mask),
        )
