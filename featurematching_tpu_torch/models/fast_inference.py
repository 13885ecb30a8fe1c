"""The serving forward: image pair -> coarse matches -> refined keypoints.

Port of `featurematching_tpu/models/fast_inference.py` (swin_backbone_fast
and make_fast_matcher_fn). At `default_config()` the forward runs six
kernels, as the JAX package does on its accelerator: the backbone through
swin_block_fused (13 launches), layer_norm_chain (4) and patch_expand_ln (3),
the coarse transformer through coarse_transformer_fused (once, 8 layers),
the coarse matching through dual_softmax_match_stats (once) and the fine
stage through fine_stage_fused in its fold mode (once). At
`tpu_optimized_config()` (head dim 64 in the Swin blocks, the coarse
transformer and the fine stage) it runs the same six kernels. Each fused
branch is gated as the JAX package gates it (`use_fused_coarse`,
`use_fused_fine`, `patch_expand_supported`: pure functions of the config
and the shapes, chosen before any launch); where a gate fails, the plain
LocalFeatureTransformer, window mix and fine_soft_argmax, or depth-to-space
and layer_norm_chain, run instead, as the JAX package's plain branches do.
Where a gate holds at a width the kernel lacks (K2 takes Swin head dims
16, 32 and 64; K5 the (C, head dim) pairs of `WIDTHS`; K6 C = 64 with a
head dim in `HEAD_DIMS`, at most `MAX_LAYERS` layers and `MAX_TAPS` taps),
the model raises NotImplementedError on `cuda` at construction, naming the
kernel and the width, and runs no eager branch in its place; on the CPU
every kernel's plain version takes any width.

`FastMatcher(cfg)` runs on `cuda` and raises when no GPU is present;
`device="cpu"` runs every kernel's plain version instead. Inputs and outputs
keep the JAX package's layouts: NHWC images, [B, L, C] tokens.

Usage:
    model = FastMatcher(default_config().model)          # seeded init
    load_jax_params(model, jax_variables["params"])       # or JAX weights
    out = model(image0, image1)                           # MatcherOutput
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.matching.coarse import CoarseMatches
from featurematching_tpu_torch.matching.fine import FineMatches, fine_from_heatmaps
from featurematching_tpu_torch.models.backbone_swin import (
    SwinBlockParams,
    SwinUNetParams,
    dense,
    patch_merge,
)
from featurematching_tpu_torch.models.matcher_params import MatcherParams, resolve_device
from featurematching_tpu_torch.models.output import MatcherOutput
from featurematching_tpu_torch.ops.coarse_transformer import (
    WIDTHS,
    coarse_transformer_fused,
    coarse_transformer_supported,
    pack_layers,
)
from featurematching_tpu_torch.ops.fine_stage import (
    C_KERNEL,
    HEAD_DIMS,
    MAX_LAYERS,
    MAX_TAPS,
    fine_stage_fused,
    fine_stage_supported,
)
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain
from featurematching_tpu_torch.ops.patch_expand import (
    depth_to_space,
    head_weight,
    patch_expand_ln,
    patch_expand_supported,
)
from featurematching_tpu_torch.ops.swin_block import HEAD_DIMS as SWIN_HEAD_DIMS
from featurematching_tpu_torch.ops.swin_block import swin_block_fused

__all__ = ["FastMatcher", "SwinBackbone", "resolve_device"]


class SwinBackbone(SwinUNetParams):
    """The serving forward over the Swin-UNet weights: every block through swin_block_fused (K2), the stage LNs
    through layer_norm_chain (K3), PatchExpand through patch_expand_ln (K4).
    Returns (coarse [B, H/8, W/8, 256], fine [B, H/2, W/2, 64])."""

    def _run_block(self, x: torch.Tensor, H: int, W: int, blk: SwinBlockParams,
                   shift: int) -> torch.Tensor:
        """One Swin block via the fused kernel in window space. x: [B, H*W, C]."""
        return self._in_windows(x, H, W, shift, lambda xw, mask, nW: swin_block_fused(
            xw, mask, blk.kernel_params(), blk.num_heads)).contiguous()

    def _patch_expand(self, x: torch.Tensor, H: int, W: int, j: int,
                      head: Optional[nn.Linear], emit_ln: bool):
        pe = getattr(self, f"dec{j}_expand")
        nu = getattr(self, f"norm_up{j}")
        y = dense(x, pe.expand)
        if not patch_expand_supported(y.shape[-1] // 4, 0 if head is None else head.out_features):
            # the JAX package's per-op form: depth-to-space, the LN chain, the head
            v = layer_norm_chain(depth_to_space(y, H, W).contiguous(), pe.norm.weight,
                                 pe.norm.bias, nu.weight, nu.bias)
            return tuple(([v] if emit_ln else []) + ([dense(v, head)] if head is not None else []))
        # the heads have no bias; their weights kept in the kernel's layout
        w_head = None if head is None else head_weight(head.weight, y.dtype)
        return patch_expand_ln(
            y, H, W, pe.norm.weight, pe.norm.bias, nu.weight, nu.bias,
            w_head=w_head, emit_ln=emit_ln,
        )

    def forward(self, x: torch.Tensor):
        """x: [B, H, W, C_in] in the compute dtype (NHWC)."""
        s = self.cfg
        B = x.shape[0]
        y = self._embed(x)
        Wh, Ww = y.shape[1], y.shape[2]
        y = y.reshape(B, Wh * Ww, s.embed_dim).contiguous()
        y = layer_norm_chain(y, self.patch_norm.weight, self.patch_norm.bias)

        n = len(s.depths)
        for i in range(n):
            for b in range(s.depths[i]):
                shift = 0 if b % 2 == 0 else s.window_size // 2
                y = self._run_block(y, Wh, Ww, getattr(self, f"enc{i}_blk{b}"), shift)
            if i < n - 1:
                y = patch_merge(y, Wh, Ww, getattr(self, f"enc{i}_merge"))
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


class FastMatcher(MatcherParams):
    """The serving forward over the Matcher's weights (eval only).

    Weights come from a seeded init (`seed`) or from `load_jax_params`.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        if cfg.coarse_only:  # make_fast_matcher_fn reads the fine stage's weights too
            raise ValueError("the serving forward has no coarse-only mode; use "
                             "matcher.Matcher for coarse_only")
        super().__init__(cfg, SwinBackbone(cfg), device, seed)
        if self.device.type == "cuda":
            lacking = self.widths_lacking()
            if lacking:
                raise NotImplementedError(
                    "the serving forward's kernels do not take this config's widths: "
                    + "; ".join(lacking))

    def widths_lacking(self):
        """For each fused branch whose JAX gate holds at a width its kernel
        does not take, the kernel and the width (empty: every branch the
        gates choose has its kernel)."""
        s, c, f = self.cfg.swin, self.cfg.coarse, self.cfg.fine
        out = []
        dims = [s.embed_dim * 2**i // h for i, h in enumerate(s.num_heads)]
        if any(d not in SWIN_HEAD_DIMS for d in dims):
            out.append(f"K2 (swin_block_fused) takes Swin head dims {SWIN_HEAD_DIMS}, this "
                       f"config has {dims}; the evaluation Matcher with "
                       f"swin.fused_block='off' runs the others")
        width = (c.d_model, c.d_model // c.nhead) if c.d_model % c.nhead == 0 else None
        if self.use_fused_coarse(1) and width not in WIDTHS:
            out.append(f"K5 (coarse_transformer_fused) takes (C, head dim) in {WIDTHS}, this "
                       f"config has C {c.d_model} with {c.nhead} heads")
        if (self.use_fused_fine() and (f.d_model != C_KERNEL
                                       or f.d_model // f.nhead not in HEAD_DIMS
                                       or len(f.layer_names) > MAX_LAYERS
                                       or f.window_size**2 > MAX_TAPS)):
            out.append(f"K6 (fine_stage_fused) takes C {C_KERNEL} with a head dim in "
                       f"{HEAD_DIMS}, at most {MAX_LAYERS} layers and {MAX_TAPS} taps, this "
                       f"config has C {f.d_model} with {f.nhead} heads, "
                       f"{len(f.layer_names)} layers and {f.window_size**2} taps")
        return out

    def use_fused_coarse(self, n_tokens: int) -> bool:
        """The JAX gate (its widths K5's kernels take: construction on the
        card checked them)."""
        c = self.cfg.coarse
        return c.attention == "linear" and coarse_transformer_supported(
            c.layer_names, c.d_model, c.nhead, n_tokens)

    def use_fused_fine(self) -> bool:
        """The JAX gate (its widths, layers and taps K6's kernel takes:
        construction on the card checked them)."""
        f = self.cfg.fine
        return f.attention == "linear" and fine_stage_supported(f.layer_names, f.d_model, f.nhead)

    def coarse_stage(self, feat_c0: torch.Tensor, feat_c1: torch.Tensor):
        """The coarse transformer on [B, L, C] tokens: the fused kernels when
        the gate holds, else the plain LocalFeatureTransformer."""
        if not self.use_fused_coarse(feat_c0.shape[1]):
            return self.coarse_transformer(feat_c0, feat_c1)
        c = self.cfg.coarse
        return coarse_transformer_fused(
            feat_c0, feat_c1, pack_layers(self.coarse_transformer, feat_c0.dtype),
            c.layer_names, c.nhead)

    def fine_stage(self, feat_f0: torch.Tensor, feat_f1: torch.Tensor,
                   feat_c0: torch.Tensor, feat_c1: torch.Tensor,
                   matches: CoarseMatches, grid_c: Tuple[int, int]) -> FineMatches:
        """Gather the windows at the coarse matches, merge in the coarse
        context, refine (the fused kernel in fold mode when the gate holds)
        and take the soft-argmax. feat_f*: [B, Hf, Wf, Cf]; grid_c: (hc, wc)."""
        B, K = matches.i_ids.shape
        w0, w1 = self.fine_windows(feat_f0, feat_f1, feat_c0, feat_c1,
                                   matches.i_ids, matches.j_ids, grid_c)
        if self.use_fused_fine():
            f, ww, sf = self.cfg.fine, w0.shape[1], self.cfg.resolution[1]
            mix0 = (self.mix_feat_0.weight[0], self.mix_feat_0.bias)
            mix1 = (self.mix_feat_1.weight[0], self.mix_feat_1.bias)
            heat0, heat1 = fine_stage_fused(
                w0, w1, pack_layers(self.fine_transformer, w0.dtype), mix0, mix1,
                f.layer_names, f.nhead, fold_softargmax=True,
            )
            return fine_from_heatmaps(
                heat0.reshape(B, K, ww), heat1.reshape(B, K, ww),
                matches.mkpts0_c, matches.mkpts1_c, f.window_size, float(sf),
            )
        return self.fine_refine(w0, w1, matches.mkpts0_c, matches.mkpts1_c)

    @torch.no_grad()
    def forward(self, image0: torch.Tensor, image1: torch.Tensor) -> MatcherOutput:
        """image*: [B, H, W, C_in] NHWC, H and W divisible by the coarse stride."""
        cfg = self.cfg
        dev = self.device
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
