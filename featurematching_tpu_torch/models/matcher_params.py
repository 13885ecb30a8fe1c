"""The Matcher's weights and the steps both of its forwards take.

`MatcherParams` holds the parameter tree of the JAX package's `Matcher`
(swin_v1) under the same names: the backbone given to it, the coarse and
fine LoFTR transformers, fine_down_proj, fine_merge and the two 49 -> 1
mixes (at `coarse_only` none of the fine modules, as the JAX Matcher creates
none). One flax `variables["params"]` tree therefore loads into either
forward that extends it: the serving `fast_inference.FastMatcher` and the
training `matcher.Matcher`. The methods here are the steps they share: the
coarse matching (`matching/coarse.coarse_match`: from a conf matrix where
one is given, else from K1's statistics), the fine windows and the per-op
fine refinement.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.matching.coarse import CoarseMatches, coarse_match
from featurematching_tpu_torch.matching.fine import (
    FineMatches,
    fine_soft_argmax,
    gather_fine_windows,
)
from featurematching_tpu_torch.models.backbone_swin import dense
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops.fine_stage import window_mix
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


class MatcherParams(nn.Module):
    """The Matcher's weights around `backbone` (a `SwinUNetParams`), seeded
    from `seed` and moved to `device`, in eval mode."""

    def __init__(self, cfg: ModelConfig, backbone: nn.Module, device, seed: int):
        super().__init__()
        dev = resolve_device(device)
        if cfg.backbone_type != "swin_v1":
            raise ValueError("the port implements the swin_v1 backbone")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.backbone = backbone
        c, f = cfg.coarse, cfg.fine
        self.coarse_transformer = LocalFeatureTransformer(
            c.d_model, c.nhead, c.layer_names, c.attention)
        if not cfg.coarse_only:
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

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def coarse_matching(self, feat_c0: torch.Tensor, feat_c1: torch.Tensor,
                        grid_c: Tuple[int, int], conf=None) -> CoarseMatches:
        """Dual-softmax mutual nearest neighbours, a fixed top-K with a mask:
        from `conf` [B, L, S] where it is given, else from K1's statistics."""
        mc = self.cfg.match_coarse
        matches, _ = coarse_match(feat_c0, feat_c1, grid_c, grid_c, float(self.cfg.resolution[0]),
                                  mc.thr, mc.border_rm, mc.dsmax_temperature, mc.max_matches,
                                  conf)
        return matches

    def fine_windows(self, feat_f0: torch.Tensor, feat_f1: torch.Tensor,
                     feat_c0: torch.Tensor, feat_c1: torch.Tensor,
                     i_ids: torch.Tensor, j_ids: torch.Tensor, grid_c: Tuple[int, int]):
        """The 7x7 windows of the fine maps at coarse ids [B, K], with the
        down-projected coarse feature at each id merged into every tap:
        (w0, w1), each [B*K, W*W, Cf]. feat_f*: [B, Hf, Wf, Cf]."""
        cfg = self.cfg
        sc, sf = cfg.resolution
        B = feat_f0.shape[0]
        Cc, Cf = feat_c0.shape[-1], feat_f0.shape[-1]
        Wf = cfg.fine.window_size
        win0 = gather_fine_windows(feat_f0, i_ids, grid_c, Wf, sc // sf)
        win1 = gather_fine_windows(feat_f1, j_ids, grid_c, Wf, sc // sf)
        c0 = torch.gather(feat_c0, 1, i_ids[..., None].expand(-1, -1, Cc))
        c1 = torch.gather(feat_c1, 1, j_ids[..., None].expand(-1, -1, Cc))
        c0 = dense(c0, self.fine_down_proj)[:, :, None, :]
        c1 = dense(c1, self.fine_down_proj)[:, :, None, :]
        win0 = dense(torch.cat([win0, c0.expand_as(win0)], dim=-1), self.fine_merge)
        win1 = dense(torch.cat([win1, c1.expand_as(win1)], dim=-1), self.fine_merge)
        K = win0.shape[1]
        return win0.reshape(B * K, Wf * Wf, Cf), win1.reshape(B * K, Wf * Wf, Cf)

    def fine_refine(self, w0: torch.Tensor, w1: torch.Tensor, mkpts0_c: torch.Tensor,
                    mkpts1_c: torch.Tensor) -> FineMatches:
        """The plain fine transformer over the windows, the 49->1 mixes and
        the soft-argmax. w*: [B*K, W*W, Cf]; mkpts*_c: [B, K, 2]."""
        cfg = self.cfg
        B, K = mkpts0_c.shape[:2]
        Wf, sf = cfg.fine.window_size, cfg.resolution[1]
        ww, Cf = w0.shape[1], w0.shape[2]
        w0, w1 = self.fine_transformer(w0, w1)
        m0 = window_mix(w0, (self.mix_feat_0.weight[0], self.mix_feat_0.bias))
        m1 = window_mix(w1, (self.mix_feat_1.weight[0], self.mix_feat_1.bias))
        return fine_soft_argmax(
            m0.reshape(B, K, Cf).float(), m1.reshape(B, K, Cf).float(),
            w0.reshape(B, K, ww, Cf).float(), w1.reshape(B, K, ww, Cf).float(),
            mkpts0_c, mkpts1_c, Wf, float(sf),
        )
