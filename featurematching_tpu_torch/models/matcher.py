"""The config-driven coarse-to-fine Matcher of training and evaluation.

Port of `featurematching_tpu/models/matcher.py · Matcher` for the swin_v1
backbone. Like `fast_inference.FastMatcher` it extends
`matcher_params.MatcherParams`, so both hold the same parameters under the
same names and one flax `variables["params"]` tree loads into either. The
pipeline:

  1. the Swin-UNet over the stacked pair (`backbone_swin.SwinUNet`, with
     drop-path in training): every block through `swin_block_train`, kernel
     K8 on the card, where `swin.fused_block` selects it, else the per-op
     block, whose window attention runs K11 (`ops/window_attention`) where
     `swin.fused_attention` selects it in evaluation;
  2. the coarse LoFTR transformer: K9 (`ops/coarse_transformer_train`)
     where `coarse.fused_train` selects it, else the per-op
     `LocalFeatureTransformer`;
  3. in a sparse-supervised training step (gt_ids given, no conf matrix
     wanted) an empty fixed-shape match list, as the JAX package emits: the
     coarse loss comes from `ops/sparse_focal_loss` and the fine stage reads
     the GT ids. Otherwise the top-K mutual nearest neighbours
     (`matching/coarse.coarse_match`): where the conf matrix is wanted (the
     dense loss's) it is formed at the JAX rounding points
     (`matching/coarse.dual_softmax_confidence`) and the matches come from
     it, else from the dual-softmax statistics (K1);
  4. at `coarse_only` (the LoFTR-tiny teacher's mode) the forward ends here:
     the "fine" keypoints are the coarse centres;
  5. the fine windows at the GT ids (training) or the matches, merged with
     the down-projected coarse features, the fine transformer (K10,
     `ops/fine_transformer_train`, where `fine.fused_train` selects it, else
     the per-op stack), the learned 49 -> 1 mixes and the soft-argmax.

The kernel switches of the configuration hold as in the JAX package; the
form not ported yet raises: the pose heads (`pose.flag` other than 'none').
The ResNet-FPN backbone is not ported. Runs on `cuda` unless `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.matching.coarse import (
    CoarseMatches,
    dual_softmax_confidence,
    ids_to_keypoints,
)
from featurematching_tpu_torch.matching.fine import FineMatches
from featurematching_tpu_torch.models.backbone_swin import SwinUNet
from featurematching_tpu_torch.models.matcher_params import MatcherParams
from featurematching_tpu_torch.models.output import MatcherOutput
from featurematching_tpu_torch.ops.coarse_transformer import (
    TRAIN_WIDTHS,
    coarse_transformer_supported,
)
from featurematching_tpu_torch.ops.fine_stage import (
    C_KERNEL,
    MAX_TAPS,
    TRAIN_HEAD_DIMS,
    fine_stage_supported,
    fine_train_supported,
)
from featurematching_tpu_torch.ops.swin_block_train import HEAD_DIMS as TRAIN_SWIN_HEAD_DIMS

__all__ = ["Matcher", "MatcherOutput"]


def kernel_selected(switch: str, device: torch.device) -> bool:
    """'on' selects the kernel, 'off' the per-op form, 'auto' the kernel on
    the card and the per-op form on the CPU."""
    if switch not in ("on", "off", "auto"):
        raise ValueError(f"unknown switch value {switch!r}")
    return switch == "on" or (switch == "auto" and device.type == "cuda")


class Matcher(MatcherParams):
    """Training and evaluation forward over the Matcher's weights.

    `generator` (a torch.Generator on the model's device, seeded with
    `seed`) draws the drop-path masks of a training forward."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__(cfg, SwinUNet(cfg), device, seed)
        dev = self.device
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # as flax's Matcher builds its transformers (use_fused_train)
        self.coarse_transformer.use_fused_train = kernel_selected(cfg.coarse.fused_train, dev)
        if not cfg.coarse_only:
            self.fine_transformer.use_fused_train = kernel_selected(cfg.fine.fused_train, dev)
        self.check_switches()
        if dev.type == "cuda":
            lacking = self.widths_lacking()
            if lacking:
                raise NotImplementedError(
                    "the training step's kernels do not take this config's widths: "
                    + "; ".join(lacking))

    def swin_switches(self, train: bool) -> Tuple[bool, bool]:
        """(fused block, fused attention) as flax's Matcher selects them:
        fused_block 'auto' means the card; fused_attention 'auto' means
        evaluation on the card; the attention kernel only where the fused
        block is off (the backbone also holds K11 to its limits)."""
        s = self.cfg.swin
        dev = self.device
        fused_blk = kernel_selected(s.fused_block, dev)
        fused_attn = kernel_selected(s.fused_attention, dev) and (
            s.fused_attention == "on" or not train)
        return fused_blk, fused_attn and not fused_blk

    def widths_lacking(self):
        """For each kernel its switch selects where the JAX gate holds at a
        width the kernel does not take, the kernel and the width (empty:
        every branch the switches and gates choose has its kernel)."""
        s, c, f = self.cfg.swin, self.cfg.coarse, self.cfg.fine
        out = []
        dims = [s.embed_dim * 2**i // h for i, h in enumerate(s.num_heads)]
        if self.swin_switches(True)[0] and any(d not in TRAIN_SWIN_HEAD_DIMS for d in dims):
            out.append(f"K8 (swin_block_train) takes Swin head dims {TRAIN_SWIN_HEAD_DIMS}, "
                       f"this config has {dims}")
        if (self.coarse_transformer.use_fused_train and c.attention == "linear"
                and coarse_transformer_supported(c.layer_names, c.d_model, c.nhead, 1)
                and (c.d_model, c.d_model // c.nhead) not in TRAIN_WIDTHS):
            out.append(f"K9 (coarse_transformer_train) takes (C, head dim) in {TRAIN_WIDTHS}, "
                       f"this config has C {c.d_model} with {c.nhead} heads")
        taps = f.window_size**2
        if (not self.cfg.coarse_only and self.fine_transformer.use_fused_train
                and f.attention == "linear"
                and fine_stage_supported(f.layer_names, f.d_model, f.nhead) and taps <= 128
                and not fine_train_supported(f.layer_names, f.d_model, f.nhead, taps)):
            out.append(f"K10 (fine_transformer_train) takes C {C_KERNEL} with a head dim in "
                       f"{TRAIN_HEAD_DIMS} and at most {MAX_TAPS} taps, this config has C "
                       f"{f.d_model} with {f.nhead} heads and {taps} taps")
        return out

    def check_switches(self) -> None:
        cfg = self.cfg
        self.swin_switches(False)  # unknown switch values raise
        if cfg.pose.flag != "none":
            raise NotImplementedError(f"pose heads (pose.flag={cfg.pose.flag!r}) are not ported yet")

    def forward(
        self,
        image0: torch.Tensor,
        image1: torch.Tensor,
        train: bool = False,
        gt_ids: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
        want_conf_matrix: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ) -> MatcherOutput:
        """image*: [B, H, W, C_in] NHWC, H and W divisible by the coarse
        stride. gt_ids: (spv_i_ids, spv_j_ids, spv_mask), each [B, G]: the
        fine stage's ids in training."""
        cfg = self.cfg
        self.check_switches()
        dev = self.device
        B, H, W, _ = image0.shape
        if image1.shape != image0.shape:
            raise ValueError(f"image shapes differ: {tuple(image0.shape)} vs {tuple(image1.shape)}")
        sc, _ = cfg.resolution
        if H % sc or W % sc:
            raise ValueError(f"image size {H}x{W} must be divisible by {sc}")
        hc, wc = H // sc, W // sc
        if want_conf_matrix is None:
            want_conf_matrix = train

        imgs = torch.cat([image0, image1], dim=0).to(device=dev, dtype=self.dtype)
        fused_blk, fused_attn = self.swin_switches(train)
        feat_c, feat_f = self.backbone(imgs, train=train,
                                       generator=generator if generator is not None
                                       else self.generator,
                                       fused_block=fused_blk, fused_attention=fused_attn)
        Cc = feat_c.shape[-1]
        feat_c0, feat_c1 = self.coarse_transformer(feat_c[:B].reshape(B, hc * wc, Cc),
                                                   feat_c[B:].reshape(B, hc * wc, Cc))
        mc = cfg.match_coarse
        conf = None
        if train and gt_ids is not None and not want_conf_matrix:
            K = mc.max_matches
            zi = torch.zeros(B, K, dtype=torch.long, device=dev)
            zk = torch.zeros(B, K, 2, device=dev)
            matches = CoarseMatches(i_ids=zi, j_ids=zi, mask=torch.zeros_like(zi, dtype=torch.bool),
                                    mconf=torch.zeros(B, K, device=dev, dtype=feat_c0.dtype),
                                    mkpts0_c=zk, mkpts1_c=zk)
        else:
            if want_conf_matrix:
                conf = dual_softmax_confidence(feat_c0, feat_c1, mc.dsmax_temperature)
            matches = self.coarse_matching(feat_c0, feat_c1, (hc, wc), conf)

        if cfg.coarse_only:
            zeros = torch.zeros_like(matches.mkpts0_c[..., :1])
            fine = FineMatches(
                mkpts0_f=torch.cat([matches.mkpts0_c, zeros], -1),
                mkpts1_f=torch.cat([matches.mkpts1_c, zeros], -1),
                coords0=torch.zeros_like(matches.mkpts0_c),
                coords1=torch.zeros_like(matches.mkpts1_c),
                std0=zeros[..., 0], std1=zeros[..., 0])
            return MatcherOutput(coarse=matches, fine=fine, conf_matrix=conf,
                                 feat_c0=feat_c0, feat_c1=feat_c1,
                                 fine_ids=(matches.i_ids, matches.j_ids, matches.mask))

        if train and gt_ids is not None:
            fid_i, fid_j, fid_mask = gt_ids
            mk0 = ids_to_keypoints(fid_i, wc, float(sc))
            mk1 = ids_to_keypoints(fid_j, wc, float(sc))
        else:
            fid_i, fid_j, fid_mask = matches.i_ids, matches.j_ids, matches.mask
            mk0, mk1 = matches.mkpts0_c, matches.mkpts1_c
        w0, w1 = self.fine_windows(feat_f[:B], feat_f[B:], feat_c0, feat_c1,
                                   fid_i, fid_j, (hc, wc))
        fine = self.fine_refine(w0, w1, mk0, mk1)
        return MatcherOutput(coarse=matches, fine=fine, conf_matrix=conf,
                             feat_c0=feat_c0, feat_c1=feat_c1, fine_ids=(fid_i, fid_j, fid_mask))
