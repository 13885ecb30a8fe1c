"""The config-driven coarse-to-fine Matcher of training and evaluation.

Port of `featurematching_tpu/models/matcher.py · Matcher`. Like
`fast_inference.FastMatcher` it extends
`matcher_params.MatcherParams`, so both hold the same parameters under the
same names and one flax `variables["params"]` tree loads into either. The
pipeline:

  1. the backbone over the stacked pair: the Swin-UNet
     (`backbone_swin.SwinUNet`, with drop-path in training): every block
     through `swin_block_train`, kernel K8 on the card, where
     `swin.fused_block` selects it, else the per-op block, whose window
     attention runs K11 (`ops/window_attention`) where
     `swin.fused_attention` selects it in evaluation; or the ResNet-FPN
     (`backbone_resnet_fpn.ResNetFPN`, evaluation only, cuDNN convolutions
     with BatchNorm's running statistics; at `coarse_only` it stops at the
     coarse map), followed by the sine positional encoding
     (`positional_encoding`; by default for ResNet-FPN only);
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
forms not ported yet raise: the pose heads (`pose.flag` other than 'none')
and a training forward of the ResNet-FPN Matcher. On the card the
construction raises NotImplementedError where a selected kernel lacks the
config's widths or compute dtype (`widths_lacking`; at float32 only K1's
and K5's kernels, so the LoFTR-tiny teacher's evaluation forward). Runs on
`cuda` unless `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.matching.coarse import (
    CoarseMatches,
    dual_softmax_confidence,
    ids_to_keypoints,
)
from featurematching_tpu_torch.matching.fine import FineMatches
from featurematching_tpu_torch.models.backbone_resnet_fpn import ResNetFPN
from featurematching_tpu_torch.models.backbone_swin import SwinUNet
from featurematching_tpu_torch.models.matcher_params import MatcherParams
from featurematching_tpu_torch.models.output import MatcherOutput
from featurematching_tpu_torch.ops.coarse_transformer import (
    TRAIN_WIDTHS,
    coarse_transformer_supported,
    forward_widths,
)
from featurematching_tpu_torch.ops.dual_softmax import MATCH_STATS_TAKES, match_stats_takes
from featurematching_tpu_torch.ops.fine_stage import (
    C_KERNEL,
    HEAD_DIMS,
    MAX_TAPS,
    TRAIN_HEAD_DIMS,
    fine_stage_supported,
    fine_train_supported,
)
from featurematching_tpu_torch.ops.swin_block_train import HEAD_DIMS as TRAIN_SWIN_HEAD_DIMS

__all__ = ["Matcher", "MatcherOutput"]


def sine_positional_encoding(shape: Tuple[int, int], d_model: int) -> np.ndarray:
    """The 2D sine positional encoding [H, W, C] (float32): channels 4k and
    4k + 1 sin and cos of the column (from 1) times div_k, 4k + 2 and 4k + 3
    of the row, div_k = exp(2k (-log 10000) / (C / 2))."""
    h, w = shape
    pe = np.zeros((d_model, h, w), dtype=np.float32)
    y = np.arange(1, h + 1, dtype=np.float32)[:, None]
    x = np.arange(1, w + 1, dtype=np.float32)[None, :]
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-np.log(10000.0) / (d_model // 2)))[:, None, None]
    pe[0::4] = np.sin(x[None] * div)
    pe[1::4] = np.cos(x[None] * div)
    pe[2::4] = np.sin(y[None] * div)
    pe[3::4] = np.cos(y[None] * div)
    return pe.transpose(1, 2, 0)


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
        if cfg.backbone_type == "swin_v1":
            backbone = SwinUNet(cfg)
        elif cfg.backbone_type == "resnet_fpn":
            backbone = ResNetFPN(cfg)
        else:
            raise ValueError(f"unknown backbone {cfg.backbone_type!r}")
        super().__init__(cfg, backbone, device, seed)
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
                    "the Matcher's kernels do not take this config's widths or dtype: "
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
        """For each kernel the switches and the JAX gates select at a width
        or a compute dtype the kernel does not take, the kernel and what it
        lacks (empty: every branch the switches and gates choose has its
        kernel). The evaluation forward's kernels always (K1's statistics,
        K9's forward on K5's kernels, K10's on K6's, K11), the training
        forward's where the Matcher trains (K8, K9's and K10's backwards,
        `wgrad`, K7 with K1's pass 1): the port trains the swin_v1 backbone,
        not ResNet-FPN. Only K1 and K5's kernels (so K9's forward) take
        float32."""
        cfg = self.cfg
        s, c, f = cfg.swin, cfg.coarse, cfg.fine
        dt, name = self.dtype, cfg.compute_dtype
        bf16 = dt == torch.bfloat16
        trains = cfg.backbone_type == "swin_v1"
        out = []
        backwards = False  # a selected kernel with a backward (its wgrad)
        if cfg.backbone_type == "swin_v1":
            dims = [s.embed_dim * 2**i // h for i, h in enumerate(s.num_heads)]
            fused_blk = self.swin_switches(True)[0]
            if fused_blk and any(d not in TRAIN_SWIN_HEAD_DIMS for d in dims):
                out.append(f"K8 (swin_block_train) takes Swin head dims "
                           f"{TRAIN_SWIN_HEAD_DIMS}, this config has {dims}")
            if fused_blk and not bf16:
                out.append(f"K8 (swin_block_train) takes bfloat16, this config computes in "
                           f"{name}")
            backwards |= fused_blk
            if (self.swin_switches(False)[1] or self.swin_switches(True)[1]) and not bf16:
                out.append(f"K11 (window_attention) takes bfloat16, this config computes in "
                           f"{name}")
        width = (c.d_model, c.d_model // c.nhead) if c.d_model % c.nhead == 0 else None
        if (self.coarse_transformer.use_fused_train and c.attention == "linear"
                and coarse_transformer_supported(c.layer_names, c.d_model, c.nhead, 1)):
            if trains and width not in TRAIN_WIDTHS:
                out.append(f"K9 (coarse_transformer_train) takes (C, head dim) in "
                           f"{TRAIN_WIDTHS}, this config has C {c.d_model} with {c.nhead} heads")
            if trains and not bf16:
                out.append(f"K9's backward (coarse_transformer_train) takes bfloat16, this "
                           f"config computes in {name}")
            if not trains and width not in forward_widths(dt):
                out.append(f"K9's forward (K5's kernels) takes (C, head dim) in "
                           f"{forward_widths(dt)} at {name}, this config has C {c.d_model} "
                           f"with {c.nhead} heads")
            backwards |= trains
        taps = f.window_size**2
        if (not cfg.coarse_only and self.fine_transformer.use_fused_train
                and f.attention == "linear"
                and fine_stage_supported(f.layer_names, f.d_model, f.nhead) and taps <= 128):
            if not fine_train_supported(f.layer_names, f.d_model, f.nhead, taps, not trains):
                dims = TRAIN_HEAD_DIMS if trains else HEAD_DIMS
                out.append(f"K10 (fine_transformer_train) takes C {C_KERNEL} with a head dim in "
                           f"{dims} and at most {MAX_TAPS} taps, this config has C "
                           f"{f.d_model} with {f.nhead} heads and {taps} taps")
            if not bf16:
                out.append(f"K10 (fine_transformer_train; its forward K6's kernel) takes "
                           f"bfloat16, this config computes in {name}")
            backwards |= trains
        if backwards and not bf16:
            out.append(f"wgrad (the weight gradients of K8's, K9's and K10's backwards) takes "
                       f"bfloat16, this config computes in {name}")
        loss = cfg.loss
        if trains and loss.sparse_spvs and loss.coarse_type == "focal" and not bf16:
            out.append(f"K7 (sparse_focal_backward) and K1's pass 1 (dual_softmax_lse) take "
                       f"bfloat16, this config computes in {name}")
        if not match_stats_takes(c.d_model, dt):
            out.append(f"K1 (dual_softmax_match_stats) {MATCH_STATS_TAKES}, this config has "
                       f"C {c.d_model} in {name}")
        return out

    def uses_positional_encoding(self) -> bool:
        """`positional_encoding`, where None means on for resnet_fpn (no
        positional signal of its own) and off for swin_v1, as flax decides."""
        pe = self.cfg.positional_encoding
        return self.cfg.backbone_type == "resnet_fpn" if pe is None else pe

    def positional_encoding(self, hc: int, wc: int, C: int) -> torch.Tensor:
        """The sine encoding [hc, wc, C] in the compute dtype on the model's
        device, made once a grid."""
        key = (hc, wc, C, self.dtype, self.device)
        held = getattr(self, "_pe", None)
        if held is None or held[0] != key:
            pe = torch.as_tensor(sine_positional_encoding((hc, wc), C))
            self._pe = held = (key, pe.to(device=self.device, dtype=self.dtype))
        return held[1]

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
        if cfg.backbone_type == "resnet_fpn":
            if train:
                raise NotImplementedError(
                    "the training forward of the ResNet-FPN Matcher is not ported: training "
                    "updates the backbone's BatchNorm statistics")
            feat_c, feat_f = self.backbone(imgs, fine=not cfg.coarse_only)
        else:
            fused_blk, fused_attn = self.swin_switches(train)
            feat_c, feat_f = self.backbone(imgs, train=train,
                                           generator=generator if generator is not None
                                           else self.generator,
                                           fused_block=fused_blk, fused_attention=fused_attn)
        Cc = feat_c.shape[-1]
        if self.uses_positional_encoding():
            feat_c = feat_c + self.positional_encoding(hc, wc, Cc)
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
