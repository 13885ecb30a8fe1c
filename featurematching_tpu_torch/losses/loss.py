"""Training losses: the dense coarse focal / cross-entropy loss, the
std-weighted fine loss and their weighted total.

Port of `featurematching_tpu/losses/loss.py` (LossOutput,
compute_coarse_loss, compute_fine_loss, total_loss). Every selection is a
masked mean over fixed-shape inputs. The pose losses wait for the pose heads;
`total_loss` takes no pose term.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from featurematching_tpu_torch.config import LossConfig


class LossOutput(NamedTuple):
    loss: torch.Tensor  # scalar total
    loss_c: torch.Tensor
    loss_f: torch.Tensor
    loss_pose: torch.Tensor


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def compute_coarse_loss(conf: torch.Tensor, conf_gt: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """Focal or cross-entropy loss on the dual-softmax confidence matrix;
    conf, conf_gt: [B, L, S]."""
    conf = conf.clamp(1e-6, 1 - 1e-6)
    pos = conf_gt > 0.5
    neg = ~pos
    if cfg.coarse_type == "cross_entropy":
        loss_pos = _masked_mean(-torch.log(conf), pos)
        loss_neg = _masked_mean(-torch.log(1.0 - conf), neg)
        return cfg.pos_weight * loss_pos + cfg.neg_weight * loss_neg
    if cfg.coarse_type != "focal":
        raise ValueError(f"unknown coarse loss {cfg.coarse_type!r}")
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    loss_pos_el = -alpha * (1.0 - conf) ** gamma * torch.log(conf)
    if cfg.sparse_spvs:  # positives only
        return cfg.pos_weight * _masked_mean(loss_pos_el, pos)
    loss_neg_el = -alpha * conf**gamma * torch.log(1.0 - conf)
    return (cfg.pos_weight * _masked_mean(loss_pos_el, pos)
            + cfg.neg_weight * _masked_mean(loss_neg_el, neg))


def compute_fine_loss(mkpts0_f: torch.Tensor, mkpts1_f: torch.Tensor,
                      expec_f_gt_0: torch.Tensor, expec_f_gt_1: torch.Tensor,
                      spv_mask: torch.Tensor, window: int = 7) -> torch.Tensor:
    """Std-weighted L2 on subpixel offsets.

    mkpts*_f: [B, G, 3] (x, y, std); expec_f_gt_*: [B, G, 2] pixel targets
    (zeros where no GT); spv_mask: [B, G]. Rows weigh by their inverse std,
    normalised by its mean over all real rows and carried no gradient; rows
    whose GT x is 0 are left out."""
    inv0 = 1.0 / mkpts0_f[..., 2].clamp(min=1e-10)
    inv1 = 1.0 / mkpts1_f[..., 2].clamp(min=1e-10)
    m0 = spv_mask & (expec_f_gt_0[..., 0] != 0)
    m1 = spv_mask & (expec_f_gt_1[..., 0] != 0)
    with torch.no_grad():
        w0 = torch.nan_to_num(inv0 / _masked_mean(inv0, spv_mask).clamp(min=1e-10))
        w1 = torch.nan_to_num(inv1 / _masked_mean(inv1, spv_mask).clamp(min=1e-10))
    off0 = (((mkpts0_f[..., :2] - expec_f_gt_0) / window) ** 2).sum(-1)
    off1 = (((mkpts1_f[..., :2] - expec_f_gt_1) / window) ** 2).sum(-1)
    return _masked_mean(off0 * w0, m0) + _masked_mean(off1 * w1, m1)


def total_loss(conf: Optional[torch.Tensor], conf_gt: Optional[torch.Tensor],
               mkpts0_f: torch.Tensor, mkpts1_f: torch.Tensor,
               expec_f_gt_0: torch.Tensor, expec_f_gt_1: torch.Tensor,
               spv_mask: torch.Tensor, cfg: LossConfig, window: int = 7,
               loss_c_override: Optional[torch.Tensor] = None) -> LossOutput:
    """coarse_weight * L_c + fine_weight * L_f. `loss_c_override` is a coarse
    loss computed elsewhere (the sparse focal loss) and skips the dense one."""
    loss_c = loss_c_override if loss_c_override is not None else compute_coarse_loss(
        conf, conf_gt, cfg)
    loss_f = compute_fine_loss(mkpts0_f, mkpts1_f, expec_f_gt_0, expec_f_gt_1, spv_mask, window)
    loss = cfg.coarse_weight * loss_c + cfg.fine_weight * loss_f
    return LossOutput(loss=loss, loss_c=loss_c, loss_f=loss_f,
                      loss_pose=torch.zeros((), dtype=loss.dtype, device=loss.device))
