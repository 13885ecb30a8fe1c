"""The training and evaluation steps.

Port of `featurematching_tpu/train/step.py`: supervision from the batch's
padded GT pairs, the Matcher's forward, the fine supervision at the ids the
fine stage used, and the loss: the sparse focal coarse loss
(`ops/sparse_focal_loss`, kernel K7 on the card) when
`loss.sparse_spvs` and `coarse_type == 'focal'`, else the dense loss on the
conf matrix; plus the std-weighted fine loss. `train_step` differentiates
the total with autograd and applies the optimizer (clip-by-global-norm, then
AdamW) in place.

Batch (numpy arrays or tensors; see `data/synthetic.synthetic_batch`):
    image0, image1: [B, H, W, C] float in [0, 1], or uint8 (divided by 255
                    on the device: 8-bit frames cross to the card as bytes)
    gt_kp0, gt_kp1: [B, G, 2] pseudo-GT keypoint pairs (full-res px)
    gt_mask:        [B, G]
Other keys (poses, intrinsics) are not read: the pose heads are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from featurematching_tpu_torch.config import Config
from featurematching_tpu_torch.losses.loss import total_loss
from featurematching_tpu_torch.matching.supervision import (
    compute_supervision_coarse,
    compute_supervision_fine,
)
from featurematching_tpu_torch.models.matcher import Matcher, MatcherOutput
from featurematching_tpu_torch.ops.sparse_focal_loss import sparse_focal_loss
from featurematching_tpu_torch.train.optimizer import Optimizer, build_optimizer

_BATCH_KEYS = ("image0", "image1", "gt_kp0", "gt_kp1", "gt_mask")


@dataclass
class TrainState:
    """The configuration, the model, its optimizer and the count of steps taken."""

    cfg: Config
    model: Matcher
    optimizer: Optimizer
    step: int = 0


def create_train_state(cfg: Config, device="cuda", seed: Optional[int] = None,
                       global_batch_size: Optional[int] = None) -> TrainState:
    """A seeded Matcher (`cfg.trainer.seed` unless `seed` is given) and its
    optimizer; the learning rate scales with `global_batch_size`
    (`cfg.trainer.batch_size` by default)."""
    model = Matcher(cfg.model, device=device, seed=cfg.trainer.seed if seed is None else seed)
    opt = build_optimizer(model.parameters(), cfg.trainer.optimizer,
                          global_batch_size or cfg.trainer.batch_size,
                          cfg.trainer.steps_per_epoch)
    return TrainState(cfg=cfg, model=model, optimizer=opt)


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(batch[k]).to(device) for k in _BATCH_KEYS}
    for k in ("image0", "image1"):
        if out[k].dtype == torch.uint8:
            out[k] = out[k].float() / 255.0
    return out


def forward_with_loss(model: Matcher, cfg: Config, batch: Dict, train: bool,
                      generator: Optional[torch.Generator] = None):
    """(LossOutput, MatcherOutput) of one batch."""
    dev = model.device
    b = _to_device(batch, dev)
    mcfg = cfg.model
    H, W = b["image0"].shape[1:3]
    sc = mcfg.resolution[0]
    grid = (H // sc, W // sc)
    lcfg = mcfg.loss
    use_sparse = lcfg.sparse_spvs and lcfg.coarse_type == "focal"
    sup = compute_supervision_coarse(b["gt_kp0"], b["gt_kp1"], b["gt_mask"], grid, grid, sc,
                                     dense=not use_sparse)
    gt_ids = (sup.spv_i_ids, sup.spv_j_ids, sup.spv_mask) if train else None
    out: MatcherOutput = model(b["image0"], b["image1"], train=train, gt_ids=gt_ids,
                               want_conf_matrix=not use_sparse, generator=generator)
    fid_i, fid_j, fid_mask = out.fine_ids
    gt0, gt1 = compute_supervision_fine(sup.fine_mtx_0, sup.fine_mtx_1, fid_i, fid_j)
    loss_c = None
    if use_sparse:
        inv_temp = 1.0 / (out.feat_c0.shape[-1] * mcfg.match_coarse.dsmax_temperature)
        loss_c = lcfg.pos_weight * sparse_focal_loss(
            out.feat_c0, out.feat_c1, sup.spv_i_ids, sup.spv_j_ids, sup.spv_mask, inv_temp,
            lcfg.focal_alpha, lcfg.focal_gamma)
    losses = total_loss(out.conf_matrix, sup.conf_matrix_gt, out.fine.mkpts0_f, out.fine.mkpts1_f,
                        gt0, gt1, fid_mask, lcfg, window=mcfg.fine.window_size,
                        loss_c_override=loss_c)
    return losses, out


def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None):
    """One update. Returns (state, metrics) with the scalar tensors loss,
    loss_c, loss_f and grad_norm (the global norm before the clip); the
    state's model and optimizer are updated in place. Drop-path draws from
    `generator`, else from the model's own."""
    model = state.model
    model.zero_grad(set_to_none=True)
    losses, _ = forward_with_loss(model, state.cfg, batch, train=True, generator=generator)
    losses.loss.backward()
    for p in model.parameters():  # a parameter off the loss's path has a zero gradient
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = state.optimizer.step()
    state.step += 1
    metrics = {"loss": losses.loss.detach(), "loss_c": losses.loss_c.detach(),
               "loss_f": losses.loss_f.detach(), "grad_norm": grad_norm}
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict):
    """(MatcherOutput, LossOutput) of the evaluation forward."""
    losses, out = forward_with_loss(state.model, state.cfg, batch, train=False)
    return out, losses
