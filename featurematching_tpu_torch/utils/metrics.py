"""Evaluation metrics: epipolar precision, pose AUC, aggregation.

Port of `featurematching_tpu/utils/metrics.py`. The per-batch parts
(epipolar errors, RANSAC pose recovery and its errors) are batched tensors
on the device, with no read-back to the host; the dataset-level aggregation
(AUC and precision over all pairs) is host-side numpy, copied as it is.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np
import torch

from featurematching_tpu_torch.geometry.epipolar import (
    epipolar_errors_batch,
    normalize_keypoints,
)
from featurematching_tpu_torch.geometry.ransac import essential_ransac_core, gumbel_noise
from featurematching_tpu_torch.geometry.se3 import relative_pose_error


def compute_symmetrical_epipolar_errors(
    mkpts0: torch.Tensor,
    mkpts1: torch.Tensor,
    mask: torch.Tensor,
    T_0to1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
) -> torch.Tensor:
    """[B, K] squared symmetric epipolar errors of the keypoints (in float32);
    padding rows get +inf so they never count as precise."""
    errs = epipolar_errors_batch(mkpts0[..., :2].float(), mkpts1[..., :2].float(),
                                 T_0to1, K0, K1)
    return torch.where(mask, errs, torch.inf)


def pose_errors_from_noise(
    mkpts0: torch.Tensor,
    mkpts1: torch.Tensor,
    mask: torch.Tensor,
    T_0to1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
    gumbel: torch.Tensor,
    pixel_thr: float = 0.5,
) -> dict:
    """`compute_pose_errors` given the RANSAC sampling noise: gumbel [B, H,
    N] (H hypotheses a pair)."""
    p0 = normalize_keypoints(mkpts0[..., :2].float(), K0)
    p1 = normalize_keypoints(mkpts1[..., :2].float(), K1)
    focal = 0.5 * (K0[:, 0, 0] + K0[:, 1, 1])  # [B]
    res = essential_ransac_core(p0, p1, mask, gumbel, thresh=pixel_thr / focal)
    R_err, t_err = relative_pose_error(T_0to1, res.R, res.t)
    return {
        "R_errs": torch.where(res.valid, R_err, torch.inf),
        "t_errs": torch.where(res.valid, t_err, torch.inf),
        "num_inliers": res.num_inliers,
        "pose_valid": res.valid,
    }


def compute_pose_errors(
    mkpts0: torch.Tensor,
    mkpts1: torch.Tensor,
    mask: torch.Tensor,
    T_0to1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
    generator: torch.Generator,
    pixel_thr: float = 0.5,
    num_hypotheses: int = 512,
) -> dict:
    """Batched RANSAC pose and (R_err, t_err) per pair, on the device.

    The RANSAC threshold is pixel_thr / focal (the mean focal length of K0),
    in normalized units; `generator` (on the tensors' device) draws each
    pair's hypotheses. Returns a dict of [B] tensors: R_errs (degrees),
    t_errs (L2 of the translation difference), both inf where the pose is
    not valid; num_inliers; pose_valid."""
    B, N = mask.shape
    g = gumbel_noise(generator, (B, num_hypotheses, N))
    return pose_errors_from_noise(mkpts0, mkpts1, mask, T_0to1, K0, K1, g, pixel_thr)


def compute_pose_errors_from_head(T_0to1: torch.Tensor, T_0to1_pred: torch.Tensor) -> dict:
    """Pose errors from a learned pose head's prediction instead of RANSAC.
    Batched [B, 4, 4]."""
    R_err, t_err = relative_pose_error(
        T_0to1, T_0to1_pred[..., :3, :3], T_0to1_pred[..., :3, 3])
    return {"R_errs": R_err, "t_errs": t_err}


# ---------------------------------------------------------------------------
# host-side aggregation (numpy)
# ---------------------------------------------------------------------------

def error_auc(errors: Sequence[float], thresholds=(5, 10, 20)) -> Dict[str, float]:
    """AUC of the recall-vs-error curve at each threshold."""
    errors = [0.0] + sorted(float(e) for e in errors)
    recall = list(np.linspace(0, 1, len(errors)))
    aucs = {}
    for thr in thresholds:
        last_index = int(np.searchsorted(errors, thr))
        y = recall[:last_index] + [recall[last_index - 1]]
        x = errors[:last_index] + [thr]
        aucs[f"auc@{thr}"] = float(np.trapezoid(y, x) / thr)
    return aucs


def epidist_prec(
    errors_per_pair: Sequence[np.ndarray], thresholds=(5e-4,)
) -> Dict[str, float]:
    """Mean matching precision at epipolar thresholds."""
    out = {}
    for thr in thresholds:
        precs = []
        for errs in errors_per_pair:
            errs = np.asarray(errs)
            errs = errs[np.isfinite(errs)]
            precs.append(float(np.mean(errs < thr)) if errs.size else 0.0)
        out[f"prec@{thr:.0e}"] = float(np.mean(precs)) if precs else 0.0
    return out


def aggregate_metrics(
    metrics: Dict[str, List], epi_err_thr: float = 5e-4
) -> Dict[str, float]:
    """Dataset-level aggregation with identifier dedup.

    metrics keys: 'identifiers' (list of str), 'R_errs', 't_errs' (per pair),
    'epi_errs' (list of per-pair arrays).
    """
    unq_ids = OrderedDict(
        (iden, idx) for idx, iden in enumerate(metrics["identifiers"])
    )
    keep = list(unq_ids.values())

    pose_errors = np.maximum(
        np.asarray(metrics["R_errs"], dtype=np.float64),
        np.asarray(metrics["t_errs"], dtype=np.float64),
    )[keep]
    aucs = error_auc(pose_errors)
    precs = epidist_prec([metrics["epi_errs"][i] for i in keep], (epi_err_thr,))
    return {**aucs, **precs}
