"""The matcher's output record, shared by the serving forward and the
training Matcher.

Port of `featurematching_tpu/models/matcher.py · MatcherOutput` (same fields
and order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from featurematching_tpu_torch.matching.coarse import CoarseMatches
from featurematching_tpu_torch.matching.fine import FineMatches


class MatcherOutput(NamedTuple):
    coarse: CoarseMatches  # static top-K predicted matches
    fine: FineMatches  # refined keypoints at the ids used for the fine stage
    conf_matrix: Optional[torch.Tensor]  # [B, L, S] (None: never materialized)
    feat_c0: torch.Tensor  # [B, L, C] post-transformer coarse features
    feat_c1: torch.Tensor
    fine_ids: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (i, j, mask)
    T_0to1_pred: Optional[torch.Tensor] = None
    T_1to0_pred: Optional[torch.Tensor] = None
    quat_pred: Optional[torch.Tensor] = None
    trans_pred: Optional[torch.Tensor] = None
