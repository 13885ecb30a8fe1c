"""Coarse-level mutual-NN match extraction with a fixed-size top-K list.

Port of `featurematching_tpu/matching/coarse.py` (CoarseMatches,
border_mask_flat, extract_matches_from_stats, ids_to_keypoints).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from featurematching_tpu_torch.ops.dual_softmax import MatchStats


class CoarseMatches(NamedTuple):
    """Static-capacity coarse match list.

    i_ids/j_ids: [B, K] flat coarse-grid indices into image0/image1 grids.
    mask: [B, K] validity (False = padding slot).
    mconf: [B, K] dual-softmax confidence (0 where invalid).
    mkpts0_c/mkpts1_c: [B, K, 2] (x, y) pixel coords at full resolution.
    """

    i_ids: torch.Tensor
    j_ids: torch.Tensor
    mask: torch.Tensor
    mconf: torch.Tensor
    mkpts0_c: torch.Tensor
    mkpts1_c: torch.Tensor


def border_mask_flat(hc: int, wc: int, border: int, device=None) -> torch.Tensor:
    """[hc*wc] bool, False within `border` cells of any image edge."""
    ok = torch.ones(hc, wc, dtype=torch.bool, device=device)
    if border > 0:
        ok[:border] = False
        ok[hc - border:] = False
        ok[:, :border] = False
        ok[:, wc - border:] = False
    return ok.reshape(-1)


def extract_matches_from_stats(
    stats: MatchStats,
    grid0: Tuple[int, int],
    grid1: Tuple[int, int],
    thr: float = 0.2,
    border_rm: int = 2,
    max_matches: int = 1024,
):
    """Mutual-NN, threshold and border gating on the row/col statistics,
    then the top-K rows by confidence. Returns (i_ids, j_ids, mask, mconf),
    each [B, K].

    The top-K is a stable descending sort, so equal scores keep the lower
    row id first, as jax.lax.top_k orders them; this fixes the ids of the
    zero-score padding slots too."""
    B, L = stats.row_max.shape
    h0, w0 = grid0
    h1, w1 = grid1
    if h0 * w0 != L or h1 * w1 != stats.col_max.shape[1]:
        raise ValueError("grid shapes do not match the statistics")
    dev = stats.row_max.device
    j_star = stats.row_argmax.long()
    rows = torch.arange(L, device=dev)[None]
    mutual = torch.gather(stats.col_argmax.long(), 1, j_star) == rows
    ok0 = border_mask_flat(h0, w0, border_rm, dev)[None]
    ok1_j = border_mask_flat(h1, w1, border_rm, dev)[j_star]
    valid = mutual & (stats.row_max > thr) & ok0 & ok1_j
    score = torch.where(valid, stats.row_max, torch.zeros_like(stats.row_max))
    k = min(max_matches, L)
    mconf, i_ids = torch.sort(score, dim=1, descending=True, stable=True)
    mconf, i_ids = mconf[:, :k], i_ids[:, :k]
    j_ids = torch.gather(j_star, 1, i_ids)
    mask = mconf > 0.0
    if k < max_matches:
        pad = (0, max_matches - k)
        mconf, i_ids, j_ids = F.pad(mconf, pad), F.pad(i_ids, pad), F.pad(j_ids, pad)
        mask = F.pad(mask, pad)
    return i_ids, j_ids, mask, mconf


def ids_to_keypoints(ids: torch.Tensor, wc: int, scale: float) -> torch.Tensor:
    """Flat coarse ids [B, K] -> (x, y) pixel coords [B, K, 2] (f32)."""
    x = (ids % wc).float() * scale
    y = torch.div(ids, wc, rounding_mode="floor").float() * scale
    return torch.stack([x, y], dim=-1)
