"""Coarse-level dual-softmax matching with a fixed-size top-K list.

Port of `featurematching_tpu/matching/coarse.py` (CoarseMatches,
dual_softmax_confidence, border_mask_flat, extract_matches,
extract_matches_from_stats, ids_to_keypoints, coarse_match). The two
extractors select alike (`_select`): a mutual max lies at (i, argmax_j
conf[i, j]), so selection takes the row and column statistics alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from featurematching_tpu_torch.ops.dual_softmax import MatchStats, dual_softmax_match_stats


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


def dual_softmax_confidence(feat_c0: torch.Tensor, feat_c1: torch.Tensor,
                            temperature: float = 0.1) -> torch.Tensor:
    """conf [B, L, S] f32 = softmax_rows(sim) * softmax_cols(sim), sim =
    <f0, f1> / (C * T), at the JAX function's rounding points: the features
    in their dtype, their product accumulated in f32 (bf16 products are exact
    in f32), then divided by C * T; both softmaxes in f32. The conf matrix
    of the training loss and of the Matcher's dense matching.

    `ops/dual_softmax.dual_softmax_confidence`, K1's plain twin, rounds
    f0 * 1/(C * T) to f0's dtype before the product, as K1 does; in bf16 the
    two differ by about 1e-3."""
    C = feat_c0.shape[-1]
    sim = (feat_c0.float() @ feat_c1.float().transpose(1, 2)) / (C * temperature)
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def border_mask_flat(hc: int, wc: int, border: int, device=None) -> torch.Tensor:
    """[hc*wc] bool, False within `border` cells of any image edge."""
    ok = torch.ones(hc, wc, dtype=torch.bool, device=device)
    if border > 0:
        ok[:border] = False
        ok[hc - border:] = False
        ok[:, :border] = False
        ok[:, wc - border:] = False
    return ok.reshape(-1)


def _select(row_max: torch.Tensor, j_star: torch.Tensor, col_argmax: torch.Tensor,
            grid0: Tuple[int, int], grid1: Tuple[int, int], thr: float, border_rm: int,
            max_matches: int):
    """Mutual-NN, threshold and border gating on the row statistics (row_max,
    j_star: [B, L]) and the column argmax ([B, S]), then the top-K rows by
    confidence, padded to `max_matches` where L is smaller. Returns (i_ids,
    j_ids, mask, mconf), each [B, max_matches].

    The top-K is a stable descending sort, so equal scores keep the lower
    row id first, as jax.lax.top_k orders them; this fixes the ids of the
    zero-score padding slots too."""
    B, L = row_max.shape
    h0, w0 = grid0
    h1, w1 = grid1
    if h0 * w0 != L or h1 * w1 != col_argmax.shape[1]:
        raise ValueError("grid shapes do not match the statistics")
    dev = row_max.device
    j_star = j_star.long()
    rows = torch.arange(L, device=dev)[None]
    mutual = torch.gather(col_argmax.long(), 1, j_star) == rows
    ok0 = border_mask_flat(h0, w0, border_rm, dev)[None]
    ok1_j = border_mask_flat(h1, w1, border_rm, dev)[j_star]
    valid = mutual & (row_max > thr) & ok0 & ok1_j
    score = torch.where(valid, row_max, torch.zeros_like(row_max))
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


def extract_matches(
    conf: torch.Tensor,
    grid0: Tuple[int, int],
    grid1: Tuple[int, int],
    thr: float = 0.2,
    border_rm: int = 2,
    max_matches: int = 1024,
):
    """Mutual-NN matches from a confidence matrix conf [B, L, S]: its row
    and column argmaxes (the first index on ties, as jnp.argmax takes) and
    the row maxima, then `_select`. Returns (i_ids, j_ids, mask, mconf),
    each [B, max_matches], by descending confidence."""
    j_star = conf.argmax(dim=2)
    row_max = torch.gather(conf, 2, j_star[..., None])[..., 0]
    return _select(row_max, j_star, conf.argmax(dim=1), grid0, grid1, thr, border_rm,
                   max_matches)


def extract_matches_from_stats(
    stats: MatchStats,
    grid0: Tuple[int, int],
    grid1: Tuple[int, int],
    thr: float = 0.2,
    border_rm: int = 2,
    max_matches: int = 1024,
):
    """Mutual-NN matches from K1's row/column statistics (no [L, S]
    matrix), selected as `extract_matches` selects. Returns (i_ids, j_ids,
    mask, mconf), each [B, max_matches]."""
    return _select(stats.row_max, stats.row_argmax, stats.col_argmax, grid0, grid1, thr,
                   border_rm, max_matches)


def ids_to_keypoints(ids: torch.Tensor, wc: int, scale: float) -> torch.Tensor:
    """Flat coarse ids [B, K] -> (x, y) pixel coords [B, K, 2] (f32)."""
    x = (ids % wc).float() * scale
    y = torch.div(ids, wc, rounding_mode="floor").float() * scale
    return torch.stack([x, y], dim=-1)


def coarse_match(
    feat_c0: torch.Tensor,
    feat_c1: torch.Tensor,
    grid0: Tuple[int, int],
    grid1: Tuple[int, int],
    img_to_coarse_scale: float,
    thr: float = 0.2,
    border_rm: int = 2,
    temperature: float = 0.1,
    max_matches: int = 1024,
    conf: Optional[torch.Tensor] = None,
) -> Tuple[CoarseMatches, Optional[torch.Tensor]]:
    """The coarse stage's selection: (matches, conf). With a conf matrix
    (the dense loss's), the matches come from it and no K1 runs; without
    one, from K1's statistics of the features (`dual_softmax_match_stats`:
    the kernel on the card, its plain twin on the CPU), and conf comes back
    as None. Selection is not differentiated: the features are detached."""
    if conf is None:
        stats = dual_softmax_match_stats(feat_c0.detach(), feat_c1.detach(),
                                         temperature=temperature)
        i_ids, j_ids, mask, mconf = extract_matches_from_stats(
            stats, grid0, grid1, thr, border_rm, max_matches)
    else:
        i_ids, j_ids, mask, mconf = extract_matches(
            conf.detach(), grid0, grid1, thr, border_rm, max_matches)
    matches = CoarseMatches(
        i_ids=i_ids, j_ids=j_ids, mask=mask, mconf=mconf,
        mkpts0_c=ids_to_keypoints(i_ids, grid0[1], img_to_coarse_scale),
        mkpts1_c=ids_to_keypoints(j_ids, grid1[1], img_to_coarse_scale))
    return matches, conf
