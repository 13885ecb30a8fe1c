"""Training supervision from padded pseudo-GT keypoint pairs.

Port of `featurematching_tpu/matching/supervision.py`. The batch carries
fixed-size padded arrays:

    gt_kp0, gt_kp1: [B, G, 2] full-resolution (x, y) pixel coords
    gt_mask:        [B, G]    validity (False = padding)

and supervision is a few fixed-shape scatters and gathers:
  * spv ids [B, G]: coarse cell indices that feed the fine stage
  * fine_mtx [B, L, 2]: per-coarse-cell target keypoint
  * conf_matrix_gt [B, L, S]: one-hot at (cell0, cell1), built only when the
    dense coarse loss needs it (`dense=True`): at 640x480, batch 4 it is
    368 MB, which eager PyTorch would allocate every step for nothing.

GT pairs are deduplicated to one per image-1 cell and one per image-0 cell,
keeping the first occurrence. `index_put_` with repeated indices writes in
no defined order, so the dedup also makes the fine_mtx scatter exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class CoarseSupervision(NamedTuple):
    conf_matrix_gt: Optional[torch.Tensor]  # [B, L, S] f32 0/1, or None
    spv_i_ids: torch.Tensor  # [B, G] int64
    spv_j_ids: torch.Tensor  # [B, G] int64
    spv_mask: torch.Tensor  # [B, G] bool
    fine_mtx_0: torch.Tensor  # [B, L, 2]
    fine_mtx_1: torch.Tensor  # [B, S, 2]


def _first_occurrence_mask(keys: torch.Tensor, valid: torch.Tensor,
                           num_cells: int) -> torch.Tensor:
    """[B, G] keys in [0, num_cells) -> mask keeping the first occurrence of
    each key among valid rows: a scatter-min of row positions into a
    [B, num_cells] buffer and one gather back."""
    B, G = keys.shape
    pos = torch.arange(G, device=keys.device).expand(B, G)
    p = torch.where(valid, pos, torch.full_like(pos, G))
    k = torch.where(valid, keys.long(), torch.zeros_like(keys, dtype=torch.long))
    buf = torch.full((B, num_cells), G, dtype=torch.long, device=keys.device)
    buf = buf.scatter_reduce(1, k, p, reduce="amin", include_self=True)
    return valid & (torch.gather(buf, 1, k) == pos)


def dedup_by_cells(cell_i: torch.Tensor, cell_j: torch.Tensor, valid: torch.Tensor,
                   num_cells_i: int, num_cells_j: int) -> torch.Tensor:
    """Keep one GT pair per image-1 cell and per image-0 cell (first occurrence)."""
    keep_j = _first_occurrence_mask(cell_j, valid, num_cells_j)
    keep_i = _first_occurrence_mask(cell_i, valid & keep_j, num_cells_i)
    return keep_i & keep_j & valid


def compute_supervision_coarse(
    gt_kp0: torch.Tensor,
    gt_kp1: torch.Tensor,
    gt_mask: torch.Tensor,
    grid0: Tuple[int, int],
    grid1: Tuple[int, int],
    coarse_scale: int = 8,
    dense: bool = False,
) -> CoarseSupervision:
    """Coarse and fine supervision targets. The ids of dropped rows (padding,
    out of the grid, duplicates) are 0 and their mask False."""
    B, G, _ = gt_kp0.shape
    h0, w0 = grid0
    h1, w1 = grid1
    L, S = h0 * w0, h1 * w1
    cell0 = torch.div(gt_kp0, coarse_scale, rounding_mode="floor").long()  # [B, G, 2] (x, y)
    cell1 = torch.div(gt_kp1, coarse_scale, rounding_mode="floor").long()
    i_ids = cell0[..., 0] + cell0[..., 1] * w0
    j_ids = cell1[..., 0] + cell1[..., 1] * w1
    in_grid = (i_ids >= 0) & (i_ids < L) & (j_ids >= 0) & (j_ids < S) & gt_mask.bool()
    keep = dedup_by_cells(i_ids, j_ids, in_grid, L, S)
    i_safe = torch.where(keep, i_ids, torch.zeros_like(i_ids))
    j_safe = torch.where(keep, j_ids, torch.zeros_like(j_ids))

    conf_gt = None
    if dense:
        flat = i_safe * S + j_safe
        conf_gt = torch.zeros(B, L * S, device=gt_kp0.device)
        conf_gt.scatter_reduce_(1, flat, keep.float(), reduce="amax")
        conf_gt = conf_gt.reshape(B, L, S)

    def targets(ids, kp, n):
        # after the dedup every kept id is unique, so the scatter is exact;
        # dropped rows write into a dump cell n, cut off after the scatter
        dst = torch.where(keep, ids, torch.full_like(ids, n))
        mtx = torch.zeros(B, n + 1, 2, device=kp.device)
        mtx.scatter_(1, dst[..., None].expand(-1, -1, 2), kp.float())
        return mtx[:, :n]

    return CoarseSupervision(
        conf_matrix_gt=conf_gt, spv_i_ids=i_safe, spv_j_ids=j_safe, spv_mask=keep,
        fine_mtx_0=targets(i_safe, gt_kp0, L), fine_mtx_1=targets(j_safe, gt_kp1, S),
    )


def compute_supervision_fine(fine_mtx_0: torch.Tensor, fine_mtx_1: torch.Tensor,
                             i_ids: torch.Tensor, j_ids: torch.Tensor):
    """The fine GT at the ids the fine stage used: ([B, G, 2], [B, G, 2])."""
    g0 = torch.gather(fine_mtx_0, 1, i_ids[..., None].expand(-1, -1, 2))
    g1 = torch.gather(fine_mtx_1, 1, j_ids[..., None].expand(-1, -1, 2))
    return g0, g1
