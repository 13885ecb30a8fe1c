"""Epipolar geometry: essential matrices and point-to-epipolar-line distances.

Port of `featurematching_tpu/geometry/epipolar.py` (the same functions and
formulas), batched over leading dims, on the tensors' device.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_product_matrix(t: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    zeros = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -t[..., 2], t[..., 1]], -1),
            torch.stack([t[..., 2], zeros, -t[..., 0]], -1),
            torch.stack([-t[..., 1], t[..., 0], zeros], -1),
        ],
        dim=-2,
    )


def essential_from_pose(T_0to1: torch.Tensor) -> torch.Tensor:
    """E = [t]_x @ R from a relative transform [..., 4, 4]."""
    return cross_product_matrix(T_0to1[..., :3, 3]) @ T_0to1[..., :3, :3]


def normalize_keypoints(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel coords [..., N, 2] -> normalized camera coords, given K [..., 3, 3]."""
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    x = (kpts[..., 0] - cx) / fx
    y = (kpts[..., 1] - cy) / fy
    return torch.stack([x, y], dim=-1)


def _to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def symmetric_epipolar_distance(
    pts0: torch.Tensor,
    pts1: torch.Tensor,
    E: torch.Tensor,
    K0: Optional[torch.Tensor] = None,
    K1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Squared symmetric epipolar distance [..., N]. With K0/K1 the points are
    pixel coords and are normalized first; otherwise they are normalized
    camera coords already. Computed in float32."""
    if K0 is not None:
        pts0 = normalize_keypoints(pts0, K0)
    if K1 is not None:
        pts1 = normalize_keypoints(pts1, K1)
    p0 = _to_homogeneous(pts0).float()  # [..., N, 3]
    p1 = _to_homogeneous(pts1).float()
    Ep0 = torch.einsum("...nj,...ij->...ni", p0, E)  # p0 @ E.T
    p1Ep0 = torch.sum(p1 * Ep0, dim=-1)  # [..., N]
    Etp1 = torch.einsum("...ni,...ij->...nj", p1, E)  # p1 @ E
    return p1Ep0**2 * (
        1.0 / (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + 1e-12)
        + 1.0 / (Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2 + 1e-12)
    )


def sampson_distance(pts0: torch.Tensor, pts1: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance [..., N] on normalized coords
    (RANSAC's scoring function)."""
    p0 = _to_homogeneous(pts0)
    p1 = _to_homogeneous(pts1)
    Ep0 = torch.einsum("...nj,...ij->...ni", p0, E)
    Etp1 = torch.einsum("...ni,...ij->...nj", p1, E)
    p1Ep0 = torch.sum(p1 * Ep0, dim=-1)
    denom = Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2
    return p1Ep0**2 / (denom + 1e-12)


def epipolar_errors_batch(
    mkpts0: torch.Tensor,
    mkpts1: torch.Tensor,
    T_0to1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
) -> torch.Tensor:
    """Batched symmetric epipolar error for padded match lists: mkpts* [B, K, 2]
    pixel coords, T_0to1 [B, 4, 4], K* [B, 3, 3] -> [B, K]."""
    E = essential_from_pose(T_0to1)  # [B, 3, 3]
    return symmetric_epipolar_distance(mkpts0, mkpts1, E, K0, K1)
