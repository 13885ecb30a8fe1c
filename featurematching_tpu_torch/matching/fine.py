"""Fine-level window refinement: window gather + soft-argmax.

Port of `featurematching_tpu/matching/fine.py` (FineMatches,
window_center_offset, gather_fine_windows, normalized_grid,
spatial_expectation, window_heatmaps, fine_from_heatmaps, fine_soft_argmax).
The JAX package gives the window gather a custom VJP in XLA (no kernel);
here autograd differentiates the gather, which carries the gradient to the
fine map.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class FineMatches(NamedTuple):
    """mkpts*_f: [B, K, 3] = (x, y, std); coords*: [B, K, 2] normalized
    offsets in [-1, 1]; std*: [B, K]."""

    mkpts0_f: torch.Tensor
    mkpts1_f: torch.Tensor
    coords0: torch.Tensor
    coords1: torch.Tensor
    std0: torch.Tensor
    std1: torch.Tensor


def window_center_offset(window: int, stride: int) -> int:
    """Offset of a window's top-left tap from stride*id: F.unfold with
    padding W//2 - 1 (-2 for W = 7 at stride 4)."""
    return -(window // 2 - 1)


def gather_fine_windows(
    feat_f: torch.Tensor,
    ids: torch.Tensor,
    grid_c: Tuple[int, int],
    window: int,
    stride: int,
) -> torch.Tensor:
    """[W, W] windows of the fine map [B, Hf, Wf, C] at coarse ids [B, K]
    -> [B, K, W*W, C]; taps outside the image read zeros."""
    B, Hf, Wf, C = feat_f.shape
    K = ids.shape[1]
    wc = grid_c[1]
    off = window_center_offset(window, stride)
    y0 = torch.div(ids, wc, rounding_mode="floor") * stride + off  # [B, K]
    x0 = (ids % wc) * stride + off
    d = torch.arange(window, device=ids.device)
    ys = (y0[:, :, None] + d)[:, :, :, None]  # [B, K, W, 1]
    xs = (x0[:, :, None] + d)[:, :, None, :]  # [B, K, 1, W]
    inb = (ys >= 0) & (ys < Hf) & (xs >= 0) & (xs < Wf)  # [B, K, W, W]
    lin = ys.clamp(0, Hf - 1) * Wf + xs.clamp(0, Wf - 1)
    flat = feat_f.reshape(B, Hf * Wf, C)
    g = torch.gather(flat, 1, lin.reshape(B, -1, 1).expand(-1, -1, C))
    return (g * inb.reshape(B, -1, 1).to(g.dtype)).reshape(B, K, window * window, C)


def normalized_grid(window: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """[W*W, 2] (x, y) grid with coords in [-1, 1]; x varies along width."""
    line = torch.linspace(-1.0, 1.0, window, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(line, line, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def spatial_expectation(heatmap: torch.Tensor, window: int):
    """Soft-argmax expectation and std over the [-1, 1]^2 grid.

    heatmap: [..., W*W] (softmaxed) -> (coords [..., 2], std [...]), with
    std = sum over x, y of sqrt(var)."""
    grid = normalized_grid(window, heatmap.device, heatmap.dtype)
    coords = heatmap @ grid
    var = heatmap @ (grid * grid) - coords * coords
    std = torch.sqrt(var.clamp(min=1e-10)).sum(dim=-1)
    return coords, std


def window_heatmaps(centre: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """softmax over the taps of (centre . windows[r]) / sqrt(C) in f32.
    centre: [..., C], windows: [..., W*W, C] -> [..., W*W]."""
    C = windows.shape[-1]
    sim = torch.einsum("...c,...rc->...r", centre.float(), windows.float())
    return torch.softmax(sim * (1.0 / C**0.5), dim=-1)


def fine_from_heatmaps(
    heat0: torch.Tensor,
    heat1: torch.Tensor,
    mkpts0_c: torch.Tensor,
    mkpts1_c: torch.Tensor,
    window: int,
    img_to_fine_scale: float,
) -> FineMatches:
    """Heatmaps -> subpixel keypoints: the tail of fine_soft_argmax, also run
    on the heatmaps of the fine-stage kernel's fold mode.

    heat*: [B, K, W*W] softmaxed heatmaps; mkpts*_c: [B, K, 2]."""
    coords0, std0 = spatial_expectation(heat0, window)
    coords1, std1 = spatial_expectation(heat1, window)
    half = window // 2
    mkpts0_f = mkpts0_c + coords0 * (half * img_to_fine_scale) + half
    mkpts1_f = mkpts1_c + coords1 * (half * img_to_fine_scale) + half
    return FineMatches(
        mkpts0_f=torch.cat([mkpts0_f, std0[..., None]], dim=-1),
        mkpts1_f=torch.cat([mkpts1_f, std1[..., None]], dim=-1),
        coords0=coords0,
        coords1=coords1,
        std0=std0,
        std1=std1,
    )


def fine_soft_argmax(
    feat0_mixed: torch.Tensor,
    feat1_mixed: torch.Tensor,
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    mkpts0_c: torch.Tensor,
    mkpts1_c: torch.Tensor,
    window: int,
    img_to_fine_scale: float,
) -> FineMatches:
    """Center-vs-window correlation -> heatmaps -> subpixel keypoints.

    feat*_mixed: [B, K, C] per-window mixtures; feat*: [B, K, W*W, C] window
    features; mkpts*_c: [B, K, 2] coarse pixel coords."""
    return fine_from_heatmaps(
        window_heatmaps(feat0_mixed, feat1), window_heatmaps(feat1_mixed, feat0),
        mkpts0_c, mkpts1_c, window, img_to_fine_scale,
    )
