"""Synthetic training batches: a warped-texture pair generator with exact
pseudo-GT correspondences and relative pose.

The port's own copy of `featurematching_tpu/data/synthetic.py` (numpy only,
the same functions and the same draws for the same `numpy.random.Generator`,
so the arrays are bit for bit the JAX package's), for the tests,
`chip_smoke.py` and `apps/evaluate`. It renders a random texture viewed by
two cameras with a small relative rotation and translation: over one
textured plane (a homography pair) or over two tilted planes at different
depths (`n_planes=2`, the non-degenerate scene for pose metrics), and
samples the correspondences into the fixed-size padded GT arrays the
supervision consumes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _homography_from_pose(K: np.ndarray, R: np.ndarray, t: np.ndarray, n: np.ndarray, d: float) -> np.ndarray:
    """Plane-induced homography H = K (R + t n^T / d) K^-1."""
    return K @ (R + np.outer(t, n) / d) @ np.linalg.inv(K)


def synthetic_batch(
    rng: np.random.Generator,
    batch_size: int = 2,
    image_size: Tuple[int, int] = (480, 640),  # (H, W)
    channels: int = 3,
    num_gt: int = 512,
    rot_scale: float = 0.03,
    trans_scale: float = 0.05,
    n_planes: int = 1,
) -> Dict[str, np.ndarray]:
    """Returns the batch pytree consumed by train.step (all numpy, host-side).

    n_planes=1: the original single textured plane (a pure homography pair —
    note this is exactly the planar-degenerate case for essential-matrix
    pose recovery, so pose AUC on such pairs is ill-conditioned BY DESIGN of
    the scene, for any estimator).
    n_planes=2: two tilted planes at different depths split by a random line,
    rendered with a per-pixel depth test and occlusion-verified GT — the
    parallax between the planes makes 5-point/RANSAC pose recovery
    well-conditioned (use for pose-metric evaluation fixtures).
    """
    H, W = image_size
    f = 0.8 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    if n_planes == 2:
        return _two_plane_batch(
            rng, batch_size, (H, W), channels, num_gt, rot_scale, trans_scale, K
        )
    assert n_planes == 1, n_planes

    images0 = np.empty((batch_size, H, W, channels), np.float32)
    images1 = np.empty((batch_size, H, W, channels), np.float32)
    gt_kp0 = np.zeros((batch_size, num_gt, 2), np.float32)
    gt_kp1 = np.zeros((batch_size, num_gt, 2), np.float32)
    gt_mask = np.zeros((batch_size, num_gt), bool)
    T_0to1 = np.zeros((batch_size, 4, 4), np.float32)
    T_1to0 = np.zeros((batch_size, 4, 4), np.float32)

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")

    for b in range(batch_size):
        # smooth random texture (sum of random sinusoids — cheap, detailed)
        base = np.zeros((H, W), np.float32)
        for _ in range(12):
            fx, fy = rng.uniform(0.01, 0.2, 2)
            ph = rng.uniform(0, 2 * np.pi)
            base += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        base = (base - base.min()) / (np.ptp(base) + 1e-6)

        # relative pose: small rotation + translation; plane at depth d
        w_rot = rng.standard_normal(3) * rot_scale
        angle = np.linalg.norm(w_rot)
        axis = w_rot / (angle + 1e-12)
        Kx = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        R = np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx
        t = rng.standard_normal(3) * trans_scale
        n = np.array([0.0, 0.0, 1.0])
        d = 1.0
        Hmg = _homography_from_pose(K, R, t, n, d)
        Hinv = np.linalg.inv(Hmg)

        # image1(x) = image0(Hinv x): warp by inverse map
        ones = np.ones_like(xx, np.float32)
        pts = np.stack([xx, yy, ones], axis=-1).reshape(-1, 3).T  # [3, HW]
        src = Hinv @ pts
        sx = (src[0] / src[2]).reshape(H, W)
        sy = (src[1] / src[2]).reshape(H, W)
        sxc = np.clip(sx, 0, W - 1)
        syc = np.clip(sy, 0, H - 1)
        x0i = sxc.astype(np.int32)
        y0i = syc.astype(np.int32)
        x1i = np.minimum(x0i + 1, W - 1)
        y1i = np.minimum(y0i + 1, H - 1)
        wx = sxc - x0i
        wy = syc - y0i
        warped = (
            base[y0i, x0i] * (1 - wx) * (1 - wy)
            + base[y0i, x1i] * wx * (1 - wy)
            + base[y1i, x0i] * (1 - wx) * wy
            + base[y1i, x1i] * wx * wy
        )

        img0 = np.repeat(base[..., None], channels, axis=-1)
        img1 = np.repeat(warped[..., None], channels, axis=-1)
        images0[b] = img0
        images1[b] = img1

        # GT correspondences: sample points, map through H, keep in-bounds
        margin = 16
        p0 = np.stack(
            [
                rng.uniform(margin, W - margin, 4 * num_gt),
                rng.uniform(margin, H - margin, 4 * num_gt),
            ],
            axis=-1,
        )
        p0h = np.concatenate([p0, np.ones((len(p0), 1))], axis=-1)
        p1h = (Hmg @ p0h.T).T
        p1 = p1h[:, :2] / p1h[:, 2:3]
        ok = (
            (p1[:, 0] > margin)
            & (p1[:, 0] < W - margin)
            & (p1[:, 1] > margin)
            & (p1[:, 1] < H - margin)
        )
        p0, p1 = p0[ok][:num_gt], p1[ok][:num_gt]
        n_ok = len(p0)
        gt_kp0[b, :n_ok] = p0
        gt_kp1[b, :n_ok] = p1
        gt_mask[b, :n_ok] = True

        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        T_0to1[b] = T
        Ti = np.eye(4, dtype=np.float32)
        Ti[:3, :3] = R.T
        Ti[:3, 3] = -R.T @ t
        T_1to0[b] = Ti

    Kb = np.broadcast_to(K, (batch_size, 3, 3)).copy()
    return {
        "image0": images0,
        "image1": images1,
        "gt_kp0": gt_kp0,
        "gt_kp1": gt_kp1,
        "gt_mask": gt_mask,
        "T_0to1": T_0to1,
        "T_1to0": T_1to0,
        "K0": Kb,
        "K1": Kb.copy(),
    }


def _bilinear(base: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """Bilinear sample of [H, W] base at float coords (clamped)."""
    H, W = base.shape
    sxc = np.clip(sx, 0, W - 1)
    syc = np.clip(sy, 0, H - 1)
    x0i = sxc.astype(np.int32)
    y0i = syc.astype(np.int32)
    x1i = np.minimum(x0i + 1, W - 1)
    y1i = np.minimum(y0i + 1, H - 1)
    wx = sxc - x0i
    wy = syc - y0i
    return (
        base[y0i, x0i] * (1 - wx) * (1 - wy)
        + base[y0i, x1i] * wx * (1 - wy)
        + base[y1i, x0i] * (1 - wx) * wy
        + base[y1i, x1i] * wx * wy
    )


def _two_plane_batch(rng, batch_size, hw, channels, num_gt, rot_scale, trans_scale, K):
    """Two textured planes at different depths: a non-degenerate scene for
    essential-matrix pose metrics (the parallax between the planes is what a
    single homography can never provide)."""
    H, W = hw
    Kinv = np.linalg.inv(K)

    images0 = np.empty((batch_size, H, W, channels), np.float32)
    images1 = np.empty((batch_size, H, W, channels), np.float32)
    gt_kp0 = np.zeros((batch_size, num_gt, 2), np.float32)
    gt_kp1 = np.zeros((batch_size, num_gt, 2), np.float32)
    gt_mask = np.zeros((batch_size, num_gt), bool)
    T_0to1 = np.zeros((batch_size, 4, 4), np.float32)
    T_1to0 = np.zeros((batch_size, 4, 4), np.float32)

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")

    for b in range(batch_size):
        base = np.zeros((H, W), np.float32)
        for _ in range(12):
            fx, fy = rng.uniform(0.01, 0.2, 2)
            ph = rng.uniform(0, 2 * np.pi)
            base += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        base = (base - base.min()) / (np.ptp(base) + 1e-6)

        w_rot = rng.standard_normal(3) * rot_scale
        angle = np.linalg.norm(w_rot)
        axis = w_rot / (angle + 1e-12)
        Kx = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        R = np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx
        t = rng.standard_normal(3) * trans_scale

        # two tilted planes (camera-0 frame: n . X = d), different depths
        tilts = rng.uniform(-0.3, 0.3, (2, 2))
        normals = [
            np.array([tilts[i, 0], tilts[i, 1], 1.0]) / np.linalg.norm([tilts[i, 0], tilts[i, 1], 1.0])
            for i in range(2)
        ]
        depths = [1.0, rng.uniform(1.4, 1.9)]
        Hs = [_homography_from_pose(K, R, t, normals[i], depths[i]) for i in range(2)]
        Hinvs = [np.linalg.inv(Hm) for Hm in Hs]

        # plane membership in image0: side of a random line near the center
        cx = W / 2 + rng.uniform(-W / 8, W / 8)
        cy = H / 2 + rng.uniform(-H / 8, H / 8)
        th = rng.uniform(0, np.pi)
        lv = np.array([np.cos(th), np.sin(th)])

        def plane_of(px, py):
            return ((px - cx) * lv[0] + (py - cy) * lv[1] < 0).astype(np.int32)

        # render image1 by inverse warp with a per-pixel depth test
        pts = np.stack([xx, yy, np.ones_like(xx, np.float32)], -1).reshape(-1, 3).T
        rays = Kinv @ pts  # [3, HW] cam-1 ray directions
        srcs, claims, ss = [], [], []
        for i in range(2):
            s = Hinvs[i] @ pts
            sx = (s[0] / s[2]).reshape(H, W)
            sy = (s[1] / s[2]).reshape(H, W)
            srcs.append((sx, sy))
            # plane i in cam-1 coords: n1 = R n, d1 = d + (R n) . t
            n1 = R @ normals[i]
            d1 = depths[i] + n1 @ t
            depth_along = (d1 / (n1 @ rays + 1e-12)).reshape(H, W)
            ss.append(np.where(depth_along > 0, depth_along, np.inf))
            claims.append((plane_of(sx, sy) == i) & (depth_along > 0))
        # both claim -> nearer surface; one claims -> it; none -> nearer
        nearer0 = ss[0] <= ss[1]
        choice = np.where(
            claims[0] & claims[1], np.where(nearer0, 0, 1),
            np.where(claims[0], 0, np.where(claims[1], 1, np.where(nearer0, 0, 1))),
        )
        warped = np.where(
            choice == 0,
            _bilinear(base, srcs[0][0], srcs[0][1]),
            _bilinear(base, srcs[1][0], srcs[1][1]),
        )
        images0[b] = np.repeat(base[..., None], channels, axis=-1)
        images1[b] = np.repeat(warped[..., None], channels, axis=-1)

        # GT: sample in image0, map through the OWN plane's homography, keep
        # points that are in-bounds AND visible (the rendered pixel chose the
        # same plane — occlusion/disocclusion rejected)
        margin = 16
        p0 = np.stack(
            [
                rng.uniform(margin, W - margin, 6 * num_gt),
                rng.uniform(margin, H - margin, 6 * num_gt),
            ],
            axis=-1,
        )
        pl = plane_of(p0[:, 0], p0[:, 1])
        p0h = np.concatenate([p0, np.ones((len(p0), 1))], axis=-1)
        p1 = np.empty_like(p0)
        for i in range(2):
            sel = pl == i
            ph1 = (Hs[i] @ p0h[sel].T).T
            p1[sel] = ph1[:, :2] / ph1[:, 2:3]
        ok = (
            (p1[:, 0] > margin)
            & (p1[:, 0] < W - margin)
            & (p1[:, 1] > margin)
            & (p1[:, 1] < H - margin)
        )
        vis = choice[
            np.clip(np.round(p1[:, 1]).astype(np.int32), 0, H - 1),
            np.clip(np.round(p1[:, 0]).astype(np.int32), 0, W - 1),
        ] == pl
        ok &= vis
        p0k, p1k = p0[ok][:num_gt], p1[ok][:num_gt]
        n_ok = len(p0k)
        gt_kp0[b, :n_ok] = p0k
        gt_kp1[b, :n_ok] = p1k
        gt_mask[b, :n_ok] = True

        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        T_0to1[b] = T
        Ti = np.eye(4, dtype=np.float32)
        Ti[:3, :3] = R.T
        Ti[:3, 3] = -R.T @ t
        T_1to0[b] = Ti

    Kb = np.broadcast_to(K, (batch_size, 3, 3)).copy()
    return {
        "image0": images0,
        "image1": images1,
        "gt_kp0": gt_kp0,
        "gt_kp1": gt_kp1,
        "gt_mask": gt_mask,
        "T_0to1": T_0to1,
        "T_1to0": T_1to0,
        "K0": Kb,
        "K1": Kb.copy(),
    }
