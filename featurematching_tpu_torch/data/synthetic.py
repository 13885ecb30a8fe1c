"""Synthetic training batches: a warped-texture pair generator with exact
pseudo-GT correspondences and relative pose.

The port's own copy of `featurematching_tpu/data/synthetic.py` (numpy only,
the same function and the same draws for the same `numpy.random.Generator`),
for the tests and `chip_smoke.py`. It renders a random texture viewed by two
cameras with a small relative rotation and translation over a textured plane,
so the two images correspond by a homography, and samples that
correspondence into the fixed-size padded GT arrays the supervision
consumes.
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
) -> Dict[str, np.ndarray]:
    """Returns the batch consumed by `train.step` (all numpy, host-side):
    one textured plane seen by both cameras, so the pair is a homography.
    The JAX package's generator with its default `n_planes=1`."""
    H, W = image_size
    f = 0.8 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)

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
