"""SE(3) / SO(3) utilities.

Port of `featurematching_tpu/geometry/se3.py` (the same functions, names and
formulas). Every function takes unbatched [..., 3] / [..., 3, 3] tensors and
broadcasts over the leading dims; branches are `torch.where` gates, so no
function reads a value back to the host.
"""

from __future__ import annotations

import torch


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def axis_angle_to_matrix(vec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle vector [..., 3] -> rotation matrix [..., 3, 3]
    (standard [rx, ry, rz] components, as the JAX function)."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)  # [..., 1]
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    row0 = torch.stack([x * xC + ca, xyC - zs, zxC + ys], dim=-1)
    row1 = torch.stack([xyC + zs, y * yC + ca, yzC - xs], dim=-1)
    row2 = torch.stack([zxC - ys, yzC + xs, z * zC + ca], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> euler angles [x, y, z] (XYZ extraction),
    with the gimbal-lock branch gated by `where`."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x_ns = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y_ns = torch.atan2(-R[..., 2, 0], sy)
    z_ns = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    x_s = torch.atan2(-R[..., 1, 2], R[..., 1, 1])
    z_s = torch.zeros_like(x_s)
    x = torch.where(singular, x_s, x_ns)
    z = torch.where(singular, z_s, z_ns)
    return torch.stack([x, y_ns, z], dim=-1)


def euler_zyx_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Euler [x, y, z] -> R = Rz @ Ry @ Rx (inverse of matrix_to_euler_zyx)."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    row0 = torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], -1)
    row1 = torch.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], -1)
    row2 = torch.stack([-sy, cy * sx, cy * cx], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (x, y, z, w — scipy order) -> R [..., 3, 3]."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3] -> unit quaternion [..., 4] (x, y, z, w), w >= 0.

    Branchless Shepperd's method: all four candidate constructions, the
    best-conditioned one selected by the largest of (tr, m00, m11, m22)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp_min(1.0 + tr, 0.0)) / 2
    s0 = 4 * qw0 + 1e-8
    cand0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, qw0], -1)

    qx1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)) / 2
    s1 = 4 * qx1 + 1e-8
    cand1 = torch.stack([qx1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)

    qy2 = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)) / 2
    s2 = 4 * qy2 + 1e-8
    cand2 = torch.stack([(m01 + m10) / s2, qy2, (m12 + m21) / s2, (m02 - m20) / s2], -1)

    qz3 = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)) / 2
    s3 = 4 * qz3 + 1e-8
    cand3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, qz3, (m10 - m01) / s3], -1)

    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    best = torch.argmax(scores, dim=-1)  # the first of equal scores, as jnp.argmax
    cands = torch.stack([cand0, cand1, cand2, cand3], dim=-2)  # [..., 4cand, 4]
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def transform_from_params(axisangle: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(axis-angle [..., 3], t [..., 3]) -> homogeneous T [..., 4, 4]."""
    R = axis_angle_to_matrix(axisangle)
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = translation
    T[..., 3, 3] = 1.0
    return T


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Invert a rigid transform [..., 4, 4] without a general solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def relative_pose_error(T_0to1: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """(R_err_deg, t_err) against the GT transform: t_err is the L2 norm of
    the translation difference (not an angle); R_err the geodesic angle in
    degrees."""
    t_err = torch.linalg.norm(T_0to1[..., :3, 3] - t, dim=-1)
    R_gt = T_0to1[..., :3, :3]
    RtRgt = torch.einsum("...ji,...jk->...ik", R, R_gt)  # R^T @ R_gt
    cos = (RtRgt.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    cos = torch.clamp(cos, -1.0, 1.0)
    R_err = torch.rad2deg(torch.abs(torch.arccos(cos)))
    return R_err, t_err


def angular_translation_error(T_0to1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Angle (deg) between estimated and GT translation directions, with the
    essential-matrix sign ambiguity handled (min(err, 180 - err))."""
    t_gt = T_0to1[..., :3, 3]
    n = torch.linalg.norm(t, dim=-1) * torch.linalg.norm(t_gt, dim=-1)
    cos = torch.sum(t * t_gt, dim=-1) / (n + 1e-10)
    t_err = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    return torch.minimum(t_err, 180.0 - t_err)


# ---------------------------------------------------------------------------
# Lie-group exp/log maps
# ---------------------------------------------------------------------------

def _hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zeros], -1),
        ],
        dim=-2,
    )


def _safe_theta(w: torch.Tensor):
    """(theta2, theta_safe, small) with the sqrt's input masked where small
    (below theta ~ 1e-2 the float32 (1 - cos) / theta^2 family cancels, and
    the theta2 Taylor series takes over)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    small = theta2 < 1e-4
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return theta2, theta, small


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3), Taylor-safe near zero."""
    theta2, theta, small = _safe_theta(w)
    W = _hat(w)
    W2 = W @ W
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye3(w) + A * W + B * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3), Taylor-safe near identity; theta from
    atan2(|skew| / 2, (tr - 1) / 2)."""
    w_skew = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    s2 = torch.sum(w_skew * w_skew, dim=-1, keepdim=True) / 4.0
    small = s2 < 1e-8
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    c = (R.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None] - 1.0) / 2.0
    theta = torch.where(small, torch.zeros_like(s), torch.atan2(s, c))
    factor = torch.where(small, 0.5 + s2 / 12.0, theta / (2.0 * s))
    return factor * w_skew


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) [..., 6] (v, w) -> T [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2, theta, small = _safe_theta(w)
    W = _hat(w)
    W2 = W @ W
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    V = _eye3(xi) + B * W + C * W2
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = torch.einsum("...ij,...j->...i", V, v)
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) -> se(3) [..., 6] (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2, theta, small = _safe_theta(w)
    W = _hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / theta2)
    Vinv = _eye3(T) - 0.5 * W + coef * W2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([v, w], dim=-1)

