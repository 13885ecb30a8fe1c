"""On-device robust essential-matrix estimation and pose recovery.

Port of `featurematching_tpu/geometry/ransac.py`. The JAX function solves
one pair and is `vmap`ped over a batch; here every function batches over the
leading dims in the tensors, so the pairs of a batch run in the same
launches. The steps are the JAX ones: H minimal samples drawn at once by
masked Gumbel top-k, Nistér 5-point (or 8-point) candidates, MSAC scoring of
every model on every point, a local optimisation of the top 32 models
(cheirality vote, Gauss-Newton on the Sampson error, a cheirality-gated
score), IRLS refits by the weighted 8-point, and a final Gauss-Newton
polish.

Two linear-algebra steps are computed in another form than the JAX SVDs,
because `torch.linalg.svd` checks its convergence on the host (a wait on
the device a call):
  * the weighted 8-point's null vector is the smallest eigenvector of AᵀA
    by inverse iteration on an LU factorisation (`lu_factor_ex`,
    `lu_solve`), the JAX code's last right-singular vector of AᵀA;
  * the essential frame of a 3x3 E (its left and right null vectors and the
    partial isometry between the planes orthogonal to them) comes in closed
    form: the null vectors as the leading singular pair of E's cofactor
    matrix (power iteration), the isometry as the polar factor of E's 2x2
    restriction, M + sign(det M) cof(M) over its norm. From it come the
    projection onto the essential manifold (singular values (s, s, 0), s
    their mean) and the decomposition R = ±Q[v]_x + t vᵀ, t = U[:, 2],
    which are U diag(s, s, 0) Vᵀ and U W Vᵀ, U Wᵀ Vᵀ of that SVD.
The Jacobian of the Sampson residual (`jax.jacfwd` in JAX) is written out.

Nothing here reads a value back to the host: every branch is a
`torch.where` gate, and solves are `_ex` calls without error checks whose
non-finite results are masked as the JAX code masks `jnp.linalg.solve`'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch

from featurematching_tpu_torch.geometry.epipolar import cross_product_matrix as _skew
from featurematching_tpu_torch.geometry.epipolar import sampson_distance
from featurematching_tpu_torch.geometry.five_point import five_point_candidates


class RansacResult(NamedTuple):
    E: torch.Tensor  # [..., 3, 3] best essential matrix
    R: torch.Tensor  # [..., 3, 3] recovered rotation
    t: torch.Tensor  # [..., 3] recovered unit translation
    inliers: torch.Tensor  # [..., N] bool
    num_inliers: torch.Tensor  # [...] int32
    valid: torch.Tensor  # [...] bool — enough points & a usable model found


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _normalize(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def _cofactor(E: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix [..., 3, 3]: its columns are the cross products of
    E's columns (c1 x c2, c2 x c0, c0 x c1)."""
    c0, c1, c2 = E[..., :, 0], E[..., :, 1], E[..., :, 2]
    return torch.stack([torch.cross(c1, c2, dim=-1), torch.cross(c2, c0, dim=-1),
                        torch.cross(c0, c1, dim=-1)], dim=-1)


def _plane_basis(n: torch.Tensor):
    """Unit vectors (a1, a2) with (a1, a2, n) right-handed, for unit n."""
    ax = torch.argmin(torch.abs(n), dim=-1, keepdim=True)
    e = torch.zeros_like(n).scatter_(-1, ax, 1.0)
    a1 = _normalize(torch.cross(n, e, dim=-1))
    return a1, torch.cross(n, a1, dim=-1)


def _essential_frame(E: torch.Tensor, iters: int = 3):
    """(Q, t, v, s) of E [..., 3, 3], in the terms of E's SVD U Σ Vᵀ with
    proper U, V: v = V[:, 2], t = U[:, 2], Q = U[:, :2] V[:, :2]ᵀ (the
    partial isometry of E's rank-2 part) and s = (σ1 + σ2) / 2.

    The null pair is the leading singular pair of cof(E) = U diag(σ2σ3,
    σ1σ3, σ1σ2) Vᵀ, by power iteration from its largest column (a ratio
    (σ3/σ2)^2 a step); Q is the polar factor of E restricted to the planes
    orthogonal to v and t: for a 2x2 M, M + sign(det M) cof(M) = (σ1 + σ2)
    times an orthogonal matrix."""
    C = _cofactor(E)
    j = torch.argmax(torch.sum(C * C, dim=-2), dim=-1)  # the largest column
    u = _normalize(torch.gather(C, -1, j[..., None, None].expand(*C.shape[:-1], 1))[..., 0])
    for _ in range(iters):
        v = _normalize(torch.einsum("...ji,...j->...i", C, u))  # Cᵀ u
        u = _normalize(torch.einsum("...ij,...j->...i", C, v))
    v = _normalize(torch.einsum("...ji,...j->...i", C, u))
    a1, a2 = _plane_basis(u)
    b1, b2 = _plane_basis(v)
    Eb1 = torch.einsum("...ij,...j->...i", E, b1)
    Eb2 = torch.einsum("...ij,...j->...i", E, b2)
    p, q = (a1 * Eb1).sum(-1), (a1 * Eb2).sum(-1)
    r, w = (a2 * Eb1).sum(-1), (a2 * Eb2).sum(-1)
    sgn = torch.where(p * w - q * r >= 0, 1.0, -1.0).to(E.dtype)
    N = torch.stack([p + sgn * w, q - sgn * r, r - sgn * q, w + sgn * p], -1)  # M + sgn cof(M)
    nf = torch.linalg.norm(N, dim=-1, keepdim=True)
    O = N * (math.sqrt(2.0) / (nf + 1e-30))  # orthogonal 2x2, row-major
    s = nf[..., 0] / (2.0 * math.sqrt(2.0))
    # Q = [a1 a2] O [b1 b2]ᵀ; its images of b1 and b2 are U[:, 0] and U[:, 1]
    u0 = O[..., 0, None] * a1 + O[..., 2, None] * a2
    u1 = O[..., 1, None] * a1 + O[..., 3, None] * a2
    Q = u0[..., :, None] * b1[..., None, :] + u1[..., :, None] * b2[..., None, :]
    t = torch.cross(u0, u1, dim=-1)  # U[:, 2] of a proper U
    return Q, t, v, s


def _smallest_eigvec(S: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """The eigenvector [..., n] of the smallest eigenvalue of a symmetric
    positive semi-definite S [..., n, n] (the last right-singular vector of
    S): inverse iteration on S + mu I, mu a 1e-6 of S's mean diagonal,
    started from the largest column of (S + mu I)^-1. A step shrinks the
    other directions by (l_min + mu) / (l + mu); ten steps take a ratio of
    0.3 between the two smallest eigenvalues to float32 rounding."""
    n = S.shape[-1]
    mu = 1e-6 * S.diagonal(dim1=-2, dim2=-1).mean(-1) + 1e-30
    LU, piv, _ = torch.linalg.lu_factor_ex(S + mu[..., None, None] * _eye(n, S),
                                           check_errors=False)
    X = torch.linalg.lu_solve(LU, piv, _eye(n, S).expand(S.shape))
    X = torch.where(torch.isfinite(X), X, torch.zeros_like(X))
    j = torch.argmax(torch.sum(X * X, dim=-2), dim=-1)
    x = _normalize(torch.gather(X, -1, j[..., None, None].expand(*X.shape[:-1], 1))[..., 0])
    for _ in range(iters):
        x = torch.linalg.lu_solve(LU, piv, x[..., None])[..., 0]
        x = _normalize(torch.where(torch.isfinite(x), x, torch.zeros_like(x)))
    return x


def _eight_point(pts0: torch.Tensor, pts1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point: pts [*, N, 2] normalized, w [*, N] -> E [*, 3, 3]:
    the null vector of the weighted [N, 9] epipolar system, projected onto
    the essential manifold (singular values (s, s, 0)), Frobenius-normalized."""
    x0, y0 = pts0[..., 0], pts0[..., 1]
    x1, y1 = pts1[..., 0], pts1[..., 1]
    ones = torch.ones_like(x0)
    # row: [x1x0, x1y0, x1, y1x0, y1y0, y1, x0, y0, 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], dim=-1)
    A = A * w[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)  # [*, 9, 9]
    e = _smallest_eigvec(AtA)
    E = e.reshape(e.shape[:-1] + (3, 3))
    Q, _, _, s = _essential_frame(E)
    E = s[..., None, None] * Q
    norm = torch.linalg.norm(E.flatten(-2), dim=-1)[..., None, None] + 1e-12
    return E / norm


def decompose_essential(E: torch.Tensor):
    """E [..., 3, 3] -> (R1, R2, t) candidate decompositions (Hartley-
    Zisserman): R1 = U W Vᵀ, R2 = U Wᵀ Vᵀ, t = U[:, 2] with proper U, V,
    from E's essential frame (R1 = Q[v]_x + t vᵀ, R2 = -Q[v]_x + t vᵀ)."""
    Q, t, v, _ = _essential_frame(E)
    QV = Q @ _skew(v)
    tv = t[..., :, None] * v[..., None, :]
    return QV + tv, tv - QV, t


def _depths_two_view(R: torch.Tensor, t: torch.Tensor, pts0: torch.Tensor, pts1: torch.Tensor):
    """Midpoint-style depths of triangulated points in both cameras.

    pts: [..., N, 2] normalized, R [..., 3, 3], t [..., 3]. Returns (z0, z1)
    each [..., N]: per point the closed-form 2x2 least squares of
    z1*x1 = z0*R x0 + t."""
    f0 = torch.cat([pts0, torch.ones_like(pts0[..., :1])], dim=-1)  # [..., N, 3]
    f1 = torch.cat([pts1, torch.ones_like(pts1[..., :1])], dim=-1)
    Rf0 = torch.einsum("...nj,...ij->...ni", f0, R)  # f0 @ R.T
    t = t[..., None, :]
    a = torch.sum(Rf0 * Rf0, -1)
    b = -torch.sum(Rf0 * f1, -1)
    c = torch.sum(f1 * f1, -1)
    d = -torch.sum(Rf0 * t, -1)
    e = torch.sum(f1 * t, -1)
    det = a * c - b * b
    z0 = (c * d - b * e) / (det + 1e-12)
    z1 = (a * e - b * d) / (det + 1e-12)
    return z0, z1


def recover_pose_from_essential(E: torch.Tensor, pts0: torch.Tensor, pts1: torch.Tensor,
                                weights: torch.Tensor):
    """Pick the (R, t) with the best cheirality vote among the 4
    decompositions (R1, t), (R1, -t), (R2, t), (R2, -t); the first of equal
    votes, as `jnp.argmax`. E [..., 3, 3], pts [..., N, 2] normalized,
    weights [..., N]. Returns (R [..., 3, 3], t [..., 3], votes [..., 4])."""
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2], dim=-3)  # [..., 4, 3, 3]
    cands_t = torch.stack([t, -t, t, -t], dim=-2)  # [..., 4, 3]
    z0, z1 = _depths_two_view(cands_R, cands_t, pts0[..., None, :, :], pts1[..., None, :, :])
    good = (z0 > 0) & (z1 > 0)  # [..., 4, N]
    votes = torch.sum(good * weights[..., None, :], dim=-1)
    best = torch.argmax(votes, dim=-1)
    R = torch.gather(cands_R, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))
    tt = torch.gather(cands_t, -2, best[..., None, None].expand(*best.shape, 1, 3))
    return R[..., 0, :, :], tt[..., 0, :], votes


def _sampson_residual(E, f0, f1):
    """Signed first-order geometric (Sampson) residual [..., N] and the parts
    it is formed from: (r, num, den, E f0, Eᵀ f1)."""
    Ex0 = torch.einsum("...ij,...nj->...ni", E, f0)
    Etx1 = torch.einsum("...ji,...nj->...ni", E, f1)
    num = torch.sum(f1 * Ex0, -1)
    den = torch.sqrt(Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2
                     + Etx1[..., 1] ** 2 + 1e-20)
    return num / den, num, den, Ex0, Etx1


def _so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues, Taylor-safe below |v|^2 = 1e-8 (the GN step's own form)."""
    th2 = torch.sum(v * v, -1)[..., None, None]
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    K = _skew(v)
    return _eye(3, v) + A * K + B * (K @ K)


def _tangent_basis(t: torch.Tensor):
    ex = torch.zeros_like(t)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(t)
    ey[..., 1] = 1.0
    e = torch.where(torch.abs(t[..., :1]) < 0.9, ex, ey)
    b1 = _normalize(torch.cross(t, e, dim=-1), 1e-12)
    return b1, torch.cross(t, b1, dim=-1)


def _apply_params(p: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    Rp = R @ _so3_exp(p[..., :3])
    b1, b2 = _tangent_basis(t)
    tp = t + b1 * p[..., 3:4] + b2 * p[..., 4:5]
    return Rp, _normalize(tp, 1e-12)


def refine_pose_sampson(
    R: torch.Tensor,
    t: torch.Tensor,
    pts0: torch.Tensor,
    pts1: torch.Tensor,
    weights: torch.Tensor,
    iters: int = 5,
):
    """Gauss-Newton on the essential manifold: minimize the weighted Sampson
    error over (R, t) with t on the unit sphere (5 DoF: R exp([p0:3]_x), t
    moved along its tangent basis and renormalized), a step kept only where
    the cost drops. R [..., 3, 3], t [..., 3], pts [..., N, 2], weights
    [..., N]. Returns (R, t).

    The Jacobian at p = 0 is written out: dE/dp_k = [t']_x R [e_k]_x for
    the rotation and [dt'_k]_x R for the translation (dt'_k the derivative
    of the normalized t + b_k p_k), and dr = (dnum - r dden) / den."""
    f0 = torch.cat([pts0, torch.ones_like(pts0[..., :1])], -1)
    f1 = torch.cat([pts1, torch.ones_like(pts1[..., :1])], -1)
    w = weights.to(pts0.dtype)
    gens = _skew(_eye(3, R))  # [e_k]_x, the rotation's generators
    eye5 = _eye(5, R)
    for _ in range(iters):
        nt = torch.linalg.norm(t, dim=-1, keepdim=True)
        tn = t / (nt + 1e-12)
        Tx = _skew(tn)
        E = Tx @ R
        r, num, den, Ex0, Etx1 = _sampson_residual(E, f0, f1)
        r = r * w
        # dE for the 5 parameters, [..., 5, 3, 3]
        dE_rot = E[..., None, :, :] @ gens  # [t']_x R [e_k]_x
        b1, b2 = _tangent_basis(t)
        db = torch.stack([b1, b2], dim=-2)  # [..., 2, 3]
        dt = (db / (nt[..., None] + 1e-12)
              - tn[..., None, :] * (db * t[..., None, :]).sum(-1, keepdim=True)
              / (nt[..., None] + 1e-12) ** 2)
        dE_t = _skew(dt) @ R[..., None, :, :]
        dE = torch.cat([dE_rot, dE_t], dim=-3)
        dEx0 = torch.einsum("...kij,...nj->...kni", dE, f0)
        dEtx1 = torch.einsum("...kji,...nj->...kni", dE, f1)
        dnum = torch.sum(f1[..., None, :, :] * dEx0, -1)  # [..., 5, N]
        dden = (Ex0[..., None, :, 0] * dEx0[..., 0] + Ex0[..., None, :, 1] * dEx0[..., 1]
                + Etx1[..., None, :, 0] * dEtx1[..., 0]
                + Etx1[..., None, :, 1] * dEtx1[..., 1]) / den[..., None, :]
        J = ((dnum - (num / den)[..., None, :] * dden) / den[..., None, :]
             * w[..., None, :]).transpose(-1, -2)  # [..., N, 5]
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye5
        Jtr = torch.einsum("...nk,...n->...k", J, r)
        delta = torch.linalg.solve_ex(JtJ, Jtr[..., None], check_errors=False)[0][..., 0]
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        Rn, tn_ = _apply_params(-delta, R, t)
        # accept only on cost decrease
        cost_old = torch.sum(r * r, -1)
        tnn = tn_ / (torch.linalg.norm(tn_, dim=-1, keepdim=True) + 1e-12)
        rn = _sampson_residual(_skew(tnn) @ Rn, f0, f1)[0] * w
        better = torch.sum(rn * rn, -1) < cost_old
        R = torch.where(better[..., None, None], Rn, R)
        t = torch.where(better[..., None], tn_, t)
    return R, t


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)) in float32 on the generator's
    device, U uniform in [tiny, 1) drawn from `generator`."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, ...] rows idx [B, K] -> [B, K, ...]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def essential_ransac_core(
    pts0: torch.Tensor,
    pts1: torch.Tensor,
    mask: torch.Tensor,
    gumbel: torch.Tensor,
    thresh: Union[float, torch.Tensor] = 1e-3,
    refine_iters: int = 2,
    solver: str = "5pt",
) -> RansacResult:
    """Fixed-shape essential-matrix RANSAC over a batch of pairs, given the
    sampling noise.

    pts0, pts1: [B, N, 2] normalized camera coords (padded); mask: [B, N];
    gumbel: [B, H, N] standard Gumbel noise (H hypotheses); thresh: the
    Sampson inlier threshold in normalized units, a float or [B]. A row
    whose coordinates are not finite counts as padding."""
    B, N = mask.shape
    dev, dt = pts0.device, pts0.dtype
    rows_ok = torch.isfinite(pts0).all(-1) & torch.isfinite(pts1).all(-1)
    mask = mask & rows_ok
    pts0 = torch.where(rows_ok[..., None], pts0, torch.zeros_like(pts0))
    pts1 = torch.where(rows_ok[..., None], pts1, torch.zeros_like(pts1))
    if isinstance(thresh, torch.Tensor):
        thr2 = (thresh * thresh).to(dt).reshape(-1, 1).expand(B, 1)
    else:
        thr2 = torch.full((B, 1), thresh * thresh, dtype=dt, device=dev)
    num_valid = torch.sum(mask.to(dt), -1)
    min_pts = 5 if solver == "5pt" else 8

    # --- sample minimal sets, valid-only via masked Gumbel top-k
    logits = torch.where(mask, 0.0, -torch.inf).to(gumbel.dtype)
    idx = torch.topk(gumbel + logits[:, None, :], min_pts, dim=-1).indices  # [B, H, m]
    H = idx.shape[1]
    b = torch.arange(B, device=dev)[:, None, None]
    sets0, sets1 = pts0[b, idx], pts1[b, idx]  # [B, H, m, 2]
    if solver == "5pt":
        E_cand, cand_ok = five_point_candidates(sets0, sets1)  # [B, H, 10, 3, 3]
        E_h = E_cand.reshape(B, H * 10, 3, 3)
        model_ok = cand_ok.reshape(B, H * 10)
    elif solver == "8pt":
        E_h = _eight_point(sets0, sets1, torch.ones(idx.shape, dtype=dt, device=dev))
        model_ok = torch.ones((B, H), dtype=torch.bool, device=dev)
    else:
        raise ValueError(f"unknown solver {solver!r}")

    # --- score all models on all points: [B, M, N]
    d = sampson_distance(pts0[:, None], pts1[:, None], E_h)
    t2 = thr2[..., None]
    inl = (d < t2) & mask[:, None, :] & model_ok[..., None]
    # MSAC-style truncated score
    score = torch.sum(torch.where(inl, 1.0 - d / t2, 0.0), dim=-1)
    score = torch.where(model_ok, score, -1.0)

    # LO-RANSAC: Sampson-GN-polish the top-K models and rescore with a
    # cheirality-gated MSAC score (at small N several essential matrices
    # explain all points epipolarly; only the depth vote separates them)
    K_LO = min(32, score.shape[1])
    top_idx = torch.topk(score, K_LO, dim=-1).indices  # [B, K]
    p0k, p1k = pts0[:, None], pts1[:, None]
    wk = _take(inl, top_idx).to(dt)  # [B, K, N]
    R0, t0, _ = recover_pose_from_essential(_take(E_h, top_idx), p0k, p1k, wk)
    R1, t1 = refine_pose_sampson(R0, t0, p0k, p1k, wk, iters=5)
    E1 = _skew(t1) @ R1
    E_pol = E1 / (torch.linalg.norm(E1.flatten(-2), dim=-1)[..., None, None] + 1e-12)
    d1 = sampson_distance(p0k, p1k, E_pol)
    z0, z1 = _depths_two_view(R1, t1, p0k, p1k)
    inl_pol = (d1 < t2) & mask[:, None, :] & (z0 > 0) & (z1 > 0)
    sc_pol = torch.sum(torch.where(inl_pol, 1.0 - d1 / t2, 0.0), dim=-1)  # [B, K]
    best_k = torch.argmax(sc_pol, dim=-1)[:, None]
    raw_best = torch.argmax(score, dim=-1)[:, None]
    # fall back to the raw argmax only if every polished model scored zero
    use_pol = torch.gather(sc_pol, 1, best_k)[:, 0] > 0.0
    E_best = torch.where(use_pol[:, None, None], _take(E_pol, best_k)[:, 0],
                         _take(E_h, raw_best)[:, 0])
    inliers = torch.where(use_pol[:, None], _take(inl_pol, best_k)[:, 0],
                          _take(inl, raw_best)[:, 0])

    # --- IRLS refit on inliers of the best model
    E_ref, inl_ref = E_best, inliers
    for _ in range(refine_iters):
        w = inl_ref.to(dt)
        enough = torch.sum(w, -1) >= 8
        E_new = torch.where(enough[:, None, None], _eight_point(pts0, pts1, w), E_ref)
        d_new = sampson_distance(pts0, pts1, E_new)
        E_ref, inl_ref = E_new, (d_new < thr2) & mask
    use_refined = torch.sum(inl_ref, -1) >= torch.sum(inliers, -1)
    E_final = torch.where(use_refined[:, None, None], E_ref, E_best)
    inliers_final = torch.where(use_refined[:, None], inl_ref, inliers)

    wf = inliers_final.to(dt)
    R, t, _ = recover_pose_from_essential(E_final, pts0, pts1, wf)
    # final manifold polish: GN on the weighted Sampson error over inliers
    R, t = refine_pose_sampson(R, t, pts0, pts1, wf, iters=5)
    E_gn = _skew(t) @ R
    E_gn = E_gn / (torch.linalg.norm(E_gn.flatten(-2), dim=-1)[..., None, None] + 1e-12)
    inl_gn = (sampson_distance(pts0, pts1, E_gn) < thr2) & mask
    use_gn = torch.sum(inl_gn, -1) >= torch.sum(inliers_final, -1)
    E_final = torch.where(use_gn[:, None, None], E_gn, E_final)
    inliers_final = torch.where(use_gn[:, None], inl_gn, inliers_final)
    num_inliers = torch.sum(inliers_final, -1).to(torch.int32)
    valid = (num_valid >= min_pts) & (num_inliers >= 5)
    return RansacResult(E=E_final, R=R, t=t, inliers=inliers_final,
                        num_inliers=num_inliers, valid=valid)


def estimate_essential_ransac(
    pts0: torch.Tensor,
    pts1: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator,
    thresh: Union[float, torch.Tensor] = 1e-3,
    num_hypotheses: int = 512,
    refine_iters: int = 2,
    solver: str = "5pt",
) -> RansacResult:
    """Fixed-shape essential-matrix RANSAC on normalized coordinates.

    pts0, pts1: [..., N, 2] normalized camera coords (padded); mask: [..., N];
    generator: draws the hypotheses' Gumbel noise [..., H, N] (a generator
    on the tensors' device); thresh: Sampson inlier threshold in normalized units
    (pixel_thr / focal), a float or a tensor of the leading shape;
    num_hypotheses: H; refine_iters: IRLS refit rounds; solver: '5pt'
    (Nistér) or '8pt'. Every leading index is one pair, solved in the same
    launches as the others."""
    lead, N = mask.shape[:-1], mask.shape[-1]
    flat = (math.prod(lead), N)
    g = gumbel_noise(generator, flat[:1] + (num_hypotheses, N))
    if isinstance(thresh, torch.Tensor):
        thresh = thresh.reshape(-1)
    res = essential_ransac_core(pts0.reshape(flat + (2,)), pts1.reshape(flat + (2,)),
                                mask.reshape(flat), g, thresh, refine_iters, solver)
    return RansacResult(*(x.reshape(lead + x.shape[1:]) for x in res))
