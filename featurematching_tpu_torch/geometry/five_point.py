"""Nistér 5-point minimal solver for the essential matrix, batched and of
fixed shape.

Port of `featurematching_tpu/geometry/five_point.py`: the same monomial
bases, constraint system, Gauss-Jordan reduction with one refinement step,
Nistér's 3x3 polynomial matrix B(z), a fixed 60-step Aberth (Durand-Kerner)
root finder in complex arithmetic, back-substitution, three Gauss-Newton
steps on the raw constraints and the same validity gates. The fixed-length
loops are Python loops of the same length; every [..., 10, 20] shape is
batched, not looped over.

The solver is split in two: `null_basis` (the 4-dim null space of the 5x9
epipolar system) and `candidates_from_basis` (everything after it), so that
the second can be held against the JAX solver on the JAX solver's own
basis. Any orthonormal basis of the null space gives the same set of
essential matrices (in another slot order); the port takes it from a
Householder QR of the system's transpose (`torch.geqrf`), whose batched
form on the card checks nothing on the host, where the JAX solver takes the
last right-singular vectors of an SVD.

Nothing here reads a value back to the host: solves are `solve_ex` without
error checks (a singular system gives non-finite entries, which the gates
mask, as `jnp.linalg.solve`'s NaNs are masked in JAX), and degenerate
samples give invalid slots (E = I, valid False), never an exception.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# monomial bases
# ---------------------------------------------------------------------------
# degree-1 basis for E(x, y, z) = xX + yY + zZ + W
_EXP1 = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))
# any fixed degree<=2 basis (intermediate products)
_EXP2 = (
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
)
# Nistér's degree<=3 column order: the first 10 are the leading monomials the
# Gauss-Jordan step eliminates; the last 10 split into x-, y- and 1-groups of
# polynomials in z
_EXP3 = (
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
    (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0),          # x z^2, x z, x
    (0, 1, 2), (0, 1, 1), (0, 1, 0),          # y z^2, y z, y
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),  # z^3, z^2, z, 1
)


def _mul_table(ea, eb, eo) -> np.ndarray:
    """[len(ea), len(eb), len(eo)] 0/1 tensor: product index map."""
    lookup = {e: k for k, e in enumerate(eo)}
    T = np.zeros((len(ea), len(eb), len(eo)), np.float32)
    for i, a in enumerate(ea):
        for j, b in enumerate(eb):
            s = tuple(x + y for x, y in zip(a, b))
            if s not in lookup:  # the product escapes the basis: never happens
                raise AssertionError(f"monomial {s} not in output basis")
            T[i, j, lookup[s]] = 1.0
    return T


def _conv_table(da: int, db: int) -> np.ndarray:
    """Univariate coefficient-convolution index map [da, db, da+db-1]."""
    T = np.zeros((da, db, da + db - 1), np.float32)
    for i in range(da):
        for j in range(db):
            T[i, j, i + j] = 1.0
    return T


_TABLES = {
    "T11": _mul_table(_EXP1, _EXP1, _EXP2),  # deg1*deg1 -> deg2
    "T21": _mul_table(_EXP2, _EXP1, _EXP3),  # deg2*deg1 -> deg3
    "T34": _conv_table(4, 5),  # deg3 * deg4 -> deg7
    "T33": _conv_table(4, 4),  # deg3 * deg3 -> deg6
    "T37": _conv_table(4, 8),  # deg3 * deg7 -> deg10
    "T56": _conv_table(5, 7),  # deg4 * deg6 -> deg10
    "EXP3": np.asarray(_EXP3, np.int64),  # [20, 3] exponents of the monomials
}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A constant table on `device`, copied there once (later calls find it
    there: no copy, no host wait on the solver's path)."""
    t = torch.from_numpy(_TABLES[name])
    return t.to(device=device, dtype=t.dtype if dtype is None else dtype)


def _tab(name: str, like: torch.Tensor) -> torch.Tensor:
    return _table(name, like.device, like.dtype)


def _pmul11(a, b):
    return torch.einsum("...i,...j,ijk->...k", a, b, _tab("T11", a))


def _pmul21(a, b):
    return torch.einsum("...i,...j,ijk->...k", a, b, _tab("T21", a))


def _zmul(a, b, name):
    return torch.einsum("...i,...j,ijk->...k", a, b, _tab(name, a))


# ---------------------------------------------------------------------------
# constraint system
# ---------------------------------------------------------------------------

def _epipolar_rows(pts0: torch.Tensor, pts1: torch.Tensor) -> torch.Tensor:
    """[..., N, 9] rows of the linear epipolar system (x1ᵀ E x0 = 0)."""
    x0, y0 = pts0[..., 0], pts0[..., 1]
    x1, y1 = pts1[..., 0], pts1[..., 1]
    ones = torch.ones_like(x0)
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], dim=-1)


def _constraint_matrix(Ep: torch.Tensor) -> torch.Tensor:
    """Ep: [..., 3, 3, 4] degree-1 coefficient tensor of E(x, y, z).
    Returns the [..., 10, 20] cubic-constraint coefficient matrix."""
    e = Ep  # e[..., i, j, :] is the deg-1 poly of E_ij

    def m11(i, j, k, l):
        return _pmul11(e[..., i, j, :], e[..., k, l, :])

    # det(E) = e00(e11 e22 - e12 e21) - e01(e10 e22 - e12 e20)
    #        + e02(e10 e21 - e11 e20)
    d0 = m11(1, 1, 2, 2) - m11(1, 2, 2, 1)
    d1 = m11(1, 0, 2, 2) - m11(1, 2, 2, 0)
    d2 = m11(1, 0, 2, 1) - m11(1, 1, 2, 0)
    det = (
        _pmul21(d0, e[..., 0, 0, :])
        - _pmul21(d1, e[..., 0, 1, :])
        + _pmul21(d2, e[..., 0, 2, :])
    )  # [..., 20]

    # EEᵀ (deg-2 entries) and the trace constraint
    EEt = [[sum(m11(i, k, j, k) for k in range(3)) for j in range(3)] for i in range(3)]
    tr = EEt[0][0] + EEt[1][1] + EEt[2][2]

    rows = [det]
    for i in range(3):
        for j in range(3):
            cij = sum(_pmul21(EEt[i][k], e[..., k, j, :]) for k in range(3))
            rows.append(cij - 0.5 * _pmul21(tr, e[..., i, j, :]))
    return torch.stack(rows, dim=-2)  # [..., 10, 20]


def _det_B(kx, ky, k1, lx, ly, l1, mx, my, m1) -> torch.Tensor:
    """det of the 3x3 polynomial matrix [[kx,ky,k1],[lx,ly,l1],[mx,my,m1]]
    where *x, *y have degree 3 (4 coeffs, ascending) and *1 degree 4 (5
    coeffs). Returns the degree-10 coefficient vector [..., 11] ascending."""
    t0 = _zmul(ly, m1, "T34") - _zmul(my, l1, "T34")  # [..., 8] deg7
    t1 = _zmul(lx, m1, "T34") - _zmul(mx, l1, "T34")
    t2 = _zmul(lx, my, "T33") - _zmul(mx, ly, "T33")  # [..., 7] deg6
    return _zmul(kx, t0, "T37") - _zmul(ky, t1, "T37") + _zmul(k1, t2, "T56")  # [..., 11]


# ---------------------------------------------------------------------------
# Durand-Kerner polynomial roots
# ---------------------------------------------------------------------------

def _durand_kerner(coeffs: torch.Tensor, iters: int = 60):
    """Roots of a degree-10 polynomial, batched (Aberth-Ehrlich iteration).

    coeffs: [..., 11] ASCENDING (c0 + c1 z + ... + c10 z^10).
    Returns (roots [..., 10] complex, ok [...] bool): ok is False when the
    leading coefficient collapses (a degenerate sample).

    The variable is rescaled by the Fujiwara root bound (z = Rb·u puts every
    root inside the unit disk), so the unit-circle start brackets the roots.
    p and p' are evaluated from the powers u^0..u^10 of each root estimate
    (one cumulative product), not by Horner's rule: the same sums in another
    order, in fewer launches.
    """
    c = coeffs
    scale = torch.amax(torch.abs(c), dim=-1, keepdim=True) + 1e-30
    c = c / scale
    lead = c[..., -1:]
    # gate ONLY true degree collapse (a small lead relative to max|c| is
    # normal for wide root spreads; the rescale restores conditioning)
    ok = torch.abs(lead[..., 0]) > 1e-25
    safe_lead = torch.where(torch.abs(lead) > 1e-25, lead, torch.ones_like(lead))
    monic = c / safe_lead  # [..., 11], last coeff 1

    deg = coeffs.shape[-1] - 1
    cdtype = torch.complex128 if coeffs.dtype == torch.float64 else torch.complex64
    dev = coeffs.device

    # Fujiwara bound: every root has |z| <= 2 max_k |c_{deg-k}|^{1/k} (monic)
    degs = torch.arange(deg, device=dev)
    Rb = 2.0 * torch.amax(
        torch.abs(monic[..., :-1]) ** (1.0 / (deg - degs)).to(monic.dtype),
        dim=-1, keepdim=True)
    Rb = torch.clamp_min(Rb, 1e-6)
    # substitute z = Rb*u; keep monic: c'_k = c_k * Rb^(k - deg) (all <= 1)
    powers = Rb ** torch.arange(-deg, 1, dtype=monic.dtype, device=dev)
    mc = (monic * powers).to(cdtype)
    ok = ok & torch.all(torch.isfinite(torch.abs(mc)), dim=-1)
    # p'(u) coefficients: k c'_k, ascending from u^0
    dmc = mc[..., 1:] * torch.arange(1, deg + 1, dtype=monic.dtype, device=dev)

    angles = 2.0 * torch.pi * torch.arange(deg, device=dev, dtype=torch.float32) / deg + 0.7
    base = torch.polar(torch.ones_like(angles), angles).to(cdtype)  # unit circle
    r = base.expand(coeffs.shape[:-1] + (deg,))
    eye = torch.eye(deg, dtype=cdtype, device=dev)
    mc, dmc = mc[..., None, :], dmc[..., None, :]  # broadcast over the 10 roots
    for _ in range(iters):
        zp = torch.cumprod(torch.cat(
            [torch.ones_like(r)[..., None], r[..., None].expand(*r.shape, deg)], -1), -1)
        pz = torch.sum(mc * zp, dim=-1)
        dpz = torch.sum(dmc * zp[..., :-1], dim=-1)
        w = pz / (dpz + 1e-20)  # Newton correction
        diff = r[..., :, None] - r[..., None, :]
        s = torch.sum(1.0 / (diff + eye), dim=-1) - 1.0  # sum_{j!=k} 1/(rk-rj)
        r = r - w / (1.0 - w * s + 1e-20)
    return r * Rb.to(cdtype), ok


def _monomials_and_grad(x, y, z):
    """Evaluate the 20 degree<=3 monomials (order _EXP3) and their gradient.

    x, y, z: [...]; returns (m [..., 20], dm [..., 20, 3])."""
    ex = _table("EXP3", x.device, None)  # [20, 3] exponents
    cols, grads = [], []
    for i, v in enumerate((x, y, z)):
        vp = torch.stack([torch.ones_like(v), v, v * v, v * v * v], dim=-1)  # v^0..v^3
        e = ex[:, i]
        cols.append(vp[..., e])
        grads.append(vp[..., torch.clamp_min(e - 1, 0)] * e.to(v.dtype))
    X, Y, Z = cols
    gX, gY, gZ = grads
    return X * Y * Z, torch.stack([gX * Y * Z, X * gY * Z, X * Y * gZ], dim=-1)


def _polish_xyz(M, x, y, z, iters: int = 3):
    """Gauss-Newton refinement of candidate (x, y, z) on the RAW constraint
    system M (10 cubic residuals, [..., 10, 20]): the Gauss-Jordan reduction
    amplifies float32 rounding by the system's condition number, M itself
    only carries elementwise rounding. x, y, z: [..., 10] candidates."""
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        m, dm = _monomials_and_grad(x, y, z)  # [..., 10, 20], [..., 10, 20, 3]
        r = torch.einsum("...ik,...rk->...ri", M, m)  # [..., 10cand, 10res]
        J = torch.einsum("...ik,...rkc->...ric", M, dm)  # [..., 10, 10, 3]
        JtJ = torch.einsum("...ric,...rid->...rcd", J, J) + 1e-10 * eye3
        Jtr = torch.einsum("...ric,...ri->...rc", J, r)
        delta = torch.linalg.solve_ex(JtJ, Jtr[..., None], check_errors=False)[0][..., 0]
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        x, y, z = x - delta[..., 0], y - delta[..., 1], z - delta[..., 2]
    return x, y, z


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def null_basis(A: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis [..., 4, 9] (rows X, Y, Z, W) of the null space
    of the finite [..., 5, 9] epipolar system: Householder QR of Aᵀ, the last
    4 columns of Q, formed by applying the 5 reflectors to the last 4 unit
    vectors."""
    n, k = A.shape[-1], A.shape[-2]  # 9, 5
    qr, tau = torch.geqrf(A.transpose(-1, -2).contiguous())  # [..., 9, 5], [..., 5]
    V = torch.tril(qr, -1) + torch.eye(n, k, dtype=A.dtype, device=A.device)  # v_i[i] = 1
    X = torch.eye(n, dtype=A.dtype, device=A.device)[:, k:].expand(*A.shape[:-2], n, n - k)
    for i in range(k - 1, -1, -1):  # Q e = H_0 (H_1 (... H_4 e))
        v = V[..., :, i:i + 1]
        X = X - tau[..., i, None, None] * (v @ (v.transpose(-1, -2) @ X))
    return X.transpose(-1, -2)


def candidates_from_basis(A: torch.Tensor, basis: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 5-point solver after the null basis: A [..., 5, 9] the sample's
    epipolar rows, basis [..., 4, 9] (X, Y, Z, W). Returns E [..., 10, 3, 3]
    (Frobenius-normalized; invalid slots are identity) and valid [..., 10]."""
    # E(x,y,z) coefficients: [..., 3, 3, 4]
    Ep = torch.movedim(basis.reshape(basis.shape[:-2] + (4, 3, 3)), -3, -1)

    M = _constraint_matrix(Ep)  # [..., 10, 20]
    # row equilibration: the det row and trace rows have different scales
    M = M / (torch.linalg.norm(M, dim=-1, keepdim=True) + 1e-30)
    M1 = M[..., :, :10]
    M2 = M[..., :, 10:]
    # Gauss-Jordan: the 10 leading monomials via the 10 tail columns, with
    # a Tikhonov jitter on M1 and one step of iterative refinement
    eye10 = torch.eye(10, dtype=M.dtype, device=M.device)
    M1j = M1 + 1e-12 * eye10
    R = torch.linalg.solve_ex(M1j, M2, check_errors=False)[0]  # [..., 10, 10]
    R = R + torch.linalg.solve_ex(M1j, M2 - M1 @ R, check_errors=False)[0]
    finite = torch.isfinite(R).all(dim=-1).all(dim=-1)
    R = torch.where(finite[..., None, None], R, torch.zeros_like(R))

    # rows: 4 = <e> (x^2 z), 5 = <f> (x^2), 6 = <g> (y^2 z), 7 = <h> (y^2),
    #       8 = <i> (xyz),   9 = <j> (xy).  Tail columns (ascending groups):
    #       [x z^2, x z, x | y z^2, y z, y | z^3, z^2, z, 1]
    def split(row):
        # ascending-degree coeff vectors: x-group deg<=2, y-group deg<=2,
        # 1-group deg<=3
        return row[..., 0:3].flip(-1), row[..., 3:6].flip(-1), row[..., 6:10].flip(-1)

    def nister_row(r_hi, r_lo):
        """<hi> - z * <lo>: leading monomials cancel; returns the x/y/1-group
        z-polynomials (deg 3, 3, 4 — ascending coeffs of size 4, 4, 5)."""
        zero = torch.zeros_like(r_hi[..., :1])
        return tuple(torch.cat([h, zero], -1) - torch.cat([zero, lo], -1)
                     for h, lo in zip(split(r_hi), split(r_lo)))

    kx, ky, k1 = nister_row(R[..., 4, :], R[..., 5, :])
    lx, ly, l1 = nister_row(R[..., 6, :], R[..., 7, :])
    mx, my, m1 = nister_row(R[..., 8, :], R[..., 9, :])

    n = _det_B(kx, ky, k1, lx, ly, l1, mx, my, m1)  # [..., 11] ascending
    roots, lead_ok = _durand_kerner(n)

    # real roots only; float32 roots carry more imaginary noise — gate
    # loosely there and let RANSAC scoring reject bad models
    im_tol = 1e-3 if A.dtype == torch.float64 else 2e-2
    z = roots.real
    real_ok = torch.abs(roots.imag) < im_tol * (1.0 + torch.abs(z))  # [..., 10]

    # back-substitute x(z), y(z): B(z) [x, y, 1]^T = 0, from the largest of
    # the three row-pair cross products. The nine polynomials by Horner's
    # rule at once, each padded to 5 ascending coefficients (a leading zero
    # coefficient leaves Horner's sums as they are)
    def pad5(c):
        return torch.cat([c, torch.zeros_like(c[..., : 5 - c.shape[-1]])], -1)

    C = torch.stack([pad5(c) for c in (kx, ky, k1, lx, ly, l1, mx, my, m1)], -2)  # [..., 9, 5]
    zz = z[..., None, :]  # [..., 1, 10]
    P = torch.zeros(C.shape[:-1] + z.shape[-1:], dtype=z.dtype, device=z.device)
    for k in range(4, -1, -1):
        P = P * zz + C[..., k:k + 1]
    rows = [(P[..., 3 * i, :], P[..., 3 * i + 1, :], P[..., 3 * i + 2, :]) for i in range(3)]

    def cross2(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    cands = [cross2(rows[0], rows[1]), cross2(rows[0], rows[2]), cross2(rows[1], rows[2])]
    norms = torch.stack([c[0] ** 2 + c[1] ** 2 + c[2] ** 2 for c in cands], dim=-1)
    pick = torch.argmax(norms, dim=-1)[..., None]  # [..., 10, 1]
    v = [torch.gather(torch.stack([c[i] for c in cands], -1), -1, pick)[..., 0]
         for i in range(3)]
    denom_ok = torch.abs(v[2]) > 1e-12
    safe = torch.where(denom_ok, v[2], torch.ones_like(v[2]))
    x = v[0] / safe
    y = v[1] / safe

    # Gauss-Newton polish on the raw constraints
    x, y, z = _polish_xyz(M, x, y, z)

    # E = x X + y Y + z Z + W  -> [..., 10, 3, 3]
    coeff = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)  # [..., 10, 4]
    E = torch.einsum("...rc,...ijc->...rij", coeff, Ep)
    fro = torch.linalg.norm(E.flatten(-2), dim=-1)[..., None, None]
    E = E / (fro + 1e-12)

    # validity: real root, well-conditioned back-substitution, finite E, and
    # the sample's epipolar residual actually near zero (catches bad GJ)
    resid = torch.einsum("...nk,...rk->...rn", A, E.flatten(-2))
    resid_tol = 1e-3 if A.dtype == torch.float64 else 2e-2
    resid_ok = torch.amax(torch.abs(resid), dim=-1) < resid_tol
    valid = (real_ok & denom_ok & lead_ok[..., None] & finite[..., None]
             & torch.isfinite(E).all(dim=-1).all(dim=-1) & resid_ok)
    eye3 = torch.eye(3, dtype=E.dtype, device=E.device)
    return torch.where(valid[..., None, None], E, eye3), valid


def five_point_candidates(pts0: torch.Tensor, pts1: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nistér 5-point solver on minimal samples (batched over leading dims).

    pts0, pts1: [..., 5, 2] normalized camera coordinates. Returns E [..., 10,
    3, 3] candidate essential matrices (Frobenius-normalized; invalid slots
    are identity) and valid [..., 10]."""
    A = _epipolar_rows(pts0, pts1)  # [..., 5, 9]
    # a non-finite sample is solved as zeros; its slots come out invalid
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    A = torch.where(finite[..., None, None], A, torch.zeros_like(A))
    E, valid = candidates_from_basis(A, null_basis(A))
    valid = valid & finite[..., None]
    eye3 = torch.eye(3, dtype=E.dtype, device=E.device)
    return torch.where(valid[..., None, None], E, eye3), valid
