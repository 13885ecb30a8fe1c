"""Sparse dual-softmax focal loss without the [L, S] confidence matrix
(kernel K7 and its forward).

Port of `featurematching_tpu/ops/sparse_focal_loss.py` (sparse_focal_loss
with its custom VJP, _per_pair_loss_and_grad, naive_sparse_focal_loss). The
loss needs the confidence only at the GT pairs:

    log conf[i, j] = 2 sim[i, j] - lse_row(i) - lse_col(j),  sim = f0 f1ᵀ inv_temp

forward: the row and column log-sum-exps from K1's pass 1
    (`ops/dual_softmax.dual_softmax_lse`, inv_temp folded into f0 in its
    dtype first) and sim gathered at the G pairs;
backward: dsim = 2 g (at the GT pairs) - a_r softmax_row - a_c softmax_col,
    with a_r / a_c the per-row / per-column sums of the pairs' upstream
    gradients. The dense part, df0 = dsim f1 and df1 = dsimᵀ f0s over tiles
    of sim recomputed from the pre-scaled f0s, is `csrc/sparse_focal_loss.cu`
    on the card (`sparse_focal_backward`, one persistent launch for both
    passes on the grid `plan` gives); the sparse direct term and the
    a_r / a_c scatter-adds are `index_add_`, as they are XLA in the JAX
    package. Each tile rounds dsim to the features' dtype before both
    products; df0 is scaled by inv_temp afterwards.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_lse

_ARGTYPES = [_build.PTR] * 6 + [_build.FLOAT] + [_build.INT] * 5 + [_build.PTR] * 8
UNIT_ROWS = 128  # owned rows of a work unit (two warpgroups of 64)
TILE = 64        # rows of the other side a step


class Plan(NamedTuple):
    """The kernel's work: pass p (0: df0 over rows of f0, 1: df1 over rows of
    f1) has B x row_blocks[p] units of steps[p] steps, one 64-row tile of the
    other side a step; the `total` steps, pass 0's units then pass 1's, are
    cut into `grid` equal ranges, one a block."""

    grid: int
    total: int
    row_blocks: Tuple[int, int]
    steps: Tuple[int, int]


class Piece(NamedTuple):
    """A block's run of one unit: tiles [tile0, tile1) of unit (pass, image,
    row_block); `owner` where it holds the unit's first tile (the block that
    adds the other pieces' partials and writes the unit's rows)."""

    pass_: int
    image: int
    row_block: int
    tile0: int
    tile1: int
    owner: bool


def plan(B: int, L: int, S: int, sms: int, per_sm: int) -> Plan:
    """The grid `csrc/sparse_focal_loss.cu` runs for [B, L, C] x [B, S, C]:
    as many blocks as the card holds at once (`sms` x `per_sm`, so that a
    unit's owner can wait for its other pieces), or one a step where the
    steps are fewer."""
    rows = (-(-L // UNIT_ROWS), -(-S // UNIT_ROWS))
    steps = (-(-S // TILE), -(-L // TILE))
    total = B * (rows[0] * steps[0] + rows[1] * steps[1])
    return Plan(max(1, min(total, sms * per_sm)), total, rows, steps)


def block_range(p: Plan, k: int) -> Tuple[int, int]:
    """Block k's steps [first, end), as the kernel's `range_start` cuts them:
    total // grid steps a block, one more for the first total % grid."""
    q, r = divmod(p.total, p.grid)
    return k * q + min(k, r), (k + 1) * q + min(k + 1, r)


def pieces(B: int, p: Plan) -> List[List[Piece]]:
    """Each block's pieces in the order it takes them (the kernel's
    `decode` over its range)."""
    first1 = B * p.row_blocks[0] * p.steps[0]
    out = []
    for k in range(p.grid):
        x, end = block_range(p, k)
        run = []
        while x < end:
            ps = int(x >= first1)
            unit, jt = divmod(x - ps * first1, p.steps[ps])
            b, rb = divmod(unit, p.row_blocks[ps])
            stop = min(end, x - jt + p.steps[ps])
            run.append(Piece(ps, b, rb, jt, jt + stop - x, jt == 0))
            x = stop
        out.append(run)
    return out


@functools.lru_cache(maxsize=None)
def _capacity(C: int, device: int) -> Tuple[int, int]:
    """(SMs, resident blocks an SM) of the kernel at width C on the card."""
    n = ctypes.c_int()
    with torch.cuda.device(device):
        _build.launch("sparse_focal_loss", "fm_sparse_focal_blocks_per_sm",
                      [_build.INT, _build.PTR], C, ctypes.addressof(n))
    return torch.cuda.get_device_properties(device).multi_processor_count, n.value


def per_pair_loss_and_grad(logc: torch.Tensor, alpha: float, gamma: float):
    """focal(logc) and d focal / d logc for conf = clip(exp(logc), 1e-6,
    1 - 1e-6); clipped pairs get zero gradient."""
    raw = torch.exp(logc)
    in_range = (raw > 1e-6) & (raw < 1.0 - 1e-6)
    conf = raw.clamp(1e-6, 1.0 - 1e-6)
    one_m = 1.0 - conf
    loss = -alpha * one_m**gamma * torch.log(conf)
    dconf = alpha * gamma * one_m ** (gamma - 1.0) * torch.log(conf) - alpha * one_m**gamma / conf
    return loss, torch.where(in_range, dconf * conf, torch.zeros_like(conf))


def sparse_focal_backward_reference(f0, f1, a_r, lse_r, a_c, lse_c, inv_temp: float):
    """Plain version of the kernel: (df0 [B, L, C], df1 [B, S, C]) f32 for
    the softmax terms, through the whole [L, S] sim."""
    f0s = (f0.float() * inv_temp).to(f0.dtype)
    sim = f0s.float() @ f1.float().transpose(1, 2)
    p_row = torch.exp(sim - lse_r[..., None])
    p_col = torch.exp(sim - lse_c[:, None, :])
    dsim = (-(a_r[..., None] * p_row + a_c[:, None, :] * p_col)).to(f0.dtype).float()
    return (dsim @ f1.float()) * inv_temp, dsim.transpose(1, 2) @ f0s.float()


def sparse_focal_backward(f0, f1, a_r, lse_r, a_c, lse_c, inv_temp: float):
    """The softmax terms of the backward: (df0, df1) f32. f0 [B, L, C],
    f1 [B, S, C]; a_r, lse_r [B, L]; a_c, lse_c [B, S] f32."""
    B, L, C = f0.shape
    S = f1.shape[1]
    if f0.device.type == "cpu":
        return sparse_focal_backward_reference(f0, f1, a_r, lse_r, a_c, lse_c, inv_temp)
    if C not in (64, 128, 256):
        raise ValueError(f"sparse_focal_backward kernel takes C in (64, 128, 256), got {C}")
    _build.check_cuda(f0, "f0", torch.bfloat16)
    _build.check_cuda(f1, "f1", torch.bfloat16, (B, S, C))
    vecs = [_build.f32(t) for t in (a_r, lse_r, a_c, lse_c)]
    for t, n in zip(vecs, (L, L, S, S)):
        _build.check_cuda(t, "row/column vector", torch.float32, (B, n))
    p = plan(B, L, S, *_capacity(C, f0.device.index or 0))
    f32 = dict(device=f0.device, dtype=torch.float32)
    df0, df1 = torch.empty(B, L, C, **f32), torch.empty(B, S, C, **f32)
    # scratch: f0 * inv_temp in bf16; each side's (-a, -lse log2 e) padded to
    # whole tiles; the partials of pieces cut from their units, and their flags
    f0s = torch.empty_like(f0)
    v0 = torch.empty(B, -(-L // TILE) * TILE, 2, **f32)
    v1 = torch.empty(B, -(-S // TILE) * TILE, 2, **f32)
    part = torch.empty(p.grid, UNIT_ROWS, C, **f32)
    flag = torch.empty(p.grid, 2, device=f0.device, dtype=torch.int32)
    _build.launch(
        "sparse_focal_loss", "fm_sparse_focal_backward", _ARGTYPES,
        f0.data_ptr(), f1.data_ptr(), *[t.data_ptr() for t in vecs], float(inv_temp),
        B, L, S, C, p.grid, *[t.data_ptr() for t in (f0s, v0, v1, part, flag, df0, df1)],
        _build.stream(),
    )
    sparse_focal_backward.launches += 1
    return df0, df1


sparse_focal_backward.launches = 0


def _gather_rows(f: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.gather(f, 1, ids[..., None].expand(-1, -1, f.shape[-1])).float()


def _scatter_rows(n: int, ids: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, n, ...] zeros with v [B, G, ...] added at ids [B, G] (index_add_)."""
    B, G = ids.shape
    flat = (ids + n * torch.arange(B, device=ids.device)[:, None]).reshape(-1)
    out = torch.zeros((B * n,) + tuple(v.shape[2:]), device=v.device, dtype=v.dtype)
    return out.index_add_(0, flat, v.reshape((B * G,) + tuple(v.shape[2:]))).reshape(
        (B, n) + tuple(v.shape[2:]))


class _SparseFocalLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, gt_i, gt_j, gt_mask, inv_temp, alpha, gamma):
        lse_r, lse_c = dual_softmax_lse(f0, f1, inv_temp)
        sim_p = (_gather_rows(f0, gt_i) * _gather_rows(f1, gt_j)).sum(-1) * inv_temp
        logc = 2.0 * sim_p - torch.gather(lse_r, 1, gt_i) - torch.gather(lse_c, 1, gt_j)
        per, dlogc = per_pair_loss_and_grad(logc, alpha, gamma)
        m = gt_mask.float()
        denom = m.sum().clamp(min=1.0)
        ctx.save_for_backward(f0, f1, gt_i, gt_j, m, lse_r, lse_c, dlogc, denom)
        ctx.inv_temp = inv_temp
        return (per * m).sum() / denom

    @staticmethod
    def backward(ctx, g):
        f0, f1, gt_i, gt_j, m, lse_r, lse_c, dlogc, denom = ctx.saved_tensors
        inv_temp = ctx.inv_temp
        L, S = f0.shape[1], f1.shape[1]
        gbar = (g / denom) * dlogc * m  # [B, G]
        a_r = _scatter_rows(L, gt_i, gbar)
        a_c = _scatter_rows(S, gt_j, gbar)
        df0, df1 = sparse_focal_backward(f0, f1, a_r, lse_r, a_c, lse_c, inv_temp)
        coef = (2.0 * gbar * inv_temp)[..., None]
        df0 = df0 + _scatter_rows(L, gt_i, coef * _gather_rows(f1, gt_j))
        df1 = df1 + _scatter_rows(S, gt_j, coef * _gather_rows(f0, gt_i))
        return df0.to(f0.dtype), df1.to(f1.dtype), None, None, None, None, None, None


def sparse_focal_loss(f0: torch.Tensor, f1: torch.Tensor, gt_i: torch.Tensor,
                      gt_j: torch.Tensor, gt_mask: torch.Tensor, inv_temp: float,
                      alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Mean focal loss over the GT pairs, without the confidence matrix.

    f0: [B, L, C], f1: [B, S, C] coarse features (inv_temp = 1 / (C * T));
    gt_i / gt_j / gt_mask: [B, G] padded GT pairs. Gradients reach f0 and f1."""
    return _SparseFocalLoss.apply(f0, f1, gt_i.long(), gt_j.long(), gt_mask, float(inv_temp),
                                  float(alpha), float(gamma))


def naive_sparse_focal_loss(f0, f1, gt_i, gt_j, gt_mask, inv_temp, alpha=0.25, gamma=2.0):
    """The same loss through the whole confidence matrix (for tests)."""
    sim = f0.float() @ f1.float().transpose(1, 2) * inv_temp
    conf = (torch.softmax(sim, 1) * torch.softmax(sim, 2)).clamp(1e-6, 1 - 1e-6)
    cp = conf[torch.arange(f0.shape[0], device=f0.device)[:, None], gt_i.long(), gt_j.long()]
    per = -alpha * (1 - cp) ** gamma * torch.log(cp)
    m = gt_mask.float()
    return (per * m).sum() / m.sum().clamp(min=1.0)
