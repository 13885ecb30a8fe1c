"""Dual-softmax mutual-NN matching statistics without the [L, S] matrix.

Port of `featurematching_tpu/ops/pallas_dual_softmax.py ·
dual_softmax_match_stats`. On a CUDA tensor it launches `csrc/dual_softmax.cu`
(two passes of 128-row blocks over chunks of f1's 64-column tiles on bf16
mma.sync tiles, the sim tile and its statistics in registers, each pass
followed by a small combine kernel; bound by tensor-core operations); on a
CPU tensor it runs `_stats_reference`.

Both forms fold inv_temp = 1 / (C * T) into f0 in f0's dtype before the
product, as the TPU kernel does (the JAX package's `_stats_reference` scales
after it; in float32 the two agree to rounding).

`dual_softmax_lse` launches pass 1 and its combine alone: the row and
column log-sum-exps of sim, the forward of the sparse focal loss (the JAX
package's `sparse_focal_loss._lses_pallas`, which runs `_pass1_stats`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from featurematching_tpu_torch.ops import _build

ROW_TILE = 128  # rows of f0 a block
_ARGTYPES = [_build.PTR, _build.PTR, _build.FLOAT] + [_build.INT] * 6 + [_build.PTR] * 11
_LSE_ARGTYPES = [_build.PTR, _build.PTR, _build.FLOAT] + [_build.INT] * 6 + [_build.PTR] * 7


class Plan(NamedTuple):
    """The kernels' work decomposition: row tiles x `n_split` chunks of
    `chunk` 64-column tiles, `units` blocks a pass."""

    blocks_per_sm: int
    sms: int
    n_split: int
    chunk: int
    units: int


@functools.lru_cache(maxsize=None)
def plan(B: int, L: int, S: int, C: int, device: int) -> Plan:
    """The decomposition `csrc/dual_softmax.cu` picks for these shapes on
    CUDA device `device` (the split count that spreads the work units most
    evenly over the SMs)."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _build.launch("dual_softmax", "fm_dual_softmax_plan", [_build.INT] * 4 + [_build.PTR],
                      B, L, S, C, ctypes.addressof(out))
    return Plan(*out)


def _scratch(feat0: torch.Tensor, feat1: torch.Tensor):
    """The plan and the partials' buffers: row [B, n_split, L] x 2, column
    [B, n_tiles, S] x 2 (f32; pass 2 keeps its argmaxes there as int32)."""
    B, L, C = feat0.shape
    S = feat1.shape[1]
    p = plan(B, L, S, C, feat0.device.index)
    f32 = dict(device=feat0.device, dtype=torch.float32)
    n_tiles = -(-L // ROW_TILE)
    return p, [torch.empty(B, p.n_split, L, **f32), torch.empty(B, p.n_split, L, **f32),
               torch.empty(B, n_tiles, S, **f32), torch.empty(B, n_tiles, S, **f32)]


class MatchStats(NamedTuple):
    """Per-pair dual-softmax statistics.

    row_max / row_argmax: [B, L] max / argmax over j of conf[i, j]
    col_max / col_argmax: [B, S] max / argmax over i of conf[i, j]
    """

    row_max: torch.Tensor
    row_argmax: torch.Tensor
    col_max: torch.Tensor
    col_argmax: torch.Tensor


def dual_softmax_confidence(feat0: torch.Tensor, feat1: torch.Tensor,
                            inv_temp: float) -> torch.Tensor:
    """conf [B, L, S] f32 = softmax_rows(sim) * softmax_cols(sim) at K1's
    rounding point: f0 * inv_temp rounded to f0's dtype before the product.
    K1's plain twin (`_stats_reference`) takes it. The Matcher's conf matrix
    is `matching/coarse.dual_softmax_confidence`, which divides the
    f32-accumulated product by C * T after it, as the JAX package does."""
    f0 = (feat0.float() * inv_temp).to(feat0.dtype)
    sim = f0.float() @ feat1.float().transpose(1, 2)
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def _stats_reference(feat0: torch.Tensor, feat1: torch.Tensor, inv_temp: float) -> MatchStats:
    """Plain version: the whole confidence matrix, then max/argmax (argmax
    keeps the first maximum, as jnp.argmax does)."""
    conf = dual_softmax_confidence(feat0, feat1, inv_temp)
    return MatchStats(
        conf.amax(dim=2), conf.argmax(dim=2).int(),
        conf.amax(dim=1), conf.argmax(dim=1).int(),
    )


def dual_softmax_match_stats(
    feat0: torch.Tensor, feat1: torch.Tensor, temperature: float = 0.1
) -> MatchStats:
    """Row/col max+argmax of the dual-softmax confidence. feat*: [B, L/S, C]."""
    B, L, C = feat0.shape
    S = feat1.shape[1]
    inv_temp = 1.0 / (C * temperature)
    if feat0.device.type == "cpu":
        return _stats_reference(feat0, feat1, inv_temp)
    if C not in (64, 128, 256):
        raise ValueError(f"dual_softmax_match_stats kernel takes C in (64, 128, 256), got {C}")
    _build.check_cuda(feat0, "feat0", torch.bfloat16)
    _build.check_cuda(feat1, "feat1", torch.bfloat16, (B, S, C))
    p, scratch = _scratch(feat0, feat1)
    f32 = dict(device=feat0.device, dtype=torch.float32)
    i32 = dict(device=feat0.device, dtype=torch.int32)
    scratch += [torch.empty(B, L, **f32), torch.empty(B, S, **f32)]  # base-2 log-sum-exps
    out = MatchStats(
        torch.empty(B, L, **f32), torch.empty(B, L, **i32),
        torch.empty(B, S, **f32), torch.empty(B, S, **i32),
    )
    _build.launch(
        "dual_softmax", "fm_dual_softmax_stats", _ARGTYPES,
        feat0.data_ptr(), feat1.data_ptr(), inv_temp, B, L, S, C, p.n_split, p.chunk,
        *[t.data_ptr() for t in scratch], *[t.data_ptr() for t in out], _build.stream(),
    )
    dual_softmax_match_stats.launches += 1
    return out


dual_softmax_match_stats.launches = 0


def _lse_reference(feat0: torch.Tensor, feat1: torch.Tensor, inv_temp: float):
    f0 = (feat0.float() * inv_temp).to(feat0.dtype)
    sim = f0.float() @ feat1.float().transpose(1, 2)
    return torch.logsumexp(sim, dim=2), torch.logsumexp(sim, dim=1)


def dual_softmax_lse(feat0: torch.Tensor, feat1: torch.Tensor, inv_temp: float):
    """(lse_r [B, L], lse_c [B, S]) f32: the row and column log-sum-exps of
    sim = (feat0 * inv_temp, rounded to feat0's dtype) feat1ᵀ."""
    B, L, C = feat0.shape
    S = feat1.shape[1]
    if feat0.device.type == "cpu":
        return _lse_reference(feat0, feat1, inv_temp)
    if C not in (64, 128, 256):
        raise ValueError(f"dual_softmax_lse kernel takes C in (64, 128, 256), got {C}")
    _build.check_cuda(feat0, "feat0", torch.bfloat16)
    _build.check_cuda(feat1, "feat1", torch.bfloat16, (B, S, C))
    p, scratch = _scratch(feat0, feat1)
    f32 = dict(device=feat0.device, dtype=torch.float32)
    lse_r, lse_c = torch.empty(B, L, **f32), torch.empty(B, S, **f32)
    _build.launch(
        "dual_softmax", "fm_dual_softmax_lse", _LSE_ARGTYPES,
        feat0.data_ptr(), feat1.data_ptr(), float(inv_temp), B, L, S, C, p.n_split, p.chunk,
        *[t.data_ptr() for t in scratch], lse_r.data_ptr(), lse_c.data_ptr(), _build.stream(),
    )
    dual_softmax_lse.launches += 1
    return lse_r, lse_c


dual_softmax_lse.launches = 0
