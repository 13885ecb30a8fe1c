"""Weight gradients dW = Aᵀ B over the tokens of a batch (`csrc/wgrad.cuh`).

Replaces the weight-gradient contractions inside the TPU backward kernels
(`featurematching_tpu/ops/pallas_swin_block_grad.py:326,343,363,449`,
`pallas_coarse_grad.py:71` `_dot_g` at `:158-223`, `pallas_fine_grad.py:
142-216`): f32 dW [M, N] = Aᵀ B with A [T, M] and B [T, N] in bf16, f32
accumulation. K8's, K9's and K10's backward kernels launch the CUDA kernel
from their own libraries, once a call for all their products (4, 6 and 6,
`wgrad_calls` of their modules), and count those launches here;
`wgrad_group` (and `wgrad`, a group of one) is the same kernel as an entry
of its own, for the card tests, `chip_smoke.py` and `tools/wgrad_ab.py`.
On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain twin, `wgrad_reference`.

`plan` mirrors the kernel's cut of a launch: each product into tiles of up
to 128 rows by `tile_width(N)` columns, and its ceil(T / 64) token stages
into splits of `per` stages, contiguous and in order, every product the
same number of splits, so that the launch's tiles x splits fill the card's
SMs once. Each split's f32 partial is added in split order, so the result
repeats bit for bit on one card; the split depends on the card's SM count,
so cards of other sizes may differ in the last bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from featurematching_tpu_torch.ops import _build

STAGE = 64     # tokens a stage
TILE_M = 128   # rows of dW a block (two warpgroups of 64)
TILE_WIDTHS = (256, 192, 128, 64)
MAX_PRODUCTS = 6  # products a launch
REPLACES = ("featurematching_tpu/ops/pallas_swin_block_grad.py:326,343,363,449; "
            "pallas_coarse_grad.py:71 (_dot_g); pallas_fine_grad.py:142-216")
_ARGS = [_build.PTR] * 4 + [_build.INT] * 2 + [_build.PTR] * 2

Call = Tuple[int, int, int]  # (T, M, N)


class Plan(NamedTuple):
    """A product's cut: tiles of up to TILE_M rows by `nt` columns (m_tiles
    x n_tiles of them), its `stages` 64-token stages in `splits` runs of
    `per` (the last may be shorter)."""

    nt: int
    m_tiles: int
    n_tiles: int
    stages: int
    splits: int
    per: int


def tile_width(N: int) -> int:
    """The widest of TILE_WIDTHS that divides N (0: none does)."""
    return next((nt for nt in TILE_WIDTHS if N % nt == 0), 0)


def plan(calls: Sequence[Call], sms: int) -> List[Plan]:
    """The kernel's `wgrad_plan` for a launch of products (T, M, N) on a card
    of `sms` SMs (one block an SM): every product takes the same number of
    splits, sms // (the group's tiles), or one a stage where it has fewer."""
    if not 1 <= len(calls) <= MAX_PRODUCTS or sms < 1:
        raise ValueError(f"wgrad takes 1 to {MAX_PRODUCTS} products a launch, got {len(calls)}")
    shapes = []
    for T, M, N in calls:
        nt = tile_width(N)
        if not nt or T < 1 or M < 64 or M % 64:
            raise ValueError(f"wgrad takes T >= 1 and M, N multiples of 64, got T={T}, M={M}, "
                             f"N={N}")
        shapes.append((nt, -(-M // TILE_M), N // nt, -(-T // STAGE)))
    want = max(1, sms // sum(mt * nt_ for _, mt, nt_, _ in shapes))
    plans = []
    for nt, m_tiles, n_tiles, stages in shapes:
        per = -(-stages // min(want, stages))
        plans.append(Plan(nt, m_tiles, n_tiles, stages, -(-stages // per), per))
    return plans


def split_ranges(T: int, p: Plan) -> List[Tuple[int, int]]:
    """The tokens [t0, t1) each split sums over, in the order their partials
    are added."""
    return [(s * p.per * STAGE, min(T, (s + 1) * p.per * STAGE)) for s in range(p.splits)]


def partial_floats(calls: Sequence[Call], sms: int) -> int:
    """f32 scratch for the partials of one launch of products (T, M, N): splits
    x M x N of each product with more than one split, at least 1. Launches in
    stream order may share it."""
    return max(1, sum(p.splits * M * N for (T, M, N), p in zip(calls, plan(calls, sms))
                      if p.splits > 1))


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wgrad_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 Aᵀ B of the bf16 values of a [T, M] and b [T, N]."""
    return a.float().t() @ b.float()


def wgrad_group(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """[f32 Aᵀ B for (a [T, M], b [T, N]) in pairs] in one launch (bf16,
    contiguous; M and N multiples of 64, T >= 1 on the card; at most
    MAX_PRODUCTS pairs), counted in `wgrad.launches`."""
    if pairs[0][0].device.type == "cpu":
        return [wgrad_reference(a, b) for a, b in pairs]
    calls = []
    for a, b in pairs:
        _build.check_cuda(a, "a", torch.bfloat16)
        _build.check_cuda(b, "b", torch.bfloat16, (a.shape[0], b.shape[-1]))
        calls.append((a.shape[0], a.shape[1], b.shape[1]))
    dev = pairs[0][0].device
    sms = sm_count(dev.index or 0)
    f32 = dict(device=dev, dtype=torch.float32)
    part = torch.empty(partial_floats(calls, sms), **f32)  # raises for what plan refuses
    outs = [torch.empty(M, N, **f32) for _, M, N in calls]
    ptrs = [(_build.PTR * len(pairs))(*[t.data_ptr() for t in ts])
            for ts in ([a for a, _ in pairs], [b for _, b in pairs], outs)]
    tmn = (ctypes.c_int * (3 * len(calls)))(*[v for c in calls for v in c])
    _build.launch("wgrad", "fm_wgrad", _ARGS, *ptrs, tmn, len(calls), sms, part.data_ptr(),
                  _build.stream())
    wgrad.launches += 1
    return outs


def wgrad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 dW [M, N] = Aᵀ B for a [T, M] and b [T, N] (bf16, contiguous; M
    and N multiples of 64, T >= 1 on the card): `wgrad_group` of one."""
    return wgrad_group([(a, b)])[0]


wgrad.launches = 0
