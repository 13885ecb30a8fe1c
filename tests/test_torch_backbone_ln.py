"""Host-side pieces of K3 (`ops/layer_norm.py`) and K4 (`ops/patch_expand.py`)
that the CPU reaches: the grids the wrappers plan for the kernels' loops
(every row or token covered once, the grid within what the card holds),
the head weight kept in the kernel's layout, and the bias-free head's plain
version. The kernels themselves are held against their plain versions on
the card (`tests/test_torch_cuda.py`) and their plain versions against the
Pallas kernels in `tests/test_torch_kernels.py`.
"""

import numpy as np
import pytest
import torch

from featurematching_tpu_torch.ops import layer_norm as ln
from featurematching_tpu_torch.ops import patch_expand as pe

SMS = 132  # an H100's SMs


def _ln_rows(rows: int, C: int, grid: int) -> np.ndarray:
    """How often `csrc/layer_norm.cu` reads each row on `grid` blocks: warp
    w of block b takes units u = 8 b + w, u + 8 grid, ...; a unit is
    ROWS_A_THREAD warp loads of 256 / C consecutive rows."""
    seen = np.zeros(rows, dtype=np.int64)
    unit = ln.unit_rows(C)
    units = -(-rows // unit)
    for first in range(min(grid * ln.WARPS, units)):
        for u in range(first, units, grid * ln.WARPS):
            r = np.arange(u * unit, (u + 1) * unit)
            seen[r[r < rows]] += 1
    return seen


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 111, 9600, 153600, 153597, 300001])
def test_layer_norm_plan_covers_every_row_once(C, rows):
    per_sm = 3
    grid = ln.plan(rows, C, SMS, per_sm)
    assert 1 <= grid <= SMS * per_sm
    units = -(-rows // ln.unit_rows(C))
    assert grid == min(-(-units // ln.WARPS), SMS * per_sm)  # no block without a unit
    assert (_ln_rows(rows, C, grid) == 1).all()


def test_layer_norm_plan_at_the_serving_sites():
    """patch_norm walks its units in a grid-stride loop; the C = 256 sites
    take one unit a warp."""
    assert ln.unit_rows(64) == 16 and ln.unit_rows(128) == 8 and ln.unit_rows(256) == 4
    assert ln.plan(8 * 19200, 64, SMS, 4) == SMS * 4  # 1200 block units on 528 blocks
    assert ln.plan(8 * 4800, 128, SMS, 4) == SMS * 4  # 600 block units
    assert ln.plan(8 * 1200, 256, SMS, 4) == 300


def _pe_tokens(B: int, H: int, W: int, C4: int, grid: int) -> np.ndarray:
    """How often `csrc/patch_expand.cu` writes each output token on `grid`
    blocks: block b takes tiles b, b + grid, ... of `tile_tokens(C4)`
    consecutive input-ordered tokens q = 4 p + 2 i + j, and q lands on
    output token (b, 2h + i, 2w + j)."""
    total = 4 * B * H * W
    T = pe.tile_tokens(C4)
    seen = np.zeros(total, dtype=np.int64)
    for blk in range(grid):
        for tile in range(blk, -(-total // T), grid):
            q = np.arange(tile * T, min((tile + 1) * T, total))
            p, i, j = q // 4, (q // 2) % 2, q % 2
            bh, w = p // W, p % W
            seen[(2 * bh + i) * 2 * W + 2 * w + j] += 1
    return seen


@pytest.mark.parametrize("C4", [64, 128])
@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("B,H,W", [(1, 1, 1), (3, 5, 7), (2, 9, 13), (8, 30, 40), (1, 61, 83),
                                   (8, 61, 83)])
def test_patch_expand_plan_covers_every_token_once(C4, per_sm, B, H, W):
    total = 4 * B * H * W
    grid = pe.plan(total, C4, SMS, per_sm)
    assert 1 <= grid <= SMS * per_sm
    assert grid == min(-(-total // pe.tile_tokens(C4)), SMS * per_sm)  # no block without a tile
    assert (_pe_tokens(B, H, W, C4, grid) == 1).all()


def test_patch_expand_token_order_is_depth_to_space():
    """The kernel's order (q = 4 p + 2 i + j read contiguously, written to
    (b, 2h + i, 2w + j)) is `depth_to_space`'s map."""
    B, H, W, C4 = 2, 3, 5, 8
    y = torch.arange(B * H * W * 4 * C4, dtype=torch.float32).reshape(B, H * W, 4 * C4)
    out = pe.depth_to_space(y, H, W).reshape(-1, C4)
    q = np.arange(4 * B * H * W)
    p, i, j = q // 4, (q // 2) % 2, q % 2
    t = (2 * (p // W) + i) * 2 * W + 2 * (p % W) + j
    assert torch.equal(out[torch.as_tensor(t)], y.reshape(-1, C4))


def test_patch_expand_plan_at_the_serving_sites():
    """The tiles of dec0 (C4 128), dec1 and dec2 (C4 64) outnumber the
    blocks the card holds, so each site walks its tiles in a grid-stride
    loop."""
    assert pe.tile_tokens(64) == 128 and pe.tile_tokens(128) == 64
    sites = ((30, 40, 128), (60, 80, 64), (120, 160, 64))
    assert [-(-4 * 8 * h * w // pe.tile_tokens(c)) for h, w, c in sites] == [600, 1200, 4800]
    assert [pe.plan(4 * 8 * h * w, c, SMS, 2) for h, w, c in sites] == [264, 264, 264]


def test_head_weight_is_kept_until_the_weight_changes():
    lin = torch.nn.Linear(64, 16, bias=False)
    a = pe.head_weight(lin.weight, torch.bfloat16)
    assert a.shape == (64, 16) and a.is_contiguous() and a.dtype == torch.bfloat16
    assert torch.equal(a, lin.weight.detach().t().bfloat16())
    assert pe.head_weight(lin.weight, torch.bfloat16) is a
    f = pe.head_weight(lin.weight, torch.float32)  # another dtype: another copy
    assert f.dtype == torch.float32 and torch.equal(f, lin.weight.detach().t())
    with torch.no_grad():
        lin.weight.mul_(2)
    b = pe.head_weight(lin.weight, torch.bfloat16)
    assert b is not a and torch.equal(b, lin.weight.detach().t().bfloat16())
    lin.load_state_dict({"weight": torch.zeros(16, 64)})
    assert not pe.head_weight(lin.weight, torch.bfloat16).any()


def test_head_without_bias_is_a_zero_bias():
    """`b_head=None` skips the add: the plain version equals a zero bias."""
    g = np.random.default_rng(0)
    B, H, W, C4, CH = 2, 3, 5, 64, 16
    y = torch.as_tensor(g.standard_normal((B, H * W, 4 * C4)), dtype=torch.float32)
    s1, s2 = (torch.as_tensor(1 + 0.1 * g.standard_normal(C4), dtype=torch.float32)
              for _ in range(2))
    b1, b2 = (torch.as_tensor(0.1 * g.standard_normal(C4), dtype=torch.float32)
              for _ in range(2))
    wh = torch.as_tensor(0.1 * g.standard_normal((C4, CH)), dtype=torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        args = (y.to(dt), H, W, s1, b1, s2, b2, wh)
        got = pe.patch_expand_ln(*args, b_head=None, emit_ln=False)
        ref = pe.patch_expand_ln(*args, b_head=torch.zeros(CH), emit_ln=False)
        assert len(got) == 1 and got[0].shape == (B, 4 * H * W, CH)
        assert torch.equal(got[0], ref[0])
