"""LayerNorm chain: LN(x) or LN2(LN1(x)) in one pass over the map.

Port of `featurematching_tpu/ops/pallas_ln.py · layer_norm_chain`. On a CUDA
tensor it launches the hand-written kernel `csrc/layer_norm.cu` (a row on
C / 8 lanes, 16-byte loads, several rows in flight a thread, f32 statistics
in registers, a grid-stride loop over a grid the card holds at once; bound
by device-memory bytes); on a CPU tensor it runs the plain version below.
eps is 1e-6, the model's value.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from featurematching_tpu_torch.ops import _build

EPS = 1e-6
WARPS = 8  # csrc/layer_norm.cu kThreads / 32
ROWS_A_THREAD = 4  # csrc/layer_norm.cu kRows: warp loads in flight a unit
_ARGTYPES = [_build.PTR] * 6 + [_build.INT] * 4 + [_build.PTR]


def layer_norm_f32(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + EPS) * scale.float() + bias.float()


def layer_norm_chain_plain(
    x: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    scale2: Optional[torch.Tensor] = None,
    bias2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel (also the port's plain LN): f32 statistics,
    both LNs in f32, one rounding to x's dtype at the end."""
    y = layer_norm_f32(x.float(), scale1, bias1)
    if scale2 is not None:
        y = layer_norm_f32(y, scale2, bias2)
    return y.to(x.dtype)


def unit_rows(C: int) -> int:
    """Rows of one warp's unit of work: 32 / (C / 8) rows a warp load, one
    row of C channels on C / 8 lanes, ROWS_A_THREAD loads."""
    return (256 // C) * ROWS_A_THREAD


def plan(rows: int, C: int, sms: int, per_sm: int) -> int:
    """The kernel's grid over `rows` rows of C channels: WARPS warps a block
    walk the units of `unit_rows(C)` rows in a grid-stride loop; as many
    blocks as the card holds at once (`sms` x `per_sm`), or one a WARPS
    units where the units are fewer."""
    units = -(-rows // unit_rows(C))
    return max(1, min(-(-units // WARPS), sms * per_sm))


@functools.lru_cache(maxsize=None)
def _capacity(C: int, device: int) -> tuple:
    """(SMs, resident blocks an SM) of the kernel at width C on the card."""
    n = ctypes.c_int()
    fn = _build._load("layer_norm").fm_layer_norm_blocks_per_sm
    fn.argtypes, fn.restype = [_build.INT, ctypes.POINTER(ctypes.c_int)], _build.INT
    err = fn(C, ctypes.byref(n))
    if err:
        raise RuntimeError(f"fm_layer_norm_blocks_per_sm: CUDA error {err}")
    return torch.cuda.get_device_properties(device).multi_processor_count, n.value


def launch_layer_norm(x: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                      s2: Optional[torch.Tensor], b2: Optional[torch.Tensor], y: torch.Tensor,
                      rows: int) -> None:
    """The kernel over the first `rows` rows of x [..., C] into y, on the
    grid `plan` gives for them (`layer_norm_chain` passes every row)."""
    C = x.shape[-1]
    two = s2 is not None
    s2, b2 = (s2, b2) if two else (s1, b1)
    grid = plan(rows, C, *_capacity(C, x.device.index or 0))
    _build.launch(
        "layer_norm", "fm_layer_norm_chain", _ARGTYPES,
        x.data_ptr(), s1.data_ptr(), b1.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), rows, C, int(two), grid, _build.stream(),
    )


def layer_norm_chain(
    x: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    scale2: Optional[torch.Tensor] = None,
    bias2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LN(x) or LN2(LN1(x)) over the last axis. x: [..., C], any leading dims."""
    if x.device.type == "cpu":
        return layer_norm_chain_plain(x, scale1, bias1, scale2, bias2)
    C = x.shape[-1]
    if C not in (64, 128, 256):
        raise ValueError(f"layer_norm_chain kernel takes C in (64, 128, 256), got {C}")
    _build.check_cuda(x, "x", torch.bfloat16)
    s2, b2 = (_build.f32(scale2), _build.f32(bias2)) if scale2 is not None else (None, None)
    y = torch.empty_like(x)
    launch_layer_norm(x, _build.f32(scale1), _build.f32(bias1), s2, b2, y, x.numel() // C)
    layer_norm_chain.launches += 1
    return y


layer_norm_chain.launches = 0
