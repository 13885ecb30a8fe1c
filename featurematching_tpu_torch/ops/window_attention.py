"""Window multi-head attention over 8x8 windows: scores, relative-position
bias, optional shift mask, softmax and P.V for every head of every window.

Port of `featurematching_tpu/ops/pallas_window_attention.py ·
window_attention_pallas`, the kernel of the per-op Swin block's
`fused_attention` branch. On a CUDA tensor it launches
`csrc/window_attention.cu` (a persistent grid of head groups times runs of
windows, `plan`; q, k and v by tensor copies into a ring, the bias in
registers for a whole run; bf16 tensor cores, scores and probabilities in
registers; bound by device-memory bytes); on a CPU tensor it runs
`window_attention_reference`.

Layouts are the JAX package's: qkv [B_, N, 3C] as the qkv Dense writes it
([q | k | v] blocks, heads d-contiguous within each), bias [h, N, N], mask
[nW, N, N] additive (window b takes mask[b % nW]) or None; out [B_, N, C].
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from featurematching_tpu_torch.ops import _build

WINDOW_TOKENS = 64
HEAD_DIMS = (16, 32, 64)
MAX_C = 256
# a head group: 64 columns of each of q, k and v (one 128-byte row of a
# tensor copy's box), 64 // D heads
GROUP_COLS = 64
_ARGTYPES = [_build.PTR] * 3 + [_build.INT, _build.PTR] + [_build.INT] * 4 + [
    _build.FLOAT, _build.PTR]


class Plan(NamedTuple):
    groups: int  # head groups, ceil(C / 64)
    runs: int  # runs of consecutive windows a group
    grid: int  # blocks: groups x runs, one a (group, run)


def plan(windows: int, C: int, slots: int) -> Plan:
    """The kernel's persistent grid: every head group cut into as many runs
    of windows as fill the `slots` blocks the card holds at once (SMs x
    blocks an SM), no run empty."""
    groups = -(-C // GROUP_COLS)
    runs = max(1, min(windows, slots // groups))
    return Plan(groups, runs, groups * runs)


def run_windows(run: int, runs: int, windows: int) -> Tuple[int, int]:
    """The windows [w0, w1) of run `run`, as the kernel cuts them: runs
    differ by at most one window."""
    return run * windows // runs, (run + 1) * windows // runs


def group_heads(group: int, C: int, heads: int) -> range:
    """The heads of head group `group`: the last of an odd head count may
    have fewer."""
    per = GROUP_COLS // (C // heads)
    return range(group * per, min(heads, (group + 1) * per))


@functools.lru_cache(maxsize=None)
def occupancy(d: int, masked: bool, device: int = 0) -> Tuple[int, int, int]:
    """(dynamic shared memory in bytes, ring slots, resident blocks an SM) of
    the kernel at head dim d, with or without a mask, as the runtime reports them."""
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        _build.launch("window_attention", "fm_window_attention_occupancy",
                      [_build.INT, _build.INT, ctypes.POINTER(ctypes.c_int)], d, int(masked),
                      info)
    return tuple(info)


def launch_plan(windows: int, C: int, heads: int, masked: bool, device: int = 0) -> Plan:
    """`plan` on this card: its SMs times the kernel's blocks an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(windows, C, sms * occupancy(C // heads, masked, device)[2])


def window_attention_supported(N: int, C: int, heads: int) -> bool:
    """What the kernel takes: 8x8 windows, a head dim in HEAD_DIMS, C <= 256."""
    return (N == WINDOW_TOKENS and heads > 0 and C % heads == 0
            and C // heads in HEAD_DIMS and C <= MAX_C)


def window_attention_reference(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version, rounding where the TPU kernel does: q.k summed in f32,
    then * scale + bias in f32, then + mask, softmax in f32, p cast to the
    qkv dtype, p.v summed in f32 and the output cast. (The per-op attention
    scales q in its dtype before the product; at head dims 16 and 64 the
    scale is a power of two and the two orders agree.)"""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    d = C // h
    dt = qkv.dtype
    q, k, v = (qkv[..., i * C: (i + 1) * C].reshape(B_, N, h, d).transpose(1, 2)
               for i in range(3))
    s = (q.float() @ k.float().transpose(-1, -2)) * scale + bias.float()[None]
    if mask is not None:
        wid = torch.arange(B_, device=qkv.device) % mask.shape[0]
        s = s + mask.float()[wid][:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.float() @ v.float()).to(dt)
    return o.transpose(1, 2).reshape(B_, N, C)


def window_attention(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Attention of every window. qkv [B_, N, 3C] -> [B_, N, C]."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, num_heads, scale)
    B_, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or not window_attention_supported(N, C, num_heads):
        raise ValueError(
            f"window_attention kernel takes 8x8 windows, head dim in {HEAD_DIMS} and C <= "
            f"{MAX_C}; got N={N}, C={C3 / 3:g}, heads={num_heads}")
    _build.check_cuda(qkv, "qkv", torch.bfloat16)
    bias = _build.f32(bias)
    _build.check_cuda(bias, "bias", torch.float32, (num_heads, N, N))
    if mask is not None:
        mask = _build.f32(mask)
        _build.check_cuda(mask, "mask", torch.float32, (mask.shape[0], N, N))
    out = torch.empty(B_, N, C, dtype=qkv.dtype, device=qkv.device)
    p = launch_plan(B_, C, num_heads, mask is not None, qkv.device.index or 0)
    _build.launch(
        "window_attention", "fm_window_attention", _ARGTYPES,
        qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
        mask.shape[0] if mask is not None else 0, out.data_ptr(), B_, C, num_heads, p.runs,
        float(scale), _build.stream(),
    )
    window_attention.launches += 1
    return out


window_attention.launches = 0
