"""A whole Swin block over image-layout activations: the window partition,
reverse and shifted roll absorbed into the kernel's indexing.

Port of `featurematching_tpu/ops/pallas_swin_block.py · swin_block_image /
swin_block_fused_image` (and its `pad_region_masks`). On a CUDA tensor
`swin_block_fused_image` launches `csrc/swin_block_image.cu` (K2's block
body, `csrc/swin_block.cuh`, reading and writing each 8x8 window in place
in the padded map; bound by tensor-core operations); on a CPU tensor it runs
`swin_block_image_reference`. Its limits are K2's: window 8, C in (64, 128,
256), a head dim in HEAD_DIMS (16, 32, 64), MLP width 4C.

The pad formulation: with a shift, the map is padded by (w - shift) rows and
columns before the content, the content to a multiple of w, and shift after
(`swin_block_image`). The windows of that map, at multiples of w, then group
the tokens as the rolled map's windows do, with the rows and columns that
the roll wraps replaced by pad tokens that a region mask isolates; every
real token's output equals the roll path's (`pad_region_masks`).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.swin_block import HEAD_DIMS, swin_block_reference

WINDOW = 8
_ARGTYPES = [_build.PTR] + [_build.INT] * 4 + [_build.PTR] * 14 + [_build.INT] * 2 + [_build.PTR]


def _bands(P2: int, w: int, shift: int) -> np.ndarray:
    """Region band of each padded coordinate along an axis of length P2:
    content coordinates y (those of the map padded to a multiple of w,
    pad-to-multiple rows included) take the rolled map's labels, [0, shift)
    -> 2, [Hp - w + shift, Hp) -> 1, else 0; the added top and bottom (left
    and right) rows are 3, isolated."""
    Hp = P2 - w
    y = np.arange(P2) - (w - shift)
    b = np.full(P2, 3, np.int32)
    content = (y >= 0) & (y < Hp)
    b = np.where(content & (y < shift), 2, b)
    b = np.where(content & (y >= shift) & (y < Hp - w + shift), 0, b)
    return np.where(content & (y >= Hp - w + shift), 1, b)


@functools.lru_cache(maxsize=None)
def _region_mask_windows(Hp2: int, Wp2: int, w: int, shift: int) -> np.ndarray:
    """The additive mask of every window of the padded map, [nwh, nww, N, N]
    f32: -100 between tokens of different regions, else 0."""
    region = _bands(Hp2, w, shift)[:, None] * 4 + _bands(Wp2, w, shift)[None, :]
    nwh, nww = Hp2 // w, Wp2 // w
    win = region.reshape(nwh, w, nww, w).transpose(0, 2, 1, 3).reshape(nwh, nww, w * w)
    return np.where(win[:, :, None, :] != win[:, :, :, None], -100.0, 0.0).astype(np.float32)


def pad_region_masks(Hp2: int, Wp2: int, w: int, shift: int) -> np.ndarray:
    """The JAX package's masks for the pad formulation, [3, nww, N, N]: the
    first window row, a middle one (every middle row has the same masks) and
    the last."""
    full = _region_mask_windows(Hp2, Wp2, w, shift)
    return np.stack([full[0], full[1] if full.shape[0] > 2 else full[0], full[-1]])


def swin_block_image_reference(xp: torch.Tensor, params: Dict[str, torch.Tensor],
                               num_heads: int, window: int, shift: int) -> torch.Tensor:
    """Plain version over the padded map xp [B, Hp2, Wp2, C]: partition into
    windows, the region masks (shift > 0), K2's plain block
    (`swin_block_reference`), reverse."""
    B, Hp2, Wp2, C = xp.shape
    w = window
    nwh, nww = Hp2 // w, Wp2 // w
    xw = xp.reshape(B, nwh, w, nww, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)
    mask = None
    if shift > 0:
        mask = torch.as_tensor(_region_mask_windows(Hp2, Wp2, w, shift),
                               device=xp.device).reshape(nwh * nww, w * w, w * w)
    ow = swin_block_reference(xw, mask, params, num_heads)
    return ow.reshape(B, nwh, nww, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp2, Wp2, C)


def swin_block_fused_image(xp: torch.Tensor, params: Dict[str, torch.Tensor], num_heads: int,
                           window: int, shift: int) -> torch.Tensor:
    """The block over the padded map xp [B, Hp2, Wp2, C] (padded by the
    caller, as `swin_block_image` pads)."""
    if xp.device.type == "cpu":
        return swin_block_image_reference(xp, params, num_heads, window, shift)
    B, Hp2, Wp2, C = xp.shape
    hid = params["w_mlp1"].shape[1]
    if (window != WINDOW or C not in (64, 128, 256) or C % num_heads
            or C // num_heads not in HEAD_DIMS
            or hid != 4 * C or Hp2 % WINDOW or Wp2 % WINDOW or not 0 <= shift < WINDOW):
        raise ValueError(
            f"swin_block_fused_image kernel takes window {WINDOW}, C in (64, 128, 256), a head "
            f"dim in {HEAD_DIMS}, an MLP width of 4*C and a map padded to the window; got window="
            f"{window}, C={C}, heads={num_heads}, MLP {hid}, map {Hp2}x{Wp2}, shift={shift}")
    _build.check_cuda(xp, "xp", torch.bfloat16)
    f32, bf = _build.f32, _build.bf16
    p = [
        f32(params["ln1_scale"]), f32(params["ln1_bias"]),
        bf(params["w_qkv"]), f32(params["b_qkv"]), f32(params["rel_bias"]),
        bf(params["w_proj"]), f32(params["b_proj"]),
        f32(params["ln2_scale"]), f32(params["ln2_bias"]),
        bf(params["w_mlp1"]), f32(params["b_mlp1"]),
        bf(params["w_mlp2"]), f32(params["b_mlp2"]),
    ]
    N = WINDOW * WINDOW
    for t, shape in zip(p, [(C,), (C,), (C, 3 * C), (3 * C,), (num_heads, N, N),
                            (C, C), (C,), (C,), (C,), (C, hid), (hid,), (hid, C), (C,)]):
        _build.check_cuda(t, "param", shape=shape)
    out = torch.empty_like(xp)
    _build.launch(
        "swin_block_image", "fm_swin_block_image", _ARGTYPES,
        xp.data_ptr(), B, Hp2, Wp2, shift, *[t.data_ptr() for t in p], out.data_ptr(), C,
        C // num_heads, _build.stream(),
    )
    swin_block_fused_image.launches += 1
    return out


swin_block_fused_image.launches = 0


def pad_image(x: torch.Tensor, H: int, W: int, window: int, shift: int):
    """(xp, top): the map x [B, H*W, C] padded for `swin_block_fused_image`
    and the offset of its content. With a shift: (w - shift) before the
    content, the content to a multiple of w, shift after; else the content
    to a multiple of w after it."""
    B, L, C = x.shape
    w = window
    pad_b, pad_r = (w - H % w) % w, (w - W % w) % w
    top = w - shift if shift > 0 else 0
    xi = x.reshape(B, H, W, C)
    if top or pad_b or pad_r or shift:
        xi = F.pad(xi, (0, 0, top, pad_r + shift, top, pad_b + shift))
    return xi.contiguous(), top


def swin_block_image(x: torch.Tensor, H: int, W: int, params: Dict[str, torch.Tensor],
                     num_heads: int, window: int, shift: int) -> torch.Tensor:
    """One Swin block on [B, H*W, C] through the image-layout kernel: pad
    (`pad_image`), the block, slice."""
    B, L, C = x.shape
    xp, top = pad_image(x, H, W, window, shift)
    oi = swin_block_fused_image(xp, params, num_heads, window, shift)
    return oi[:, top: top + H, top: top + W].reshape(B, H * W, C)
