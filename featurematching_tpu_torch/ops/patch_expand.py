"""PatchExpand tail: 2x2 depth-to-space + PatchExpand LN + stage norm_up LN
(+ an optional per-token dense head) on the expand dense's output.

Port of `featurematching_tpu/ops/pallas_patch_expand.py · patch_expand_ln`.
On a CUDA tensor it launches `csrc/patch_expand.cu` (the expand output read
in its own order, the depth-to-space an address of each write, both LNs in
f32 registers, a persistent grid that loads the next tile while it works on
this one, the head on `mma.sync` against its weight held in shared memory;
bound by device-memory bytes); on a CPU tensor it runs
`patch_expand_ln_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.layer_norm import layer_norm_f32

WARPS = 8  # csrc/patch_expand.cu kThreads / 32
ROWS_A_THREAD = 4  # csrc/patch_expand.cu kRows: warp loads a tile

_ARGTYPES = (
    [_build.PTR] + [_build.INT] * 3 + [_build.PTR] * 4 + [_build.INT]
    + [_build.PTR] * 2 + [_build.INT] + [_build.PTR] * 2 + [_build.INT] + [_build.PTR]
)


def depth_to_space(y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, H*W, 4*C4] with lanes ordered (i, j, c) -> [B, 4*H*W, C4]."""
    B, L, Ce = y.shape
    C4 = Ce // 4
    return (
        y.reshape(B, H, W, 2, 2, C4).permute(0, 1, 3, 2, 4, 5).reshape(B, 4 * H * W, C4)
    )


def patch_expand_supported(C4: int, head: int) -> bool:
    """What the kernel takes: C4 in (64, 128) and a head width of 0 (none),
    64 or 256."""
    return C4 in (64, 128) and head in (0, 64, 256)


def patch_expand_ln_plain(y, H, W, scale1, bias1, scale2=None, bias2=None,
                          w_head=None, b_head=None, emit_ln=True):
    """Plain version: LN chain in f32, the head reads the bf16-rounded LN
    output and adds its bias (where given) in f32, as the kernel does."""
    dt = y.dtype
    v = layer_norm_f32(depth_to_space(y, H, W).float(), scale1, bias1)
    if scale2 is not None:
        v = layer_norm_f32(v, scale2, bias2)
    v = v.to(dt)
    outs = [v] if emit_ln else []
    if w_head is not None:
        h = v.float() @ w_head.to(dt).float()
        outs.append((h if b_head is None else h + b_head.float()).to(dt))
    return tuple(outs)


def head_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Linear head's weight [out, in] as the kernel reads it: [in, out],
    contiguous, in `dtype`; kept on the weight while it stays at the same
    version, so the serving forward makes it once (`load_state_dict` and
    in-place updates bump the version and make it anew)."""
    held = getattr(weight, "_head_weight", None)
    if held is not None and held[0] == (weight._version, dtype):
        return held[1]
    w = weight.detach().t().to(dtype).contiguous()
    weight._head_weight = ((weight._version, dtype), w)
    return w


def tile_tokens(C4: int) -> int:
    """Output tokens of one tile of the kernel: WARPS warps, 32 / (C4 / 8)
    tokens a warp load, ROWS_A_THREAD loads."""
    return WARPS * (256 // C4) * ROWS_A_THREAD


def plan(tokens: int, C4: int, sms: int, per_sm: int) -> int:
    """The kernel's persistent grid over `tokens` output tokens: the tiles
    of `tile_tokens(C4)`, as many blocks as the card holds at once (`sms` x
    `per_sm`) or one a tile where the tiles are fewer."""
    return max(1, min(-(-tokens // tile_tokens(C4)), sms * per_sm))


@functools.lru_cache(maxsize=None)
def _capacity(C4: int, CH: int, device: int) -> tuple:
    """(SMs, resident blocks an SM) of the kernel at (C4, CH) on the card."""
    n = ctypes.c_int()
    fn = _build._load("patch_expand").fm_patch_expand_blocks_per_sm
    fn.argtypes = [_build.INT, _build.INT, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _build.INT
    err = fn(C4, CH, ctypes.byref(n))
    if err:
        raise RuntimeError(f"fm_patch_expand_blocks_per_sm: CUDA error {err}")
    return torch.cuda.get_device_properties(device).multi_processor_count, n.value


def launch_patch_expand(y, W, s1, b1, s2, b2, wh, bh, ln_out, head_out, tokens: int) -> None:
    """The kernel over the first `tokens` output tokens of y [B, H*W, 4*C4]
    in y's own order (`patch_expand_ln` passes all 4*B*H*W), on the grid
    `plan` gives for them. s2/b2, wh, bh, ln_out and head_out may be None."""
    C4 = y.shape[-1] // 4
    CH = 0 if wh is None else wh.shape[1]
    two = s2 is not None
    s2, b2 = (s2, b2) if two else (s1, b1)
    grid = plan(tokens, C4, *_capacity(C4, CH, y.device.index or 0))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(
        "patch_expand", "fm_patch_expand_ln", _ARGTYPES,
        y.data_ptr(), W, tokens, C4, s1.data_ptr(), b1.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), int(two), ptr(wh), ptr(bh), CH, ptr(ln_out), ptr(head_out), grid,
        _build.stream(),
    )


def patch_expand_ln(
    y: torch.Tensor,
    H: int,
    W: int,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    scale2: Optional[torch.Tensor] = None,
    bias2: Optional[torch.Tensor] = None,
    w_head: Optional[torch.Tensor] = None,
    b_head: Optional[torch.Tensor] = None,
    emit_ln: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """y: [B, H*W, 4*C4], the expand output. Returns the requested outputs in
    order (LN output if emit_ln, head output if w_head), each
    [B, 4*H*W, C4 or C_head]. w_head: [C4, C_head] ([in, out]; see
    `head_weight`); b_head: [C_head] or None (no bias)."""
    B, L, Ce = y.shape
    if L != H * W or Ce % 4:
        raise ValueError(f"patch_expand_ln: y {tuple(y.shape)} does not fit H={H}, W={W}")
    if not (emit_ln or w_head is not None):
        raise ValueError("patch_expand_ln: nothing to return")
    if y.device.type == "cpu":
        return patch_expand_ln_plain(
            y, H, W, scale1, bias1, scale2, bias2, w_head, b_head, emit_ln
        )
    C4 = Ce // 4
    CH = 0 if w_head is None else w_head.shape[1]
    if not patch_expand_supported(C4, CH):
        raise ValueError(
            f"patch_expand_ln kernel takes C4 in (64, 128) and a head width in "
            f"(64, 256); got C4={C4}, head={CH}"
        )
    _build.check_cuda(y, "y", torch.bfloat16)
    s2, b2 = (_build.f32(scale2), _build.f32(bias2)) if scale2 is not None else (None, None)
    ln_out = y.new_empty(B, 4 * L, C4) if emit_ln else None
    wh = bh = head_out = None
    if CH:
        wh = _build.bf16(w_head)
        _build.check_cuda(wh, "w_head", shape=(C4, CH))
        if b_head is not None:
            bh = _build.f32(b_head)
            _build.check_cuda(bh, "b_head", shape=(CH,))
        head_out = y.new_empty(B, 4 * L, CH)
    launch_patch_expand(y, W, _build.f32(scale1), _build.f32(bias1), s2, b2, wh, bh, ln_out,
                        head_out, 4 * B * L)
    patch_expand_ln.launches += 1
    return tuple(t for t in (ln_out, head_out) if t is not None)


patch_expand_ln.launches = 0
