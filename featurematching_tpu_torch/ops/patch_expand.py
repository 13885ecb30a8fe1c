"""PatchExpand tail: 2x2 depth-to-space + PatchExpand LN + stage norm_up LN
(+ an optional per-token dense head) on the expand dense's output.

Port of `featurematching_tpu/ops/pallas_patch_expand.py · patch_expand_ln`.
On a CUDA tensor it launches `csrc/patch_expand.cu` (the depth-to-space is an
address computation, both LNs in f32 registers, the head on bf16 tensor
cores; bound by device-memory bytes); on a CPU tensor it runs
`patch_expand_ln_plain`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.layer_norm import layer_norm_f32

_ARGTYPES = (
    [_build.PTR] + [_build.INT] * 4 + [_build.PTR] * 4 + [_build.INT]
    + [_build.PTR] * 2 + [_build.INT] + [_build.PTR] * 3
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
    output and adds its bias in f32, as the kernel does."""
    dt = y.dtype
    v = layer_norm_f32(depth_to_space(y, H, W).float(), scale1, bias1)
    if scale2 is not None:
        v = layer_norm_f32(v, scale2, bias2)
    v = v.to(dt)
    outs = [v] if emit_ln else []
    if w_head is not None:
        outs.append((v.float() @ w_head.to(dt).float() + b_head.float()).to(dt))
    return tuple(outs)


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
    [B, 4*H*W, C4 or C_head]. w_head: [C4, C_head] ([in, out])."""
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
    two = scale2 is not None
    s1, b1 = _build.f32(scale1), _build.f32(bias1)
    s2, b2 = (_build.f32(scale2), _build.f32(bias2)) if two else (s1, b1)
    ln_out = y.new_empty(B, 4 * L, C4) if emit_ln else None
    if CH:
        wh, bh = _build.bf16(w_head), _build.f32(b_head)
        _build.check_cuda(wh, "w_head", shape=(C4, CH))
        _build.check_cuda(bh, "b_head", shape=(CH,))
        head_out = y.new_empty(B, 4 * L, CH)
    else:
        wh = bh = head_out = None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(
        "patch_expand", "fm_patch_expand_ln", _ARGTYPES,
        y.data_ptr(), B, H, W, C4, s1.data_ptr(), b1.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), int(two), ptr(wh), ptr(bh), CH, ptr(ln_out), ptr(head_out),
        _build.stream(),
    )
    patch_expand_ln.launches += 1
    return tuple(t for t in (ln_out, head_out) if t is not None)


patch_expand_ln.launches = 0
