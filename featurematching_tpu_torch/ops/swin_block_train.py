"""The differentiable Swin block with drop-path scales (kernel K8).

Port of `featurematching_tpu/ops/pallas_swin_block_grad.py ·
swin_block_train`: the block of `ops/swin_block` (LN1 -> window MSA with the
relative-position bias and the optional shift mask -> proj -> LN2 -> exact-GELU
MLP, two residual adds) whose two branches are scaled per window by s1 and s2
before their residual adds, as a `torch.autograd.Function`.

On CUDA tensors the forward launches `csrc/swin_block_train.cu`'s forward
kernel (K2's kernel with the scales, which also writes the attention
probabilities and the residual stream after the attention branch when a
backward will read them, as the TPU kernel's save_probs does), and the
backward launches its backward kernels: dx and all 13
parameter gradients, accumulated over the windows in a fixed order. On CPU
tensors `swin_block_train` runs `swin_block_train_reference`, which autograd
differentiates. mask, s1 and s2 get no gradient.

Rounding follows the TPU kernel (and K2): products accumulate in f32, the
bias is added and the branch scale applied in f32, the result is rounded to
x's dtype, residual adds are in x's dtype. dx comes back in x's dtype and the
parameter gradients in f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain_plain
from featurematching_tpu_torch.ops.swin_block import WINDOW_TOKENS, _dense
from featurematching_tpu_torch.ops.wgrad import partial_floats, sm_count, wgrad

PARAM_KEYS = (
    "ln1_scale", "ln1_bias", "w_qkv", "b_qkv", "rel_bias", "w_proj", "b_proj",
    "ln2_scale", "ln2_bias", "w_mlp1", "b_mlp1", "w_mlp2", "b_mlp2",
)
_BF16_KEYS = ("w_qkv", "w_proj", "w_mlp1", "w_mlp2")
# attn_bwd's window loop: at most this many blocks, each owning a fixed set
# of windows and its own partial sums of the small gradients
MAX_BLOCKS = 264
# floats of a block's partial row: attn_bwd's (dbqkv, dbproj, LN1's two) and
# mlp_bwd's (db2, LN2's two, then db1 for each warp of a warpgroup)
ATTN_PART, MLP_PART = 6, 19
_FWD_ARGS = [_build.PTR] + [_build.INT] * 4 + [_build.PTR]
_BWD_ARGS = [_build.PTR, _build.PTR] + [_build.INT] * 7 + [_build.PTR]
_OCC_ARGS = [_build.INT, _build.INT, ctypes.POINTER(ctypes.c_int)]
# the head dims the kernels take: default_config()'s 16 and
# tpu_optimized_config()'s 64 (Swin heads 1/2/4 at C = 64/128/256)
HEAD_DIMS = (16, 64)
_occupancy: Dict[Tuple[int, int, int], Tuple[int, int, int, int]] = {}


def swin_block_train_reference(
    x: torch.Tensor,
    mask: Optional[torch.Tensor],
    s1: Optional[torch.Tensor],
    s2: Optional[torch.Tensor],
    params: Dict[str, torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """Plain version over window-space inputs x [B_, N, C]; mask [nW, N, N]
    additive or None (window w uses mask[w % nW]); s1/s2 [B_] or None. No
    gradient reaches mask, s1 or s2."""
    mask, s1, s2 = (None if t is None else t.detach() for t in (mask, s1, s2))
    B_, N, C = x.shape
    h = num_heads
    d = C // h
    dt = x.dtype
    hx = layer_norm_chain_plain(x, params["ln1_scale"], params["ln1_bias"])
    qkv = _dense(hx, params["w_qkv"], params["b_qkv"]).to(dt)
    q, k, v = (
        qkv[..., i * C: (i + 1) * C].reshape(B_, N, h, d).transpose(1, 2)
        for i in range(3)
    )
    s = (q.float() @ k.float().transpose(-1, -2)) * d**-0.5
    s = s + params["rel_bias"].float()[None]
    if mask is not None:
        wid = torch.arange(B_, device=x.device) % mask.shape[0]
        s = s + mask.float()[wid][:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.float() @ v.float()).to(dt).transpose(1, 2).reshape(B_, N, C)
    o = _dense(o, params["w_proj"], params["b_proj"])
    if s1 is not None:
        o = o * s1.float()[:, None, None]
    x = x + o.to(dt)
    h2 = layer_norm_chain_plain(x, params["ln2_scale"], params["ln2_bias"])
    y = F.gelu(_dense(h2, params["w_mlp1"], params["b_mlp1"])).to(dt)
    y = _dense(y, params["w_mlp2"], params["b_mlp2"])
    if s2 is not None:
        y = y * s2.float()[:, None, None]
    return x + y.to(dt)


def _ptrs(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() if t is not None else None
                                              for t in tensors])


def _kernel_params(params: Dict[str, torch.Tensor], C: int, h: int) -> List[torch.Tensor]:
    hid = 4 * C
    shapes = {"ln1_scale": (C,), "ln1_bias": (C,), "w_qkv": (C, 3 * C), "b_qkv": (3 * C,),
              "rel_bias": (h, WINDOW_TOKENS, WINDOW_TOKENS), "w_proj": (C, C), "b_proj": (C,),
              "ln2_scale": (C,), "ln2_bias": (C,), "w_mlp1": (C, hid), "b_mlp1": (hid,),
              "w_mlp2": (hid, C), "b_mlp2": (C,)}
    out = []
    for k in PARAM_KEYS:
        t = params[k].detach()
        t = _build.bf16(t) if k in _BF16_KEYS else _build.f32(t)
        _build.check_cuda(t, k, shape=shapes[k])
        out.append(t)
    return out


def _check(x: torch.Tensor, mask, s1, s2, num_heads: int):
    B_, N, C = x.shape
    if (N != WINDOW_TOKENS or C not in (64, 128, 256) or C % num_heads
            or C // num_heads not in HEAD_DIMS):
        raise ValueError(
            f"swin_block_train kernels take 8x8 windows, C in (64, 128, 256) and a head dim "
            f"in {HEAD_DIMS}; got N={N}, C={C}, heads={num_heads}")
    _build.check_cuda(x, "x", torch.bfloat16)
    if (s1 is None) != (s2 is None):
        raise ValueError("swin_block_train takes both drop-path scales or neither")
    if mask is not None:
        _build.check_cuda(mask, "mask", torch.float32, (mask.shape[0], N, N))
    for s in (s1, s2):
        if s is not None:
            _build.check_cuda(s, "drop-path scale", torch.float32, (B_,))


def swin_block_train_fwd(x, mask, s1, s2, kparams: List[torch.Tensor], num_heads: int,
                         save: bool = True):
    """Forward kernel: (out, probabilities [B_, h, 64, 64] bf16, the residual
    stream after the attention branch [B_, 64, C] bf16); without `save` the
    kernel writes neither of the last two and they are None."""
    B_, N, C = x.shape
    out = torch.empty_like(x)
    probs = x1 = None
    if save:
        probs = torch.empty(B_, num_heads, N, N, device=x.device, dtype=torch.bfloat16)
        x1 = torch.empty_like(x)
    nW = mask.shape[0] if mask is not None else 0
    _build.launch(
        "swin_block_train", "fm_swin_block_train_fwd", _FWD_ARGS,
        _ptrs([x, mask, s1, s2, *kparams, out, probs, x1]), B_, C, C // num_heads, nW,
        _build.stream(),
    )
    swin_block_train_fwd.launches += 1
    return out, probs, x1


def wgrad_calls(T: int, C: int) -> List[Tuple[int, int, int]]:
    """(T, M, N) of the weight-gradient products the backward kernel makes,
    in order: h1ᵀ dqkv, oᵀ dout, h2ᵀ dy1, gelu(y1)ᵀ dm."""
    return [(T, C, 3 * C), (T, C, C), (T, C, 4 * C), (T, 4 * C, C)]


def mlp_grid(windows: int, blocks_per_sm: int, sms: int) -> int:
    """mlp_bwd's grid: the blocks the card holds at once, each walking
    windows blockIdx, + grid, ..; no more blocks than windows."""
    return max(1, min(windows, blocks_per_sm * sms))


def bwd_occupancy(C: int, device: int = 0, head_dim: int = 16) -> Tuple[int, int, int, int]:
    """(attn_bwd's dynamic shared memory in bytes, its resident blocks an SM,
    mlp_bwd's bytes, its blocks an SM) at width C and head dim `head_dim` on
    the card, as the runtime reports them."""
    key = (C, head_dim, device)
    if key not in _occupancy:
        info = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            _build.launch("swin_block_train", "fm_swin_block_train_bwd_occupancy", _OCC_ARGS,
                          C, head_dim, info)
        _occupancy[key] = tuple(info)
    return _occupancy[key]


def bwd_launch(x, s1, s2, probs, x1, g, kparams: List[torch.Tensor], num_heads: int,
               mlp_windows: Optional[int] = None):
    """One launch of the backward kernels: (dx in x's dtype, the 13 parameter
    gradients in f32 in PARAM_KEYS order and the kernel's layouts, the f32
    gradient of the residual stream after the attention branch, dx1 [B_, 64,
    C], which mlp_bwd writes and attn_bwd reads). mlp_windows < B_ makes
    mlp_bwd leave the last windows out (their dx1 and stash rows zero): a
    fault for checking that a check sees it."""
    B_, N, C = x.shape
    T = B_ * N
    dev = x.device
    mlp_windows = B_ if mlp_windows is None else mlp_windows
    nb = min(B_, MAX_BLOCKS)
    sms = sm_count(dev.index or 0)
    nbm = mlp_grid(B_, bwd_occupancy(C, dev.index or 0, C // num_heads)[3], sms)
    f32 = dict(device=dev, dtype=torch.float32)
    alloc = torch.empty if mlp_windows == B_ else torch.zeros
    grads = [torch.empty(p.shape, **f32) for p in kparams]
    # the kernel adds mlp_bwd's partials in one sum into b_mlp2's, ln2_scale's,
    # ln2_bias's and b_mlp1's gradients, which lie contiguous in that order
    mlp_small = torch.empty(7 * C, **f32)
    for k, lo, hi in (("b_mlp2", 0, C), ("ln2_scale", C, 2 * C), ("ln2_bias", 2 * C, 3 * C),
                      ("b_mlp1", 3 * C, 7 * C)):
        grads[PARAM_KEYS.index(k)] = mlp_small[lo:hi]
    dx = torch.empty_like(x)
    stash = alloc(16 * C * T, device=dev, dtype=torch.bfloat16)
    dx1 = alloc(T * C, **f32)
    small = torch.empty(nb * ATTN_PART * C, **f32)
    mpart = torch.empty(nbm * MLP_PART * C, **f32)
    dbias = torch.empty(nb * num_heads * N * N, **f32)
    gemm = torch.empty(partial_floats(wgrad_calls(T, C), sms), **f32)
    g = g.contiguous()
    _build.check_cuda(g, "g", x.dtype, x.shape)
    _build.launch(
        "swin_block_train", "fm_swin_block_train_bwd", _BWD_ARGS,
        _ptrs([x, s1, s2, probs, x1, g, *kparams]),
        _ptrs([dx, *grads, stash, dx1, small, mpart, dbias, gemm]), B_, C, C // num_heads, nb,
        nbm, mlp_windows, sms, _build.stream(),
    )
    return dx, grads, dx1.view(B_, N, C)


def swin_block_train_bwd(x, s1, s2, probs, x1, g, kparams: List[torch.Tensor],
                         num_heads: int):
    """Backward kernels: (dx in x's dtype, the 13 parameter gradients in f32
    in PARAM_KEYS order and the kernel's layouts)."""
    dx, grads, _ = bwd_launch(x, s1, s2, probs, x1, g, kparams, num_heads)
    swin_block_train_bwd.launches += 1
    wgrad.launches += 1  # the launch ran the weight gradients' kernel once
    return dx, grads


swin_block_train_fwd.launches = 0
swin_block_train_bwd.launches = 0


class _SwinBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, s1, s2, num_heads, save, *params):
        kparams = _kernel_params(dict(zip(PARAM_KEYS, params)), x.shape[2], num_heads)
        out, probs, x1 = swin_block_train_fwd(x, mask, s1, s2, kparams, num_heads, save)
        ctx.save_for_backward(x, probs, x1, *kparams)
        ctx.s1, ctx.s2, ctx.num_heads = s1, s2, num_heads
        ctx.param_dtypes = [p.dtype for p in params]
        return out

    @staticmethod
    def backward(ctx, g):
        x, probs, x1, *kparams = ctx.saved_tensors
        dx, grads = swin_block_train_bwd(x, ctx.s1, ctx.s2, probs, x1, g.to(x.dtype), kparams,
                                         ctx.num_heads)
        grads = [gr.to(dt) for gr, dt in zip(grads, ctx.param_dtypes)]
        return (dx, None, None, None, None, None, *grads)


def swin_block_train(
    x: torch.Tensor,
    mask: Optional[torch.Tensor],
    s1: Optional[torch.Tensor],
    s2: Optional[torch.Tensor],
    params: Dict[str, torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """Differentiable block over window-space activations x [B_, 64, C]."""
    if x.device.type == "cpu":
        return swin_block_train_reference(x, mask, s1, s2, params, num_heads)
    if mask is not None:
        mask = _build.f32(mask)
    # the scales as tensors of their own (a row of a larger one may sit off the
    # 16-byte alignment the wrappers require)
    s1, s2 = (None if s is None else s.float().clone() for s in (s1, s2))
    _check(x, mask, s1, s2, num_heads)
    ps = [params[k] for k in PARAM_KEYS]
    # a backward reads the probabilities and x1; without one they are not written
    save = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in ps))
    return _SwinBlockTrain.apply(x, mask, s1, s2, num_heads, save, *ps)
