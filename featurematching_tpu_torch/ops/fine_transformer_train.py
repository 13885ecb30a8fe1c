"""The differentiable fine window transformer (kernel K10).

Port of `featurematching_tpu/ops/pallas_fine_grad.py ·
fine_transformer_train`, as a `torch.autograd.Function`:

  forward  — one `fine_stage.fine_layer_forward` a layer (K6's kernel with
             that layer alone and no mix, as the JAX package's `_fwd_impl`
             runs it), saving each layer's input pair and the final pair.
  backward — the layers in reverse (`_vjp_bwd`), each through
             `layer_backward`: a self layer is one encoder call over both
             sides' windows stacked (its dx, into which the call adds
             dsrc, split back into the two sides); a cross layer (o0 = enc(a0, a1), o1 = enc(a1, o0)) is
             two calls, the second first, its dsrc added to d0 before the
             first (`_fine_bwd_kernel`'s order). The second call's source
             is the saved o0, which is the JAX kernel's `has_o0` without a
             replay. The weight gradients of a layer's calls are summed.
             Each call runs `fine_layer_backward`: on a CUDA tensor the
             kernels of `csrc/fine_transformer_train.cu` (a window stage,
             one window a warpgroup, that recomputes the window's forward
             and runs its backward on `wgmma` with the layer's weights
             resident in shared memory as `train_image`, then the weight
             gradients dW = Aᵀ B of `csrc/wgrad.cuh`); on a CPU tensor its
             plain twin, `fine_layer_backward_reference`.

The plain twin follows `_enc_fwd_stash` and `_enc_bwd` at their rounding
points: bf16 operands with f32 accumulation; dy2, dy1, dm1, dA, dZ, dKV, dqf
and [dkf | dv] rounded to the activation dtype before their products. As in
K9 (`coarse_transformer_train`), only the row sums of dKOnes are kept, as
dK_sum [C], rounded once where the TPU kernel rounds each of dKOnes's
entries; in f32 the two are equal. As in the TPU kernel, a layer's
cotangents stay in f32 between its calls (each call takes g and returns dx
and dsrc in f32) and are rounded to the activation dtype at the layer's end.

Gradients come back in the parameters' own shapes and dtypes (the torch
weights [out, in]; the K and V halves of the fused [C, 2C] gradient apart).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.coarse_transformer import (
    EPS,
    LayerValues,
    _elu1,
    check_layer_values,
    frag_unpack,
    pack_layer,
    swizzle128,
)
from featurematching_tpu_torch.ops.coarse_transformer_train import (
    LAYER_PARAMS,
    _ln_bwd,
    _ln_stats,
    _param_grads,
    _ptrs,
    _tok,
    layer_params,
)
from featurematching_tpu_torch.ops.fine_stage import (
    C_KERNEL,
    MAX_TAPS,
    TRAIN_HEAD_DIMS,
    _image_shapes,
    fine_layer_forward,
    layer_image,
)
from featurematching_tpu_torch.ops.wgrad import partial_floats, sm_count, wgrad

_BWD_ARGS = [_build.PTR, _build.PTR] + [_build.INT] * 5 + [_build.PTR]
_OCC_ARGS = [_build.INT] * 3 + [ctypes.POINTER(ctypes.c_int)]
BOX = 64  # a box of the weight image: [out, 64] columns of the input


def _dfeat(v: torch.Tensor) -> torch.Tensor:
    """The derivative of elu(v) + 1."""
    return torch.where(v > 0, 1.0, torch.exp(v))


def _self_call(x, src) -> bool:
    """src is x: the kernel's test, by the tensors' memory."""
    return src.data_ptr() == x.data_ptr()


def fine_layer_backward_reference(x, src, g, lv: LayerValues, nhead: int):
    """The plain twin of one encoder call's backward: the forward recomputed
    from x [G, N, C] (queries) and src [G, N, C] (keys/values) of G windows,
    then its backward for the output's gradient g (f32). Returns (dx, dsrc,
    (dwq, dwkv, dwmerge, dn1s, dn1b, dw1, dw2, dn2s, dn2b)), all f32, the
    gradients [in, out]; in a self call (src is x) dx is the whole gradient
    of x, dx + dsrc, and dsrc None."""
    G, N, C = x.shape
    H, D = nhead, C // nhead
    dt = x.dtype
    wq, wkv, wm, w1, w2 = (frag_unpack(w).float()
                           for w in (lv.wq, lv.wkv, lv.wmerge, lv.wmlp1, lv.wmlp2))
    xf, sf = x.float(), src.float()
    # the forward, in K6's rounding
    qf = xf @ wq
    Qh = _elu1(qf).to(dt).float().view(G, N, H, D)
    kv3 = sf @ wkv
    kf = kv3[..., :C]
    K = _elu1(kf).to(dt).float()
    Kh = K.view(G, N, H, D)
    Vh = (kv3[..., C:] * (1.0 / N)).to(dt).float().view(G, N, H, D)
    KV = torch.einsum("gnhd,gnhe->ghde", Kh, Vh).to(dt).float()
    ks = K.sum(dim=1).to(dt).float()
    Z = torch.einsum("gnhd,ghd->gnh", Qh, ks.view(G, H, D))[..., None]
    A = torch.einsum("gnhd,ghde->gnhe", Qh, KV)
    nfac = float(N) / (Z + EPS)
    o = (A * nfac).reshape(G, N, C).to(dt).float()
    m1 = (o @ wm).to(dt).float()
    xhat1, rstd1 = _ln_stats(m1)
    msg = (xhat1 * lv.n1s + lv.n1b).to(dt).float()
    y1 = xf @ w1[:C] + msg @ w1[C:]
    h = torch.relu(y1).to(dt).float()
    y2 = (h @ w2).to(dt).float()
    xhat2, rstd2 = _ln_stats(y2)
    # the backward
    gf = g.float()
    dy2, dn2s, dn2b = _ln_bwd(gf, xhat2, rstd2, lv.n2s)
    dy2 = dy2.to(dt).float()
    dw2 = _tok(h).t() @ _tok(dy2)
    dy1 = ((dy2 @ w2.t()) * (y1 > 0.0).float()).to(dt).float()
    dw1 = torch.cat([_tok(xf).t() @ _tok(dy1), _tok(msg).t() @ _tok(dy1)], dim=0)
    dmsg = dy1 @ w1[C:].t()
    dm1, dn1s, dn1b = _ln_bwd(dmsg, xhat1, rstd1, lv.n1s)
    dm1 = dm1.to(dt).float()
    dwm = _tok(o).t() @ _tok(dm1)
    do = (dm1 @ wm.t()).view(G, N, H, D)
    dA = (do * nfac).to(dt).float()
    dZ = (-(do * (A * nfac)) / (Z + EPS)).to(dt).float()
    dzh = dZ.sum(dim=-1)  # [G, N, H]: only dKOnes's row sums are read
    dKV = torch.einsum("gnhd,gnhe->ghde", Qh, dA).to(dt).float()
    dks = torch.einsum("gnhd,gnh->ghd", Qh, dzh).reshape(G, C).to(dt).float()
    dQ = torch.einsum("gnhe,ghde->gnhd", dA, KV) + dzh[..., None] * ks.view(G, 1, H, D)
    dqf = (dQ.reshape(G, N, C) * _dfeat(qf)).to(dt).float()
    dwq = _tok(xf).t() @ _tok(dqf)
    dx = gf + dy1 @ w1[:C].t() + dqf @ wq.t()
    dV = torch.einsum("gnhd,ghde->gnhe", Kh, dKV).reshape(G, N, C)
    dK = torch.einsum("gnhe,ghde->gnhd", Vh, dKV).reshape(G, N, C) + dks[:, None]
    dkv3 = torch.cat([(dK * _dfeat(kf)).to(dt), (dV * (1.0 / N)).to(dt)], dim=-1).float()
    dwkv = _tok(sf).t() @ _tok(dkv3)
    dsrc = dkv3 @ wkv.t()
    wg = (dwq, dwkv, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b)
    return (dx + dsrc, None, wg) if _self_call(x, src) else (dx, dsrc, wg)


def train_image_plain(wq: torch.Tensor, wkv: torch.Tensor, wmerge: torch.Tensor,
                      wmlp1: torch.Tensor, wmlp2: torch.Tensor) -> torch.Tensor:
    """The window stage's weight image of one layer from weights [in, out]
    (wq [C, C], wkv [C, 2C], wmerge [C, C], wmlp1 [2C, 2C], wmlp2 [2C, C]):
    each weight, in that order, as its boxes W[64 b : 64 b + 64]ᵀ ([out,
    64], one a 64-row block b of its input) in the 128-byte swizzle, one
    flat tensor of 10 C² values. The kernel reads a box K-major for the
    forward's x W and MN-major for the backward's dY Wᵀ."""
    return torch.cat([swizzle128(w[b:b + BOX].t()) for w in (wq, wkv, wmerge, wmlp1, wmlp2)
                      for b in range(0, w.shape[0], BOX)])


def train_image_unpack(image: torch.Tensor, C: int):
    """The inverse of `train_image_plain`: (wq, wkv, wmerge, wmlp1, wmlp2) [in, out]."""
    out, at = [], 0
    for k, n in _image_shapes(C):
        boxes = []
        for _ in range(0, k, BOX):
            boxes.append(swizzle128(image[at:at + n * BOX].reshape(n, BOX)).reshape(n, BOX).t())
            at += n * BOX
        out.append(torch.cat(boxes))
    return tuple(out)


def train_image(lv: LayerValues) -> torch.Tensor:
    """`train_image_plain` of a layer's packed weights (`fine_stage.
    layer_image`, kept on `lv.wq`; a training step packs its layers anew,
    `fine_transformer_train`, so it makes one image a layer)."""
    return layer_image(lv, train_image_plain, "_train_image")


def _check(x, src, g, lv: LayerValues, nhead: int) -> None:
    G, N, C = x.shape
    if (C != C_KERNEL or C % nhead or C // nhead not in TRAIN_HEAD_DIMS
            or not 1 <= N <= MAX_TAPS):
        raise ValueError(
            f"fine_transformer_train kernel takes C={C_KERNEL}, head dim in {TRAIN_HEAD_DIMS} "
            f"and at most {MAX_TAPS} taps; got C={C}, heads={nhead}, N={N}")
    _build.check_cuda(x, "x", torch.bfloat16)
    _build.check_cuda(src, "src", torch.bfloat16, x.shape)
    _build.check_cuda(g, "g", torch.float32, x.shape)
    check_layer_values(lv, C)


def wgrad_calls(T: int, C: int) -> List[Tuple[int, int, int]]:
    """(T, M, N) of the weight-gradient products the backward kernel makes
    over T = G N tokens, in order: xᵀ dqf, srcᵀ [dkf | dv], oᵀ dm1, xᵀ dy1,
    msgᵀ dy1, hᵀ dy2."""
    return [(T, C, C), (T, C, 2 * C), (T, C, C), (T, C, 2 * C), (T, C, 2 * C), (T, 2 * C, C)]


def bwd_launch(x, src, g, lv: LayerValues, nhead: int, run: Optional[int] = None):
    """One launch of `csrc/fine_transformer_train.cu` on CUDA tensors (checked:
    raises for what the kernels do not take, bf16 x and src, f32 g, C = 64,
    a head dim in TRAIN_HEAD_DIMS, at most MAX_TAPS taps), returned as
    `fine_layer_backward` returns it. run < G makes the window stage leave
    the last windows out (their dx, dsrc and stash rows zero): a fault for
    checking that a check sees it."""
    g = g.contiguous()
    _check(x, src, g, lv, nhead)
    G, N, C = x.shape
    run = G if run is None else run
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    alloc = torch.empty if run == G else torch.zeros
    sms = sm_count(dev.index or 0)
    calls = wgrad_calls(G * N, C)
    dx = alloc(x.shape, **f32)
    dsrc = None if _self_call(x, src) else alloc(x.shape, **f32)
    dwq, dwm = torch.empty(C, C, **f32), torch.empty(C, C, **f32)
    dwkv = torch.empty(C, 2 * C, **f32)
    dln = torch.empty(4 * C, **f32)
    dw1, dw2 = torch.empty(2 * C, 2 * C, **f32), torch.empty(2 * C, C, **f32)
    stash = alloc(11 * G * N * C, device=dev, dtype=torch.bfloat16)
    part_ln = torch.empty(sms * 4 * C, **f32)  # a row a block, one block an SM at most
    gemm = torch.empty(partial_floats(calls, sms), **f32)
    _build.launch(
        "fine_transformer_train", "fm_fine_train_bwd", _BWD_ARGS,
        _ptrs([x, src, g, train_image(lv), lv.n1s, lv.n1b, lv.n2s]),
        _ptrs([dx, dsrc, dwq, dwkv, dwm, dln, dw1, dw2, stash, part_ln, gemm]),
        G, N, C // nhead, run, sms, _build.stream(),
    )
    dn1s, dn1b, dn2s, dn2b = dln.view(4, C)
    return dx, dsrc, (dwq, dwkv, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b)


def fine_layer_backward(x, src, g, lv: LayerValues, nhead: int):
    """One encoder call's backward, as `fine_layer_backward_reference`
    returns it (a self call: dx + dsrc as dx, dsrc None). On a CUDA tensor
    the kernels of `csrc/fine_transformer_train.cu` (`bwd_launch`), counted
    in `launches`; on a CPU tensor the plain twin."""
    if x.device.type == "cpu":
        return fine_layer_backward_reference(x, src, g, lv, nhead)
    out = bwd_launch(x, src, g, lv, nhead)
    fine_layer_backward.launches += 1
    wgrad.launches += 1  # the launch ran the weight gradients' kernel once
    return out


fine_layer_backward.launches = 0


def window_bwd_occupancy(nhead: int, G: int) -> dict:
    """The window stage's block on the current card at head dim C // nhead,
    as its library reports it: windows in flight a block (one a warpgroup),
    dynamic shared memory (bytes), blocks an SM and the grid for G windows."""
    info = (ctypes.c_int * 4)()
    dev = torch.cuda.current_device()
    _build.launch("fine_transformer_train", "fm_fine_train_bwd_occupancy", _OCC_ARGS,
                  C_KERNEL // nhead, G, sm_count(dev), info)
    return dict(warpgroups=info[0], smem_bytes=info[1], blocks_per_sm=info[2], grid=info[3])


def layer_backward(name: str, x0, x1, o0, d0, d1, lv: LayerValues, nhead: int):
    """One layer's backward from its input pair (x0, x1), its first output
    o0 = enc(x0, x1) (used by a cross layer) and the output pair's gradient
    (d0, d1), one `fine_layer_backward` an encoder call. Returns (d0, d1) in
    x0's dtype and the layer's 9 summed gradients; inside the layer the
    cotangents stay in f32, as in the TPU kernel."""
    bwd = fine_layer_backward
    dt = x0.dtype
    if name == "self":
        G = x0.shape[0]
        both = torch.cat([x0, x1], dim=0)
        dx, _, wg = bwd(both, both, torch.cat([d0, d1], dim=0).float(), lv, nhead)
        d0, d1 = dx.to(dt).split(G)
        return d0, d1, wg
    # o1 = enc(x1, o0) first: its dsrc is a cotangent of o0 = enc(x0, x1)
    dx1, do0, wg1 = bwd(x1, o0, d1.float().contiguous(), lv, nhead)
    dx0, dsrc1, wg0 = bwd(x0, x1, d0.float() + do0, lv, nhead)
    return dx0.to(dt), (dx1 + dsrc1).to(dt), tuple(a + b for a, b in zip(wg1, wg0))


def _forward(w0, w1, layers, layer_names, nhead):
    """The stack through `fine_layer_forward`: ((w0, w1), every layer's input
    pair and the final pair, flat)."""
    pairs = []
    for lv, name in zip(layers, layer_names, strict=True):
        pairs += [w0, w1]
        w0, w1 = fine_layer_forward(w0, w1, lv, name, nhead)
    return (w0, w1), pairs + [w0, w1]


class FineTransformerTrain(torch.autograd.Function):
    """(w0, w1) -> the stack's (w0, w1), differentiable in the windows and
    in every layer's LAYER_PARAMS (passed flat after the packed operands)."""

    @staticmethod
    def forward(ctx, w0, w1, layer_names, nhead, layers, *params):
        out, saved = _forward(w0, w1, layers, layer_names, nhead)
        ctx.save_for_backward(*saved)
        ctx.layer_names, ctx.nhead, ctx.layers = layer_names, nhead, layers
        ctx.param_dtypes = [p.dtype for p in params]
        return out

    @staticmethod
    def backward(ctx, d0, d1):
        saved = ctx.saved_tensors
        x = saved[0]
        dt, C = x.dtype, x.shape[-1]
        d0, d1 = (torch.zeros_like(x) if d is None else d.to(dt).contiguous() for d in (d0, d1))
        wgrads = [None] * len(ctx.layer_names)
        for i in range(len(ctx.layer_names) - 1, -1, -1):
            x0, x1, o0 = saved[2 * i], saved[2 * i + 1], saved[2 * i + 2]
            d0, d1, wgrads[i] = layer_backward(ctx.layer_names[i], x0, x1, o0, d0, d1,
                                               ctx.layers[i], ctx.nhead)
        n = len(LAYER_PARAMS)
        grads = [gr for i, wg in enumerate(wgrads)
                 for gr in _param_grads(wg, C, ctx.param_dtypes[i * n:(i + 1) * n])]
        return (d0, d1, None, None, None, *grads)


def fine_transformer_train(w0: torch.Tensor, w1: torch.Tensor, tf,
                           layer_names: Sequence[str], nhead: int):
    """The differentiable stack over `tf` (a `models.transformer.
    LocalFeatureTransformer`). w*: [B_, N, C] windows. Without a gradient to
    compute (no_grad, or nothing requiring one) it runs the same forward and
    saves nothing. The weights are packed anew every call, as in
    `coarse_transformer_train`: the fused optimizer step writes them without
    bumping their version counters."""
    layer_names = tuple(layer_names)
    if len(tf.layer_names) != len(layer_names):
        raise ValueError(f"{len(tf.layer_names)} layers for {len(layer_names)} layer names")
    params = layer_params(tf)
    w0, w1 = w0.contiguous(), w1.contiguous()
    layers = tuple(pack_layer(getattr(tf, f"layer_{i}"), w0.dtype)
                   for i in range(len(layer_names)))
    wants = w0.requires_grad or w1.requires_grad or any(p.requires_grad for p in params)
    if not (torch.is_grad_enabled() and wants):
        return _forward(w0, w1, layers, layer_names, nhead)[0]
    return FineTransformerTrain.apply(w0, w1, layer_names, nhead, layers, *params)
