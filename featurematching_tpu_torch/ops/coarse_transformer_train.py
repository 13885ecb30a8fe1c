"""The differentiable coarse LoFTR transformer (kernel K9).

Port of `featurematching_tpu/ops/pallas_coarse_grad.py ·
coarse_transformer_train`, as a `torch.autograd.Function`:

  forward  — K5's stats and apply kernels (`coarse_transformer.
             coarse_layer_with_stats`) for every encoder call: self layers on
             both images as one batch of 2B, cross layers in turn (feat1
             attends the UPDATED feat0). Each call saves (x, src, kv, ks),
             kv and ks being the merged stats the apply kernel read (tiny).
  backward — per call in reverse (`_vjp_bwd`'s loop): the second call of a
             cross layer first, its dsrc the extra cotangent of the updated
             feat0; a self call splits dx + dsrc back into the two images;
             the weight gradients of a cross layer's two calls are summed.
             Each call runs `coarse_layer_backward`: on a CUDA tensor the
             kernels of `csrc/coarse_transformer_train.cu` (apply backward
             over 64-token query tiles recomputing the forward tile on chip,
             a fixed-order merge of the per-head dKᵀV and dK_sum partials,
             stats backward over 64-token source tiles, then the weight
             gradients dW = Aᵀ B of `csrc/wgrad.cuh`), bound on the H100 by
             tensor-core operations; on a CPU tensor its plain twin,
             `coarse_layer_backward_reference`.

The plain twin follows `_apply_bwd_kernel` and then `_stats_bwd_kernel`
at their rounding points: bf16 operands with f32 accumulation; dy2, dy1,
dm1, dopre, dZ, dqf and [dkf | dv] rounded to the activation dtype before
their products; dKᵀV and dK_sum rounded as the stats backward reads them.
The port keeps K_sum as [C] where the TPU kernel keeps KOnes = Kᵀ1 as
[C, C], so the gradient of KOnes becomes its head-summed row sums dK_sum
[G, C] (the stats backward only ever reads those row sums). In f32 the two
are equal; in bf16 the TPU kernel rounds each of dKOnes's entries and sums
them, the port rounds the sum once.

Gradients come back in the parameters' own shapes and dtypes (the torch
weights [out, in]; the K and V halves of the fused [C, 2C] gradient apart).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.coarse_transformer import (
    EPS,
    ROW_TILE,
    TRAIN_WIDTHS,
    WIDTHS,
    LayerValues,
    _check_layer,
    _elu1,
    coarse_layer_with_stats,
    coarse_transformer_supported,
    encoder_reference_with_stats,
    frag_pack,
    frag_unpack,
    pack_layer,
    swizzle128,
    unpack_heads,
)
from featurematching_tpu_torch.ops.wgrad import partial_floats, sm_count, wgrad

_BWD_ARGS = [_build.PTR, _build.PTR] + [_build.INT] * 6 + [_build.PTR]
_OCC_ARGS = [_build.INT] * 2 + [ctypes.POINTER(ctypes.c_int)]
SB_UNIT = 32  # K features of a stats_bwd unit (and as many V features)
# the parameters of one EncoderLayer as the Function takes them
LAYER_PARAMS = ("q_proj.weight", "k_proj.weight", "v_proj.weight", "merge.weight",
                "norm1.weight", "norm1.bias", "mlp1.weight", "mlp2.weight", "norm2.weight",
                "norm2.bias")


class TrainValues(NamedTuple):
    """The weights' transposes that apply_bwd's dY . Wᵀ products take as B
    operands, packed (`frag_pack`): w2ᵀ [C, 2C], w1[C:]ᵀ [2C, C], wmergeᵀ
    [C, C] and [w1[:C]ᵀ ; wqᵀ] [3C, C] (both products of dx in one). Build
    with `train_values`. (stats_bwd reads wkv both ways from one image,
    `stats_bwd_image`.)"""

    w2t: torch.Tensor
    w1mt: torch.Tensor
    wmt: torch.Tensor
    wdxt: torch.Tensor


def train_values(lv: LayerValues) -> TrainValues:
    """The transposed operands of a layer packed as `LayerValues`."""
    wq, wm, w1, w2 = (frag_unpack(w) for w in (lv.wq, lv.wmerge, lv.wmlp1, lv.wmlp2))
    C = wq.shape[0]
    return TrainValues(frag_pack(w2.t().contiguous()), frag_pack(w1[C:].t().contiguous()),
                       frag_pack(wm.t().contiguous()),
                       frag_pack(torch.cat([w1[:C].t(), wq.t()], dim=0).contiguous()))


def stats_bwd_image_plain(wkv: torch.Tensor) -> torch.Tensor:
    """stats_bwd's weight image of one layer from wkv [C, 2C] ([in, out], wk
    | wv): for each unit u of SB_UNIT K features, W_u = [wk[:, unit] |
    wv[:, unit]] ([C, 2 SB_UNIT]) as its boxes W_u[64 b : 64 b + 64]ᵀ ([64
    outputs, 64 inputs], one a 64-row block b of the input) in the 128-byte
    swizzle (`swizzle128`), the units in order: 2 C² values, flat. The kernel
    reads a unit's boxes K-major as the B of [K | V] = src W_u and MN-major
    as the B of dsrc += [dkf | dv] W_uᵀ."""
    C = wkv.shape[0]
    boxes = []
    for u in range(0, C, SB_UNIT):
        wu = torch.cat([wkv[:, u:u + SB_UNIT], wkv[:, C + u:C + u + SB_UNIT]], dim=1)
        boxes += [swizzle128(wu[b:b + 64].t()) for b in range(0, C, 64)]
    return torch.cat(boxes)


def stats_bwd_image_unpack(image: torch.Tensor, C: int) -> torch.Tensor:
    """The inverse of `stats_bwd_image_plain`: wkv [C, 2C]."""
    boxes = image.reshape(C // SB_UNIT, C // 64, 64 * 64)
    units = [torch.cat([swizzle128(box.reshape(64, 64)).reshape(64, 64).t() for box in unit])
             for unit in boxes]  # W_u [C, 2 SB_UNIT]
    return torch.cat([w[:, :SB_UNIT] for w in units] + [w[:, SB_UNIT:] for w in units], dim=1)


@functools.lru_cache(maxsize=None)
def _stats_bwd_index(C: int, device) -> torch.Tensor:
    """For each entry of a layer's stats_bwd image, its index in the packed
    wkv (`frag_pack`)."""
    flat = torch.arange(2 * C * C)
    return stats_bwd_image_plain(frag_unpack(flat.reshape(2 * C // 16, C // 16, 32, 8))).to(device)


def stats_bwd_image(lv: LayerValues) -> torch.Tensor:
    """`stats_bwd_image_plain` of a layer's packed wkv, made on its device by
    one gather and kept on `lv.wkv` while wkv stays at the same version. A
    training step packs its layers anew (`coarse_transformer_train`), so it
    makes one image a layer, which the layer's backward calls share."""
    held = getattr(lv.wkv, "_stats_bwd_image", None)
    if held is not None and held[0] == lv.wkv._version:
        return held[1]
    C = lv.wkv.shape[1] * 16
    image = lv.wkv.reshape(-1)[_stats_bwd_index(C, lv.wkv.device)]
    lv.wkv._stats_bwd_image = (lv.wkv._version, image)
    return image


def stats_bwd_occupancy(C: int, D: int) -> dict:
    """stats_bwd's block as the library reports it at (C, head dim D): its
    dynamic shared memory and the blocks an SM holds (its persistent grid is
    that many an SM, at most one a 64-token tile)."""
    info = (ctypes.c_int * 2)()
    _build.launch("coarse_transformer_train", "fm_coarse_train_stats_bwd_occupancy", _OCC_ARGS,
                  C, D, info)
    return {"smem_bytes": info[0], "blocks_per_sm": info[1]}


def coarse_train_supported(layer_names: Sequence[str], d_model: int, nhead: int,
                           n_tokens: int, forward_only: bool = False) -> bool:
    """The JAX gate (`coarse_transformer_supported`), limited to the (C, head
    dim) pairs the CUDA kernels take: the backward's (TRAIN_WIDTHS), or with
    `forward_only` (no gradient to take) the forward's, K5's (WIDTHS)."""
    return (coarse_transformer_supported(layer_names, d_model, nhead, n_tokens)
            and (d_model, d_model // nhead) in (WIDTHS if forward_only else TRAIN_WIDTHS))


def coarse_layer_forward(x: torch.Tensor, src: torch.Tensor, lv: LayerValues, nhead: int):
    """One encoder call of the forward: (out, kv, ks) (see
    `coarse_transformer.coarse_layer_with_stats`). On a CUDA tensor K5's
    stats and apply kernels, counted in `launches`; on a CPU tensor
    `encoder_reference_with_stats`."""
    if x.device.type == "cpu":
        return encoder_reference_with_stats(x, src, lv, nhead)
    out = coarse_layer_with_stats(x, src, lv, nhead)
    coarse_layer_forward.launches += 1
    return out


coarse_layer_forward.launches = 0


def _ln_stats(v: torch.Tensor):
    mu = v.mean(dim=-1, keepdim=True)
    var = ((v - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-6)
    return (v - mu) * rstd, rstd


def _ln_bwd(dh: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor, scale: torch.Tensor):
    """(dv, dscale, dbias) of a LayerNorm over the last dim; the parameter
    gradients summed over every token."""
    dscale = (dh * xhat).sum(dim=(0, 1))
    dbias = dh.sum(dim=(0, 1))
    dxhat = dh * scale
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), dscale, dbias


def _tok(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def apply_backward_reference(x, kv, ks, g, S: int, lv: LayerValues, nhead: int):
    """`_apply_bwd_kernel`: the forward apply step recomputed from x and the
    stats (kv, ks as `stats_reference` gives them, over S source tokens),
    then its backward for the upstream gradient g. Returns (dx, dkv [G, H, D,
    D] f32, dks [G, C] f32, dwq, dwmerge, dn1s, dn1b, dw1, dw2, dn2s, dn2b)."""
    G, L, C = x.shape
    H, D = nhead, C // nhead
    dt = x.dtype
    wq, wm, w1, w2 = (frag_unpack(w).float() for w in (lv.wq, lv.wmerge, lv.wmlp1, lv.wmlp2))
    KV = unpack_heads(kv, nhead).float()
    ksf = ks.float()
    xf = x.float()
    # the forward, in the forward's rounding
    qf = xf @ wq
    Q = _elu1(qf).to(dt).float()
    Qh = Q.view(G, L, H, D)
    Z = torch.einsum("glhd,ghd->glh", Qh, ksf.view(G, H, D))[..., None]
    opre = torch.einsum("glhd,ghde->glhe", Qh, KV)
    nfac = float(S) / (Z + EPS)
    o = (opre * nfac).reshape(G, L, C).to(dt).float()
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
    dh = dy2 @ w2.t()
    dy1 = (dh * (y1 > 0.0).float()).to(dt).float()
    dw1 = torch.cat([_tok(xf).t() @ _tok(dy1), _tok(msg).t() @ _tok(dy1)], dim=0)
    dx_ffn = dy1 @ w1[:C].t()
    dmsg = dy1 @ w1[C:].t()
    dm1, dn1s, dn1b = _ln_bwd(dmsg, xhat1, rstd1, lv.n1s)
    dm1 = dm1.to(dt).float()
    dwm = _tok(o).t() @ _tok(dm1)
    do = (dm1 @ wm.t()).view(G, L, H, D)
    dopre = (do * nfac).to(dt).float()
    dZ = (-(do * (opre * nfac)) / (Z + EPS)).to(dt).float()
    dzh = dZ.sum(dim=-1)  # [G, L, H]: only dKOnes's row sums are read
    dkv = torch.einsum("glhd,glhe->ghde", Qh, dopre)
    dks = torch.einsum("glhd,glh->ghd", Qh, dzh).reshape(G, C)
    dQ = (torch.einsum("glhe,ghde->glhd", dopre, KV)
          + dzh[..., None] * ksf.view(G, 1, H, D)).reshape(G, L, C)
    dqf = (dQ * torch.where(qf > 0, 1.0, torch.exp(qf))).to(dt).float()
    dwq = _tok(xf).t() @ _tok(dqf)
    dx = (gf + dx_ffn + dqf @ wq.t()).to(dt)
    return dx, dkv, dks, dwq, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b


def stats_backward_reference(src, dkv, dks, lv: LayerValues, nhead: int):
    """`_stats_bwd_kernel`: K and V recomputed from src, dkv [G, H, D, D] and
    dks [G, C] rounded to src's dtype as read. Returns (dsrc, dwkv [C, 2C])."""
    G, S, C = src.shape
    H, D = nhead, C // nhead
    dt = src.dtype
    wkv = frag_unpack(lv.wkv).float()
    dkv = dkv.to(dt).float()
    dks = dks.to(dt).float()
    sf = src.float()
    kv3 = sf @ wkv
    kf = kv3[..., :C]
    K = _elu1(kf).to(dt).float().view(G, S, H, D)
    V = (kv3[..., C:] * (1.0 / S)).to(dt).float().view(G, S, H, D)
    dV = torch.einsum("gshd,ghde->gshe", K, dkv).reshape(G, S, C)
    dK = torch.einsum("gshe,ghde->gshd", V, dkv).reshape(G, S, C) + dks[:, None]
    dkf = dK * torch.where(kf > 0, 1.0, torch.exp(kf))
    dkv3 = torch.cat([dkf.to(dt), (dV * (1.0 / S)).to(dt)], dim=-1).float()
    dwkv = _tok(sf).t() @ _tok(dkv3)
    return (dkv3 @ wkv.t()).to(dt), dwkv


def coarse_layer_backward_reference(x, src, kv, ks, g, lv: LayerValues, nhead: int):
    """The plain twin of one call's backward: `apply_backward_reference`,
    then `stats_backward_reference`. x: [G, L, C] queries, src: [G, S, C]
    keys/values, (kv, ks) the forward's stats, g: the output's gradient.
    Returns (dx, dsrc, (dwq, dwkv, dwmerge, dn1s, dn1b, dw1, dw2, dn2s,
    dn2b)), weights [in, out] in f32."""
    dx, dkv, dks, dwq, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b = apply_backward_reference(
        x, kv, ks, g, src.shape[1], lv, nhead)
    dsrc, dwkv = stats_backward_reference(src, dkv, dks, lv, nhead)
    return dx, dsrc, (dwq, dwkv, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b)


def _ptrs(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                              for t in tensors])


def wgrad_calls(TL: int, TS: int, C: int) -> List[Tuple[int, int, int]]:
    """(T, M, N) of the weight-gradient products K9's (and K10's) backward
    makes, in order, over TL query and TS source tokens: xᵀ dqf, oᵀ dm1,
    xᵀ dy1, msgᵀ dy1, hᵀ dy2 (query side), srcᵀ [dkf | dv] (source side)."""
    return [(TL, C, C), (TL, C, C), (TL, C, 2 * C), (TL, C, 2 * C), (TL, 2 * C, C),
            (TS, C, 2 * C)]


def coarse_layer_backward(x, src, kv, ks, g, lv: LayerValues, lt: TrainValues, nhead: int):
    """One call's backward, as `coarse_layer_backward_reference` returns it.
    On a CUDA tensor the kernels of `csrc/coarse_transformer_train.cu`
    (raises for what they do not take: bf16, (C, head dim) in TRAIN_WIDTHS); on a
    CPU tensor the plain twin."""
    if x.device.type == "cpu":
        return coarse_layer_backward_reference(x, src, kv, ks, g, lv, nhead)
    _check_layer(x, src, lv, nhead, TRAIN_WIDTHS)
    G, L, C = x.shape
    S = src.shape[1]
    D = C // nhead
    g = g.contiguous()
    _build.check_cuda(g, "g", torch.bfloat16, x.shape)
    _build.check_cuda(kv, "kv", torch.bfloat16, (G, C * D))
    _build.check_cuda(ks, "ks", torch.bfloat16, (G, C))
    for t, name, k, n in zip(lt, TrainValues._fields, (C, 2 * C, C, 3 * C), (2 * C, C, C, C),
                             strict=True):
        _build.check_cuda(t, name, torch.bfloat16, (n // 16, k // 16, 32, 8))
    image = stats_bwd_image(lv)
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    tiles = G * -(-L // ROW_TILE)
    sms = sm_count(dev.index or 0)
    calls = wgrad_calls(G * L, G * S, C)
    dx, dsrc = torch.empty_like(x), torch.empty_like(src)
    dwq, dwm = torch.empty(C, C, **f32), torch.empty(C, C, **f32)
    dwkv = torch.empty(C, 2 * C, **f32)
    dln = torch.empty(4 * C, **f32)
    dw1, dw2 = torch.empty(2 * C, 2 * C, **f32), torch.empty(2 * C, C, **f32)
    stash = torch.empty((9 * G * L + 2 * G * S) * C, device=dev, dtype=torch.bfloat16)
    part_ln, part_kv, part_ks = (torch.empty(tiles * n, **f32) for n in (4 * C, C * D, C))
    dkv = torch.empty(G * C * D, device=dev, dtype=torch.bfloat16)
    dks = torch.empty(G * C, device=dev, dtype=torch.bfloat16)
    gemm = torch.empty(partial_floats(calls, sms), **f32)
    _build.launch(
        "coarse_transformer_train", "fm_coarse_train_bwd", _BWD_ARGS,
        _ptrs([x, src, kv, ks, g, *lv, *lt, image]),
        _ptrs([dx, dsrc, dwq, dwkv, dwm, dln, dw1, dw2, stash, part_ln, part_kv, part_ks, dkv,
               dks, gemm]),
        G, L, S, C, D, sms, _build.stream(),
    )
    coarse_layer_backward.launches += 1
    wgrad.launches += 1  # the launch ran the weight gradients' kernel once
    dn1s, dn1b, dn2s, dn2b = dln.view(4, C)
    return dx, dsrc, (dwq, dwkv, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b)


coarse_layer_backward.launches = 0


def _call_plan(layer_names: Sequence[str]) -> List[Tuple[str, int]]:
    """(kind, layer index) of each forward call: a self layer is one call, a
    cross layer two (crossA updates feat0, crossB feat1)."""
    plan = []
    for i, name in enumerate(layer_names):
        plan += [("self", i)] if name == "self" else [("crossA", i), ("crossB", i)]
    return plan


def _forward(feat0, feat1, layers, layer_names, nhead):
    """The stack through `coarse_layer_forward`: ((feat0, feat1), the
    calls' (x, src, kv, ks) in forward order; src None for a self call)."""
    B = feat0.shape[0]
    calls = []
    for lv, name in zip(layers, layer_names, strict=True):
        if name == "self":
            both = torch.cat([feat0, feat1], dim=0)
            out, kv, ks = coarse_layer_forward(both, both, lv, nhead)
            calls.append((both, None, kv, ks))
            feat0, feat1 = out[:B], out[B:]
        else:
            f0n, kv1, ks1 = coarse_layer_forward(feat0, feat1, lv, nhead)
            calls.append((feat0, feat1, kv1, ks1))
            f1n, kv0, ks0 = coarse_layer_forward(feat1, f0n, lv, nhead)
            calls.append((feat1, f0n, kv0, ks0))
            feat0, feat1 = f0n, f1n
    return (feat0, feat1), calls


def _param_grads(wg, C: int, dtypes) -> List[torch.Tensor]:
    """A layer's summed (dwq, dwkv, dwmerge, dn1s, dn1b, dw1, dw2, dn2s,
    dn2b) as gradients of LAYER_PARAMS."""
    dwq, dwkv, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b = wg
    grads = [dwq.t(), dwkv[:, :C].t(), dwkv[:, C:].t(), dwm.t(), dn1s, dn1b, dw1.t(), dw2.t(),
             dn2s, dn2b]
    return [gr.contiguous().to(dt) for gr, dt in zip(grads, dtypes)]


class CoarseTransformerTrain(torch.autograd.Function):
    """(feat0, feat1) -> the stack's (feat0, feat1), differentiable in the
    features and in every layer's LAYER_PARAMS (passed flat after the packed
    operands)."""

    @staticmethod
    def forward(ctx, feat0, feat1, layer_names, nhead, layers, tvalues, *params):
        (out0, out1), calls = _forward(feat0, feat1, layers, layer_names, nhead)
        ctx.save_for_backward(*[t for call in calls for t in call])
        ctx.layer_names, ctx.nhead, ctx.layers, ctx.tvalues = layer_names, nhead, layers, tvalues
        ctx.shape = feat0.shape
        ctx.param_dtypes = [p.dtype for p in params]
        return out0, out1

    @staticmethod
    def backward(ctx, df0, df1):
        saved = ctx.saved_tensors
        calls = [saved[i:i + 4] for i in range(0, len(saved), 4)]
        x0 = calls[0][0]
        dt, B, C = x0.dtype, ctx.shape[0], ctx.shape[-1]
        df0, df1 = (torch.zeros(ctx.shape, dtype=dt, device=x0.device) if d is None
                    else d.to(dt).contiguous() for d in (df0, df1))
        wgrads = [None] * len(ctx.layer_names)
        pending = None  # dsrc of a crossB call: the extra cotangent of the updated feat0
        for (x, src, kv, ks), (kind, li) in zip(reversed(calls),
                                                reversed(_call_plan(ctx.layer_names))):
            lv, lt = ctx.layers[li], ctx.tvalues[li]
            if kind == "self":
                dx, dsrc, wg = coarse_layer_backward(x, x, kv, ks, torch.cat([df0, df1]), lv, lt,
                                                     ctx.nhead)
                df0, df1 = (dx + dsrc).split(B)
            elif kind == "crossB":
                dx, dsrc, wg = coarse_layer_backward(x, src, kv, ks, df1, lv, lt, ctx.nhead)
                df1, pending = dx, dsrc
            else:
                dout = df0 if pending is None else df0 + pending
                pending = None
                dx, dsrc, wg = coarse_layer_backward(x, src, kv, ks, dout, lv, lt, ctx.nhead)
                df0, df1 = dx, df1 + dsrc
            acc = wgrads[li]
            wgrads[li] = wg if acc is None else tuple(a + b for a, b in zip(acc, wg))
        n = len(LAYER_PARAMS)
        grads = [gr for i, wg in enumerate(wgrads)
                 for gr in _param_grads(wg, C, ctx.param_dtypes[i * n:(i + 1) * n])]
        return (df0, df1, None, None, None, None, *grads)


def layer_params(tf) -> List[torch.Tensor]:
    """LAYER_PARAMS of every layer of a `LocalFeatureTransformer`, flat."""
    out = []
    for i in range(len(tf.layer_names)):
        layer = getattr(tf, f"layer_{i}")
        out += [layer.get_parameter(name) for name in LAYER_PARAMS]
    return out


def coarse_transformer_train(feat0: torch.Tensor, feat1: torch.Tensor, tf,
                             layer_names: Sequence[str], nhead: int):
    """The differentiable stack over `tf` (a `models.transformer.
    LocalFeatureTransformer`). feat*: [B, N, C]. Without a gradient to
    compute (no_grad, or nothing requiring one) it runs the same forward and
    saves nothing. The weights are packed anew every call, not through
    `pack_layers`' cache: the fused optimizer step writes them without
    bumping the version counters that cache is keyed on."""
    layer_names = tuple(layer_names)
    if len(tf.layer_names) != len(layer_names):
        raise ValueError(f"{len(tf.layer_names)} layers for {len(layer_names)} layer names")
    params = layer_params(tf)
    feat0, feat1 = feat0.contiguous(), feat1.contiguous()
    layers = tuple(pack_layer(getattr(tf, f"layer_{i}"), feat0.dtype)
                   for i in range(len(layer_names)))
    wants = feat0.requires_grad or feat1.requires_grad or any(p.requires_grad for p in params)
    if not (torch.is_grad_enabled() and wants):
        return _forward(feat0, feat1, layers, layer_names, nhead)[0]
    tvalues = tuple(train_values(lv) for lv in layers)
    return CoarseTransformerTrain.apply(feat0, feat1, layer_names, nhead, layers, tvalues,
                                        *params)
