"""The coarse LoFTR transformer as two kernels a layer: stats, then apply.

Port of `featurematching_tpu/ops/pallas_coarse_transformer.py ·
coarse_transformer_fused`. Linear attention factorises over tokens, so each
encoder layer (models/transformer.EncoderLayer) is

  stats — K = elu(src·wk)+1 and V = src·wv / S per token, reduced to each
          head's KᵀV [D, D] and K_sum [C];
  apply — per query token: Q = elu(x·wq)+1, the per-head normaliser and
          output from the stats, merge + LN1, the split-weight FFN
          x·wmlp1[:C] + msg·wmlp1[C:], ReLU, ·wmlp2, LN2, residual.

On a CUDA tensor `coarse_transformer_fused` launches `csrc/coarse_transformer.cu`
for every layer (stats over runs of 64-token tiles on wgmma, a block a head
group with the group's columns of the layer's `stats_image` held in shared
memory, with per-run partials and a merge in a fixed order; then apply over
pairs of 64-token row tiles on wgmma, the weights streamed once a pair from
the layer's `apply_image`; bf16 tensor cores, bound by tensor-core
operations); on a CPU tensor it runs `coarse_transformer_reference`.

Both follow the TPU kernel's rounding points, which differ from the flax
stack's in bf16 only: K and V/S are rounded after the f32 product and its
feature map, K_sum is rounded to the activation dtype before the normaliser
product, and o·(S / (Z + eps)) is formed in f32 and rounded once.

Self layers run both images as one batch of 2B; cross layers run in turn,
so feat1 attends the UPDATED feat0, as the reference does.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple, Sequence, Tuple

import torch

from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain_plain

EPS = 1e-6
ROW_TILE = 64  # token rows of one stats tile and of one apply warpgroup's tile
APPLY_HIDDEN_CHUNK = 128  # FFN hidden columns the apply kernel takes at a time
STATS_GROUP = 128  # K features of a stats block's head group (and as many V features)
# (C, head dim) the forward's kernels take (the backward's, K9's: `TRAIN_WIDTHS`)
WIDTHS = ((128, 16), (128, 32), (128, 64), (256, 16), (256, 32), (256, 64))
TRAIN_WIDTHS = ((128, 16), (128, 32), (256, 16), (256, 32), (256, 64))
_STATS_ARGTYPES = [_build.PTR] * 6 + [_build.INT] * 6 + [_build.PTR]
_APPLY_ARGTYPES = [_build.PTR] * 9 + [_build.INT] * 5 + [_build.PTR]
_RING_ARGTYPES = [_build.PTR] * 3 + [_build.INT, _build.PTR]


@functools.lru_cache(maxsize=None)
def _frag_index(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, column) within a 16x16 tile of each lane's 8 values of a
    tensor-core B fragment (mma.m16n8k16, csrc/tiles.cuh): [32, 8] each."""
    lane = torch.arange(32, device=device)[:, None]
    e = torch.arange(8, device=device)[None, :]
    return 2 * (lane % 4) + (e & 1) + 8 * ((e >> 1) & 1), lane // 4 + 8 * (e >> 2)


def frag_pack(w: torch.Tensor) -> torch.Tensor:
    """A weight [K, N] ([in, out]) in fragment order, [N/16, K/16, 32, 8]:
    16-column strips of 16-row tiles, each lane's 8 values of a tile
    contiguous, so a warp loads a tile with one 16-byte load a lane."""
    K, N = w.shape
    tiles = w.reshape(K // 16, 16, N // 16, 16).permute(2, 0, 1, 3)  # [nt, kt, 16, 16]
    rows, cols = _frag_index(w.device)
    return tiles[:, :, rows, cols].contiguous()


def frag_unpack(p: torch.Tensor) -> torch.Tensor:
    """The inverse of `frag_pack`: [N/16, K/16, 32, 8] -> [K, N]."""
    NT, KT = p.shape[:2]
    tiles = torch.empty(NT, KT, 16, 16, dtype=p.dtype, device=p.device)
    rows, cols = _frag_index(p.device)
    tiles[:, :, rows, cols] = p
    return tiles.permute(1, 2, 0, 3).reshape(KT * 16, NT * 16)


class LayerValues(NamedTuple):
    """One EncoderLayer as kernel operands: weights [in, out] in the
    activation dtype and in fragment order (`frag_pack`; wkv = wk ‖ wv,
    [C, 2C]), LN parameters in float32. Build with `layer_values`."""

    wq: torch.Tensor
    wkv: torch.Tensor
    wmerge: torch.Tensor
    n1s: torch.Tensor
    n1b: torch.Tensor
    wmlp1: torch.Tensor
    wmlp2: torch.Tensor
    n2s: torch.Tensor
    n2b: torch.Tensor


def layer_values(wq, wkv, wmerge, n1s, n1b, wmlp1, wmlp2, n2s, n2b) -> LayerValues:
    """LayerValues from weights [in, out] (packed here, in their dtype) and
    LN parameters."""
    return LayerValues(frag_pack(wq), frag_pack(wkv), frag_pack(wmerge), n1s, n1b,
                       frag_pack(wmlp1), frag_pack(wmlp2), n2s, n2b)


def pack_layer(layer, dtype: torch.dtype) -> LayerValues:
    """The counterpart of the JAX package's `_layer_values` for one
    `models.transformer.EncoderLayer` (torch weights are [out, in]); the
    operands are copies, detached from the parameters."""

    def w(lin):
        return lin.weight.detach().t().to(dtype).contiguous()

    def f(t):
        return t.detach().float().clone()

    wkv = torch.cat([layer.k_proj.weight.detach().t(), layer.v_proj.weight.detach().t()], dim=1)
    return layer_values(
        w(layer.q_proj), wkv.to(dtype), w(layer.merge),
        f(layer.norm1.weight), f(layer.norm1.bias), w(layer.mlp1), w(layer.mlp2),
        f(layer.norm2.weight), f(layer.norm2.bias),
    )


def kstep_tiles(w: torch.Tensor) -> torch.Tensor:
    """A weight [..., K, N] ([in, out]) as the apply and stats kernels'
    shared-memory image of a B operand (csrc/wgmma.cuh): K / 16 k-steps, each [N, 16]
    K-major in 8x8 core matrices of 128 contiguous bytes, (n // 8, k // 8)
    in row-major order. [..., K * N], flat per leading index."""
    *lead, K, N = w.shape
    t = w.reshape(*lead, K // 16, 2, 8, N // 8, 8)
    n = len(lead)
    return t.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2).reshape(*lead, K * N)


def kstep_untile(t: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of `kstep_tiles`: [..., K * N] -> [..., K, N]."""
    *lead, _ = t.shape
    n = len(lead)
    u = t.reshape(*lead, K // 16, N // 8, 2, 8, 8)
    return u.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3).reshape(*lead, K, N)


def swizzle128(box: torch.Tensor) -> torch.Tensor:
    """A [rows, 64] box in the 128-byte swizzle, flat: row r's 16-byte chunk
    c (8 values) at chunk position c ^ (r % 8), as a tensor copy with
    CU_TENSOR_MAP_SWIZZLE_128B writes it. Its own inverse."""
    rows = box.shape[0]
    r = torch.arange(rows, device=box.device)[:, None]
    chunk = torch.arange(8, device=box.device)[None, :] ^ (r % 8)
    return box.reshape(rows, 8, 8)[r, chunk].reshape(-1)


def apply_image_plain(wq: torch.Tensor, wmerge: torch.Tensor, wmlp1: torch.Tensor,
                      wmlp2: torch.Tensor) -> torch.Tensor:
    """The apply kernel's weight image of one layer from weights [in, out]:
    the slices in the order the kernel reads them, one flat tensor. wq and
    wmerge ([C, C]), then for each 128-column chunk c of wmlp1 ([2C, 2C]) its
    columns [2C, 128] followed by wmlp2's rows [128, C] of that chunk, each
    as `kstep_tiles`: 8 C^2 values."""
    C = wq.shape[0]
    chunks = 2 * C // APPLY_HIDDEN_CHUNK
    w1 = wmlp1.reshape(2 * C, chunks, APPLY_HIDDEN_CHUNK).transpose(0, 1)
    w2 = wmlp2.reshape(chunks, APPLY_HIDDEN_CHUNK, C)
    ffn = torch.cat([kstep_tiles(w1), kstep_tiles(w2)], dim=1)
    return torch.cat([kstep_tiles(wq), kstep_tiles(wmerge), ffn.reshape(-1)])


def apply_image_unpack(image: torch.Tensor, C: int):
    """The inverse of `apply_image_plain`: (wq, wmerge, wmlp1, wmlp2) [in, out]."""
    chunks, hc = 2 * C // APPLY_HIDDEN_CHUNK, APPLY_HIDDEN_CHUNK
    wq = kstep_untile(image[:C * C], C, C)
    wmerge = kstep_untile(image[C * C:2 * C * C], C, C)
    ffn = image[2 * C * C:].reshape(chunks, 3 * C * hc)
    w1 = kstep_untile(ffn[:, :2 * C * hc], 2 * C, hc).transpose(0, 1).reshape(2 * C, 2 * C)
    w2 = kstep_untile(ffn[:, 2 * C * hc:], hc, C).reshape(2 * C, C)
    return wq, wmerge, w1, w2


@functools.lru_cache(maxsize=None)
def _image_index(C: int, device) -> torch.Tensor:
    """For each entry of a layer's apply image, its index in the flat
    concatenation of the packed wq, wmerge, wmlp1 and wmlp2 (`frag_pack`)."""
    sizes = (C * C, C * C, 4 * C * C, 2 * C * C)
    flat = torch.arange(sum(sizes))
    shapes = ((C, C), (C, C), (2 * C, 2 * C), (2 * C, C))
    parts = [frag_unpack(p.reshape(n // 16, k // 16, 32, 8))
             for p, (k, n) in zip(torch.split(flat, sizes), shapes, strict=True)]
    return apply_image_plain(*parts).to(device)


def apply_image(lv: LayerValues) -> torch.Tensor:
    """`apply_image_plain` of a layer's packed weights, made on their device
    by one gather and kept on `lv.wq` while wq, wmerge, wmlp1 and wmlp2 stay
    the same tensors at the same versions. The serving forward's layers come
    from `pack_layers`' cache, so their images are made once; a training
    step packs its layers anew (`coarse_transformer_train`), so it makes one
    image a layer."""
    ws = (lv.wq, lv.wmerge, lv.wmlp1, lv.wmlp2)
    key = tuple(w._version for w in ws)
    held = getattr(lv.wq, "_apply_image", None)
    if held is not None and held[1] == key and all(r() is w for r, w in zip(held[0], ws)):
        return held[2]
    C = lv.wq.shape[0] * 16
    flat = torch.cat([w.reshape(-1) for w in ws])
    image = flat[_image_index(C, flat.device)]
    lv.wq._apply_image = (tuple(weakref.ref(w) for w in ws), key, image)
    return image


def stats_image_plain(wkv: torch.Tensor) -> torch.Tensor:
    """The stats kernel's weight image of one layer from wkv [C, 2C] ([in,
    out], wk | wv): for each head group hg of STATS_GROUP K features, the
    columns [wk[:, group] | wv[:, group]] ([C, 2 STATS_GROUP]) as
    `kstep_tiles`, the groups in order: 2 C^2 values, flat."""
    C = wkv.shape[0]
    groups = C // STATS_GROUP
    wk = wkv[:, :C].reshape(C, groups, STATS_GROUP)
    wv = wkv[:, C:].reshape(C, groups, STATS_GROUP)
    return kstep_tiles(torch.cat([wk, wv], dim=2).transpose(0, 1)).reshape(-1)


def stats_image_unpack(image: torch.Tensor, C: int) -> torch.Tensor:
    """The inverse of `stats_image_plain`: wkv [C, 2C]."""
    groups = C // STATS_GROUP
    w = kstep_untile(image.reshape(groups, 2 * C * STATS_GROUP), C, 2 * STATS_GROUP)
    wk = w[..., :STATS_GROUP].transpose(0, 1).reshape(C, C)
    wv = w[..., STATS_GROUP:].transpose(0, 1).reshape(C, C)
    return torch.cat([wk, wv], dim=1)


@functools.lru_cache(maxsize=None)
def _stats_index(C: int, device) -> torch.Tensor:
    """For each entry of a layer's stats image, its index in the packed wkv
    (`frag_pack`)."""
    flat = torch.arange(2 * C * C)
    return stats_image_plain(frag_unpack(flat.reshape(2 * C // 16, C // 16, 32, 8))).to(device)


def stats_image(lv: LayerValues) -> torch.Tensor:
    """`stats_image_plain` of a layer's packed wkv, made on its device by one
    gather and kept on `lv.wkv` while wkv stays at the same version (as
    `apply_image`). The serving forward's layers come from `pack_layers`'
    cache, so their images are made once; a training step packs its layers
    anew, so it makes one image a layer."""
    held = getattr(lv.wkv, "_stats_image", None)
    if held is not None and held[0] == lv.wkv._version:
        return held[1]
    C = lv.wkv.shape[1] * 16
    image = lv.wkv.reshape(-1)[_stats_index(C, lv.wkv.device)]
    lv.wkv._stats_image = (lv.wkv._version, image)
    return image


def stats_plan(G: int, S: int, C: int, sms: int) -> Tuple[int, int]:
    """(per_chunk, chunks) of the stats kernel over G images of S source
    tokens: each image's ceil(S / 64) tiles in `chunks` runs of `per_chunk`
    (the last may be shorter), a block a run and head group. The shortest
    runs whose blocks (G * chunks * C / STATS_GROUP) fit the card's `sms`
    at one block an SM, or a run an image where G alone fills the card."""
    tiles = -(-S // ROW_TILE)
    groups = C // STATS_GROUP
    per = -(-tiles * G * groups // sms)
    while per < tiles and G * groups * -(-tiles // per) > sms:
        per += 1
    per = min(per, tiles)
    return per, -(-tiles // per)


def pack_layers(tf, dtype: torch.dtype) -> Tuple[LayerValues, ...]:
    """`pack_layer` of every layer of a `LocalFeatureTransformer`, cached on
    it for the serving forward. The cache is keyed on each parameter's
    storage and version counter, which `load_jax_params` and
    `load_state_dict` bump; a fused optimizer step (AdamW with `fused=True`)
    writes the parameters without bumping it, so a module being trained
    packs its weights anew each call (`coarse_transformer_train`)."""
    key = (dtype, tuple((p.data_ptr(), p._version) for p in tf.parameters()))
    cached = getattr(tf, "_packed", None)
    if cached is None or cached[0] != key:
        values = tuple(pack_layer(getattr(tf, f"layer_{i}"), dtype)
                       for i in range(len(tf.layer_names)))
        tf._packed = cached = (key, values)
    return cached[1]


def coarse_transformer_supported(
    layer_names: Sequence[str], d_model: int, nhead: int, n_tokens: int
) -> bool:
    """The JAX gate's conditions, without its Mosaic chunk-divisibility rule
    (CUDA blocks mask their ragged last tile)."""
    return (
        d_model % 128 == 0
        and nhead >= 1
        and d_model % nhead == 0
        and (d_model // nhead) % 8 == 0
        and all(n in ("self", "cross") for n in layer_names)
        and n_tokens >= 1
    )


def _elu1(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x + 1.0, torch.exp(x))


def pack_heads(kv: torch.Tensor) -> torch.Tensor:
    """Each head's K^T V block [G, H, D, D] in the fragment order the stats
    kernel's merge writes (`frag_pack` of every block): [G, H * D * D]."""
    G, H, D, _ = kv.shape
    DT = D // 16
    tiles = kv.reshape(G, H, DT, 16, DT, 16).permute(0, 1, 4, 2, 3, 5)  # [.., nt, kt, 16, 16]
    rows, cols = _frag_index(kv.device)
    return tiles[..., rows, cols].reshape(G, H * D * D)


def unpack_heads(kv: torch.Tensor, nhead: int) -> torch.Tensor:
    """The inverse of `pack_heads`: [G, H * D * D] -> [G, H, D, D]."""
    G = kv.shape[0]
    D = int(round((kv.shape[1] // nhead) ** 0.5))
    DT = D // 16
    tiles = torch.empty(G, nhead, DT, DT, 16, 16, dtype=kv.dtype, device=kv.device)
    rows, cols = _frag_index(kv.device)
    tiles[..., rows, cols] = kv.reshape(G, nhead, DT, DT, 32, 8)
    return tiles.permute(0, 1, 3, 4, 2, 5).reshape(G, nhead, D, D)


def _stats_terms(src: torch.Tensor, lv: LayerValues):
    """K = elu(src wk) + 1 and V = src wv / S of the stats step, each rounded
    to src's dtype after the f32 product (the TPU kernel's rounding points)."""
    C, S, dt = src.shape[2], src.shape[1], src.dtype
    p = src.float() @ frag_unpack(lv.wkv).float()
    return _elu1(p[..., :C]).to(dt), (p[..., C:] * (1.0 / S)).to(dt)


def stats_reference(src: torch.Tensor, lv: LayerValues, nhead: int):
    """The stats step with the TPU kernel's rounding points. src: [G, S, C].
    Returns (kv, ks) in src's dtype: each head's K^T V (V pre-scaled by 1/S)
    [G, H, D, D] and K_sum [G, C]."""
    G, S, C = src.shape
    D = C // nhead
    K, V = _stats_terms(src, lv)
    KV = torch.einsum("gshd,gshv->ghdv", K.float().view(G, S, nhead, D),
                      V.float().view(G, S, nhead, D)).to(src.dtype)
    return KV, K.float().sum(dim=1).to(src.dtype)


def _bf16_ulp(m: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at magnitude m >= 0 (2^(floor(log2 m) - 7)); 0 at 0."""
    _, e = torch.frexp(m)
    return torch.where(m > 0, torch.ldexp(torch.ones_like(m), e - 8), torch.zeros_like(m))


def stats_reference_bounds(src: torch.Tensor, lv: LayerValues, nhead: int):
    """`stats_reference`'s (kv, ks) as the stats kernel writes them (kv as
    `pack_heads`), in float32, with the bound each entry of the kernel's must
    keep to. Returns (kv, ks, kv_tol, ks_tol).

    An entry is a sum over the S tokens of terms x (K V for kv, K for ks)
    that the kernel and the plain stats both form from bf16 K and V and sum
    in f32, each in its own order, then round to bf16 once. Their f32 sums
    differ by at most
      d = S 2^-23 sum |x|: two f32 orders of S terms, each at most S 2^-24
          sum |x| from the exact sum; plus
          2^-6 sqrt(sum x^2): the flips, where the kernel's f32 product
          lands on the other side of a bf16 rounding boundary of K or V than
          the plain one and moves its term by up to 2^-7 of it a factor. The
          two products differ in their last f32 bits only, so flips are few;
          the term covers one term flipped in both factors, or, with every
          sign alike, up to sqrt(S) flips of terms of average size.
    Both f32 sums lie below M = (1 + 2^-7) |ref| + d, so the two roundings
    add at most one bf16 ulp at M: tol = ulp(M) + d, never looser than the
    layer's 5e-2 + 2e-2 |ref|. At the serving shapes one 64-token tile left
    out moves kv and ks by several times their tol."""
    G, S, C = src.shape
    D = C // nhead
    kv, ks = stats_reference(src, lv, nhead)
    K, V = (t.float() for t in _stats_terms(src, lv))
    Kh, Vh = K.view(G, S, nhead, D), V.view(G, S, nhead, D)
    kv_abs = pack_heads(torch.einsum("gshd,gshv->ghdv", Kh, Vh.abs()))  # K > 0
    kv_sq = pack_heads(torch.einsum("gshd,gshv->ghdv", Kh.square(), Vh.square()))
    kv, ks = pack_heads(kv).float(), ks.float()

    def tol(ref, total, squares):
        d = S * 2.0 ** -23 * total + 2.0 ** -6 * squares.sqrt()
        bound = _bf16_ulp((1 + 2.0 ** -7) * ref.abs() + d) + d
        return torch.minimum(bound, 5e-2 + 2e-2 * ref.abs())

    return kv, ks, tol(kv, kv_abs, kv_sq), tol(ks, K.sum(dim=1), K.square().sum(dim=1))


def stats_errors(kv: torch.Tensor, ks: torch.Tensor, src: torch.Tensor, lv: LayerValues,
                 nhead: int):
    """The stats kernel's kv and ks (as `launch_stats` returns them) against
    the plain stats over src: {"kv": (max error, entries past
    `stats_reference_bounds`, entries, largest bound), "ks": (...)}."""
    ref_kv, ref_ks, kv_tol, ks_tol = stats_reference_bounds(src, lv, nhead)
    out = {}
    for name, got, ref, tol in (("kv", kv, ref_kv, kv_tol), ("ks", ks, ref_ks, ks_tol)):
        err = (got.float() - ref).abs()
        out[name] = (float(err.max()), int((err > tol).sum()), err.numel(), float(tol.max()))
    return out


def apply_reference(x: torch.Tensor, kv: torch.Tensor, ks: torch.Tensor, S: int,
                    lv: LayerValues, nhead: int) -> torch.Tensor:
    """The apply step over queries x [G, L, C] from `stats_reference`'s (kv,
    ks) of S source tokens; every product accumulates in f32 and is rounded
    to x's dtype where the kernel rounds."""
    G, L, C = x.shape
    D = C // nhead
    dt = x.dtype
    wq, wmerge, wmlp1, wmlp2 = (frag_unpack(w).float() for w in (
        lv.wq, lv.wmerge, lv.wmlp1, lv.wmlp2))
    Q = _elu1(x.float() @ wq).to(dt)
    KV = kv.float()
    ksum = ks.float().view(G, nhead, D)
    Qh = Q.float().view(G, L, nhead, D)
    Z = torch.einsum("glhd,ghd->glh", Qh, ksum)
    o = torch.einsum("glhd,ghdv->glhv", Qh, KV)
    o = (o * (float(S) / (Z + EPS))[..., None]).reshape(G, L, C).to(dt)
    msg = layer_norm_chain_plain((o.float() @ wmerge).to(dt), lv.n1s, lv.n1b)
    y = x.float() @ wmlp1[:C] + msg.float() @ wmlp1[C:]
    y = (torch.relu(y).to(dt).float() @ wmlp2).to(dt)
    return x + layer_norm_chain_plain(y, lv.n2s, lv.n2b)


def encoder_reference_with_stats(x: torch.Tensor, src: torch.Tensor, lv: LayerValues,
                                 nhead: int):
    """(out, kv, ks) of one encoder layer: `stats_reference` over src, then
    `apply_reference` over x; kv in the stats kernel's layout (`pack_heads`,
    head dims that are multiples of 16), as `coarse_layer_with_stats`
    returns it."""
    kv, ks = stats_reference(src, lv, nhead)
    return apply_reference(x, kv, ks, src.shape[1], lv, nhead), pack_heads(kv), ks


def encoder_reference(x: torch.Tensor, src: torch.Tensor, lv: LayerValues,
                      nhead: int) -> torch.Tensor:
    """One encoder layer with the TPU kernel's rounding points.
    x: [G, L, C] queries, src: [G, S, C] keys/values; every product
    accumulates in f32 and is rounded to x's dtype where the kernel rounds."""
    kv, ks = stats_reference(src, lv, nhead)
    return apply_reference(x, kv, ks, src.shape[1], lv, nhead)


def _run_stack(feat0, feat1, layers, layer_names, layer_fn):
    """The layer order of the JAX kernel: self layers on both images at once
    (one batch of 2B), cross layers in turn on the updated feat0."""
    B = feat0.shape[0]
    for lv, name in zip(layers, layer_names, strict=True):
        if name == "self":
            if feat0.shape == feat1.shape:
                both = torch.cat([feat0, feat1], dim=0)
                out = layer_fn(both, both, lv)
                feat0, feat1 = out[:B], out[B:]
            else:
                feat0, feat1 = layer_fn(feat0, feat0, lv), layer_fn(feat1, feat1, lv)
        elif name == "cross":
            feat0 = layer_fn(feat0, feat1, lv)
            feat1 = layer_fn(feat1, feat0, lv)
        else:
            raise ValueError(f"unknown layer name {name!r}")
    return feat0, feat1


def coarse_transformer_reference(feat0, feat1, layers: Sequence[LayerValues],
                                 layer_names: Sequence[str], nhead: int):
    """Plain version of the whole stack. feat*: [B, N, C]."""
    return _run_stack(feat0, feat1, layers, layer_names,
                      lambda x, s, lv: encoder_reference(x, s, lv, nhead))


def check_layer_values(lv: LayerValues, C: int) -> None:
    """Raise unless lv holds a layer of width C as the kernels take it."""
    for t, name, (k, n) in zip(lv, LayerValues._fields, [
            (C, C), (C, 2 * C), (C, C), (1, C), (1, C), (2 * C, 2 * C), (2 * C, C), (1, C), (1, C)]):
        if name[0] == "n":
            _build.check_cuda(t, name, torch.float32, (n,))
        else:
            _build.check_cuda(t, name, torch.bfloat16, (n // 16, k // 16, 32, 8))


def _check_layer(x: torch.Tensor, src: torch.Tensor, lv: LayerValues, nhead: int,
                 widths=WIDTHS) -> None:
    G, L, C = x.shape
    if C % nhead or (C, C // nhead) not in widths:
        raise ValueError(
            f"coarse_transformer kernel takes (C, head dim) in {widths}; got C={C}, "
            f"heads={nhead}"
        )
    _build.check_cuda(x, "x", torch.bfloat16)
    _build.check_cuda(src, "src", torch.bfloat16, (G, src.shape[1], C))
    check_layer_values(lv, C)


def launch_stats(src: torch.Tensor, lv: LayerValues, nhead: int, per_chunk: int,
                 chunks: int):
    """The stats kernel and its merge over src [G, S, C] bf16 on the card,
    each image's ceil(S / 64) tiles in `chunks` runs of `per_chunk` (as
    `stats_plan` gives them to `coarse_layer_with_stats`). Returns (kv, ks)
    as that function does. Runs that do not cover an image's tiles leave
    the last ones out of the sums: the tests plant that fault."""
    G, S, C = src.shape
    D = C // nhead
    f32 = dict(device=src.device, dtype=torch.float32)
    part_kv = torch.empty(G, chunks, C * D, **f32)
    part_ks = torch.empty(G, chunks, C, **f32)
    kv = torch.empty(G, C * D, device=src.device, dtype=torch.bfloat16)
    ks = torch.empty(G, C, device=src.device, dtype=torch.bfloat16)
    _build.launch(
        "coarse_transformer", "fm_coarse_stats", _STATS_ARGTYPES,
        src.data_ptr(), stats_image(lv).data_ptr(), part_kv.data_ptr(), part_ks.data_ptr(),
        kv.data_ptr(), ks.data_ptr(), G, S, C, D, per_chunk, chunks, _build.stream(),
    )
    return kv, ks


def coarse_layer_with_stats(x: torch.Tensor, src: torch.Tensor, lv: LayerValues,
                            nhead: int):
    """One encoder layer on the card: the stats kernel over src (with its
    merge), then the apply kernel over x. x: [G, L, C], src: [G, S, C] bf16.
    Returns (out, kv, ks): kv [G, C * D] (each head's K^T V in fragment
    order, `pack_heads`) and ks [G, C], bf16, as the apply kernel read them."""
    _check_layer(x, src, lv, nhead)
    G, L, C = x.shape
    S = src.shape[1]
    D = C // nhead
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    kv, ks = launch_stats(src, lv, nhead, *stats_plan(G, S, C, sms))
    image = apply_image(lv)
    out = torch.empty_like(x)
    _build.launch(
        "coarse_transformer", "fm_coarse_apply", _APPLY_ARGTYPES,
        x.data_ptr(), kv.data_ptr(), ks.data_ptr(), image.data_ptr(), lv.n1s.data_ptr(),
        lv.n1b.data_ptr(), lv.n2s.data_ptr(), lv.n2b.data_ptr(), out.data_ptr(), G, L, S, C, D,
        _build.stream(),
    )
    return out, kv, ks


def ring_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [64, K] . b [K, 256] in float32 from bf16 operands: on a CUDA tensor
    the apply kernel's wgmma, bulk-copy and mbarrier path alone (b streamed
    a k-step at a time through a two-slot ring as `kstep_tiles`; K a
    multiple of 16 up to 1024), on a CPU tensor the plain product."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    K = a.shape[1]
    if tuple(a.shape) != (64, K) or tuple(b.shape) != (K, 256) or K % 16 or not 16 <= K <= 1024:
        raise ValueError(f"ring_product takes [64, K] . [K, 256], K in 16..1024 a multiple of "
                         f"16; got {tuple(a.shape)} . {tuple(b.shape)}")
    _build.check_cuda(a, "a", torch.bfloat16)
    _build.check_cuda(b, "b", torch.bfloat16)
    bimg = kstep_tiles(b).contiguous()
    out = torch.empty(64, 256, device=a.device, dtype=torch.float32)
    _build.launch("coarse_transformer", "fm_ring_product", _RING_ARGTYPES, a.data_ptr(),
                  bimg.data_ptr(), out.data_ptr(), K, _build.stream())
    return out


def coarse_layer_fused(x: torch.Tensor, src: torch.Tensor, lv: LayerValues,
                       nhead: int) -> torch.Tensor:
    """One encoder layer on the card (`coarse_layer_with_stats`'s output)."""
    return coarse_layer_with_stats(x, src, lv, nhead)[0]


def coarse_transformer_fused(feat0, feat1, layers: Sequence[LayerValues],
                             layer_names: Sequence[str], nhead: int):
    """The whole stack. feat*: [B, N, C]; `layers` from `pack_layer(s)` or
    `layer_values` in feat0's dtype. Returns the updated (feat0, feat1)."""
    if feat0.device.type == "cpu":
        return coarse_transformer_reference(feat0, feat1, layers, layer_names, nhead)
    if len(layers) != len(layer_names):
        raise ValueError(f"{len(layers)} layers for {len(layer_names)} layer names")
    out = _run_stack(feat0.contiguous(), feat1.contiguous(), layers, layer_names,
                     lambda x, s, lv: coarse_layer_fused(x, s, lv, nhead))
    coarse_transformer_fused.launches += 1
    return out


coarse_transformer_fused.launches = 0
