"""The fine stage in one kernel: both fine encoder layers over each pair of
match windows, the learned 49 -> 1 mix, and optionally the heatmaps.

Port of `featurematching_tpu/ops/pallas_fine_stage.py · fine_stage_fused`:

    for each layer: self  -> w0 = enc(w0, w0); w1 = enc(w1, w1)
                    cross -> w0 = enc(w0, w1); w1 = enc(w1, w0)   (updated w0)
    m0 = mix0(w0); m1 = mix1(w1)
    fold mode:  heat0 = softmax(m0·w1ᵀ/√C), heat1 = softmax(m1·w0ᵀ/√C)

`enc` is `coarse_transformer.encoder_reference` with its rounding points.
On a CUDA tensor `fine_stage_fused` launches `csrc/fine_stage.cu`: a
persistent grid of one block an SM, each block holding 3 window pairs in
flight, one a warpgroup that synchronises only itself;
the windows in registers, every weight product on `wgmma` with the layers'
weights read from shared memory, where the block bulk-copies each layer's
`fine_image` once (one pair a block at a time behind block-wide barriers,
with the weights read from L1/L2 a window, measured 2.7x slower); taps padded
to 64 rows and masked out of every attention sum; bound by tensor-core
operations. On a CPU tensor it runs `fine_stage_reference`, which works on
the unpadded taps.

`mix*` is (weight [N], bias [1]) of the `mix_feat_*` layers.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Sequence, Tuple

import torch

from featurematching_tpu_torch.matching.fine import window_heatmaps
from featurematching_tpu_torch.ops import _build
from featurematching_tpu_torch.ops.coarse_transformer import (
    LayerValues,
    _run_stack,
    check_layer_values,
    encoder_reference,
    frag_unpack,
    kstep_tiles,
    kstep_untile,
)

MAX_TAPS = 64  # taps are padded to one 64-row wgmma tile
C_KERNEL = 64
# head dims the kernel takes (heads tile 16-column blocks, or one head is all
# 64); K10's backward takes the same (TRAIN_HEAD_DIMS)
HEAD_DIMS = (8, 16, 64)
TRAIN_HEAD_DIMS = (8, 16, 64)
MAX_LAYERS = 2
# windows, 5 operands per layer (the image and the LN parameters), the mixes, the
# outputs; then the ints and the stream
_ARGTYPES = [_build.PTR] * (2 + 5 * 2 + 4 + 4) + [_build.INT] * 7 + [_build.PTR]
_OCC_ARGTYPES = [_build.INT] * 4 + [ctypes.POINTER(ctypes.c_int)]


def fine_stage_supported(layer_names: Sequence[str], d_model: int, nhead: int) -> bool:
    """The JAX gate's conditions: 64-aligned channels, whole heads."""
    return (
        d_model % 64 == 0
        and nhead >= 1
        and d_model % nhead == 0
        and len(layer_names) >= 1
        and all(n in ("self", "cross") for n in layer_names)
    )


def fine_train_supported(layer_names: Sequence[str], d_model: int, nhead: int,
                         n_tokens: int, forward_only: bool = False) -> bool:
    """The gate of the differentiable fine transformer (K10): what its
    kernels take (C = 64, a head dim in TRAIN_HEAD_DIMS, or with
    `forward_only` (no gradient to take) in K6's HEAD_DIMS, at most MAX_TAPS
    tokens, self/cross layers). Any number of layers: K10 and its forward,
    K6's kernel, launch one a layer."""
    dims = HEAD_DIMS if forward_only else TRAIN_HEAD_DIMS
    return (len(layer_names) >= 1 and all(n in ("self", "cross") for n in layer_names)
            and d_model == C_KERNEL and nhead >= 1 and d_model % nhead == 0
            and d_model // nhead in dims and 1 <= n_tokens <= MAX_TAPS)


def window_mix(w: torch.Tensor, mix: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The learned taps -> 1 mix, [B_, N, C] -> [B_, C]: operands in the
    activation dtype, f32 sum, rounded, then the bias added in that dtype."""
    weight, bias = mix
    dt = w.dtype
    acc = torch.einsum("brc,r->bc", w.float(), weight.to(dt).float()).to(dt)
    return acc + bias.reshape(()).to(dt)


def _image_shapes(C: int):
    """[in, out] of wq, wkv, wmerge, wmlp1 and wmlp2, in the image's order."""
    return ((C, C), (C, 2 * C), (C, C), (2 * C, 2 * C), (2 * C, C))


def fine_image_plain(wq: torch.Tensor, wkv: torch.Tensor, wmerge: torch.Tensor,
                     wmlp1: torch.Tensor, wmlp2: torch.Tensor) -> torch.Tensor:
    """The kernel's weight image of one layer from weights [in, out]: wq
    [C, C], wkv [C, 2C], wmerge [C, C], wmlp1 [2C, 2C] and wmlp2 [2C, C] in
    that order, each as `kstep_tiles` (its k-steps as [N, 16] K-major tiles,
    the B operands of wgmma), one flat tensor of 10 C^2 values. wmlp1's first
    C rows multiply the window, the next C the message."""
    return torch.cat([kstep_tiles(w) for w in (wq, wkv, wmerge, wmlp1, wmlp2)])


def fine_image_unpack(image: torch.Tensor, C: int):
    """The inverse of `fine_image_plain`: (wq, wkv, wmerge, wmlp1, wmlp2) [in, out]."""
    shapes = _image_shapes(C)
    parts = torch.split(image, [k * n for k, n in shapes])
    return tuple(kstep_untile(p, k, n) for p, (k, n) in zip(parts, shapes, strict=True))


@functools.lru_cache(maxsize=None)
def _image_index(plain, C: int, device) -> torch.Tensor:
    """For each entry of the image `plain` makes of a layer's weights, its
    index in the flat concatenation of the packed wq, wkv, wmerge, wmlp1 and
    wmlp2 (`frag_pack`)."""
    shapes = _image_shapes(C)
    sizes = [k * n for k, n in shapes]
    flat = torch.arange(sum(sizes))
    parts = [frag_unpack(p.reshape(n // 16, k // 16, 32, 8))
             for p, (k, n) in zip(torch.split(flat, sizes), shapes, strict=True)]
    return plain(*parts).to(device)


def layer_image(lv: LayerValues, plain, attr: str) -> torch.Tensor:
    """The image `plain` makes of a layer's packed weights (wq, wkv, wmerge,
    wmlp1, wmlp2 [in, out]), made on their device by one concatenation and
    one gather and kept on `lv.wq` as `attr` while those five stay the same
    tensors at the same versions."""
    ws = (lv.wq, lv.wkv, lv.wmerge, lv.wmlp1, lv.wmlp2)
    key = tuple(w._version for w in ws)
    held = getattr(lv.wq, attr, None)
    if held is not None and held[1] == key and all(r() is w for r, w in zip(held[0], ws)):
        return held[2]
    C = lv.wq.shape[0] * 16
    flat = torch.cat([w.reshape(-1) for w in ws])
    image = flat[_image_index(plain, C, flat.device)]
    setattr(lv.wq, attr, (tuple(weakref.ref(w) for w in ws), key, image))
    return image


def fine_image(lv: LayerValues) -> torch.Tensor:
    """`fine_image_plain` of a layer's packed weights (`layer_image`). The
    serving forward's layers come from `pack_layers`' cache, so their images
    are made once; a training or evaluation step packs its layers anew
    (`fine_transformer_train`), so it makes one image a layer."""
    return layer_image(lv, fine_image_plain, "_fine_image")


def fine_stage_reference(w0, w1, layers: Sequence[LayerValues], mix0, mix1,
                         layer_names: Sequence[str], nhead: int,
                         fold_softargmax: bool = False):
    """Plain version. w*: [B_, N, C]. Returns (heat0, heat1) [B_, N] f32 in
    fold mode, else (w0, w1 [B_, N, C], m0, m1 [B_, C])."""
    a0, a1 = _run_stack(w0, w1, layers, layer_names,
                        lambda x, s, lv: encoder_reference(x, s, lv, nhead))
    m0, m1 = window_mix(a0, mix0), window_mix(a1, mix1)
    if fold_softargmax:
        return window_heatmaps(m0, a1), window_heatmaps(m1, a0)
    return a0, a1, m0, m1


def fine_stage_fused(w0, w1, layers: Sequence[LayerValues], mix0, mix1,
                     layer_names: Sequence[str], nhead: int,
                     fold_softargmax: bool = False):
    """Fused fine transformer + window mix (+ the heatmaps in fold mode).
    w*: [B_, N, C] in the compute dtype; `layers` from `pack_layer(s)` or
    `layer_values`."""
    if w0.device.type == "cpu":
        return fine_stage_reference(w0, w1, layers, mix0, mix1, layer_names, nhead,
                                    fold_softargmax)
    out = _launch(w0, w1, layers, mix0, mix1, layer_names, nhead, fold_softargmax)
    fine_stage_fused.launches += 1
    return out


fine_stage_fused.launches = 0


def fine_layer_reference(w0, w1, lv: LayerValues, name: str, nhead: int):
    """Plain version of `fine_layer_forward`: `encoder_reference` in the
    stack's layer order."""
    return _run_stack(w0, w1, [lv], [name], lambda x, s, v: encoder_reference(x, s, v, nhead))


def fine_layer_forward(w0: torch.Tensor, w1: torch.Tensor, lv: LayerValues, name: str,
                       nhead: int):
    """One fine encoder layer over window pairs, (w0, w1) -> the updated
    pair, as K10's forward runs it: on a CUDA tensor K6's kernel in plain
    mode with this one layer and zero mixes (the JAX package's `_fwd_impl`),
    counted in `launches` (not in `fine_stage_fused.launches`); on a CPU
    tensor `fine_layer_reference`."""
    if w0.device.type == "cpu":
        return fine_layer_reference(w0, w1, lv, name, nhead)
    N = w0.shape[1]
    zero = (torch.zeros(N, device=w0.device), torch.zeros(1, device=w0.device))
    out = _launch(w0, w1, [lv], zero, zero, (name,), nhead, False)
    fine_layer_forward.launches += 1
    return out[0], out[1]


fine_layer_forward.launches = 0


def _launch(w0, w1, layers, mix0, mix1, layer_names, nhead, fold_softargmax):
    """Check the operands and launch `csrc/fine_stage.cu` once."""
    B_, N, C = w0.shape
    nl = len(layer_names)
    if C != C_KERNEL or C % nhead or C // nhead not in HEAD_DIMS or not 1 <= N <= MAX_TAPS:
        raise ValueError(
            f"fine_stage kernel takes C={C_KERNEL}, head dim in {HEAD_DIMS} and at most "
            f"{MAX_TAPS} taps; got C={C}, heads={nhead}, N={N}"
        )
    if not 1 <= nl <= MAX_LAYERS or len(layers) != nl:
        raise ValueError(f"fine_stage kernel takes 1 to {MAX_LAYERS} layers, got {nl}")
    if any(n not in ("self", "cross") for n in layer_names):
        raise ValueError(f"unknown layer name in {layer_names}")
    _build.check_cuda(w0, "w0", torch.bfloat16)
    _build.check_cuda(w1, "w1", torch.bfloat16, (B_, N, C))
    for lv in layers:
        check_layer_values(lv, C)
    mixes = []
    for weight, bias in (mix0, mix1):
        mixes += [_build.f32(weight.reshape(-1)), _build.f32(bias.reshape(-1))]
        _build.check_cuda(mixes[-2], "mix weight", torch.float32, (N,))
    ptrs = [t.data_ptr() for lv in layers
            for t in (fine_image(lv), lv.n1s, lv.n1b, lv.n2s, lv.n2b)]
    ptrs += [None] * (5 * MAX_LAYERS - len(ptrs))
    cross = sum(1 << i for i, n in enumerate(layer_names) if n == "cross")
    f32 = dict(device=w0.device, dtype=torch.float32)
    if fold_softargmax:
        outs = [torch.empty(B_, N, **f32), torch.empty(B_, N, **f32), None, None]
    else:
        outs = [torch.empty_like(w0), torch.empty_like(w1),
                torch.empty(B_, C, device=w0.device, dtype=w0.dtype),
                torch.empty(B_, C, device=w0.device, dtype=w0.dtype)]
    sms = torch.cuda.get_device_properties(w0.device).multi_processor_count
    _build.launch(
        "fine_stage", "fm_fine_stage", _ARGTYPES,
        w0.data_ptr(), w1.data_ptr(), *ptrs, *[t.data_ptr() for t in mixes],
        *[t.data_ptr() if t is not None else None for t in outs],
        B_, N, C // nhead, nl, cross, int(fold_softargmax), sms, _build.stream(),
    )
    return tuple(outs[:2]) if fold_softargmax else tuple(outs)


def fine_stage_occupancy(layers: int, nhead: int, pairs: int) -> dict:
    """The kernel's block on the current card at `layers` layers and C //
    nhead head dim, as its library reports it: pairs in flight a block,
    dynamic shared memory (bytes), blocks an SM and the grid for `pairs`
    window pairs."""
    info = (ctypes.c_int * 4)()
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    fn = _build._load("fine_stage").fm_fine_stage_occupancy
    fn.argtypes, fn.restype = _OCC_ARGTYPES, _build.INT
    err = fn(layers, C_KERNEL // nhead, pairs, sms, info)
    if err:
        raise RuntimeError(f"fm_fine_stage_occupancy: CUDA error {err}")
    return dict(pairs_in_flight=info[0], smem_bytes=info[1], blocks_per_sm=info[2], grid=info[3])
