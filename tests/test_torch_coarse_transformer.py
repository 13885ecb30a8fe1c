"""K5: the port's coarse transformer against the JAX package's.

`coarse_transformer_reference` (what `coarse_transformer_fused` runs on the
CPU) against `ops/pallas_coarse_transformer.coarse_transformer_fused` in
interpret mode and against the flax `LocalFeatureTransformer.apply`, on the
same flax weights carried across by `load_jax_params`, at float32 (JAX at
`highest` matmul precision, tests/conftest.py). In float32 the TPU kernel's
rounding points are no-ops, so all three compute one function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.models.transformer import (
    LocalFeatureTransformer as JaxLocalFeatureTransformer,
)
from featurematching_tpu.ops.pallas_coarse_transformer import (
    coarse_transformer_fused as jax_coarse_transformer_fused,
)
from featurematching_tpu.ops.pallas_coarse_transformer import (
    coarse_transformer_supported as jax_coarse_transformer_supported,
)
from featurematching_tpu.ops.pallas_coarse_transformer import _layer_stats
from featurematching_tpu.ops.pallas_fine_stage import _layer_values as jax_layer_values
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops.coarse_transformer import (
    APPLY_HIDDEN_CHUNK,
    ROW_TILE,
    STATS_GROUP,
    _stats_terms,
    apply_image,
    apply_image_plain,
    apply_image_unpack,
    coarse_transformer_fused,
    coarse_transformer_reference,
    coarse_transformer_supported,
    frag_pack,
    frag_unpack,
    layer_values,
    pack_heads,
    pack_layer,
    pack_layers,
    stats_image,
    stats_image_plain,
    stats_image_unpack,
    stats_plan,
    stats_reference_bounds,
)
from featurematching_tpu_torch.utils.weights import load_jax_params


def _t(a):
    return torch.tensor(np.asarray(a))


def _make(rng, B, N, C, nhead, layer_names):
    f0 = rng.standard_normal((B, N, C)).astype(np.float32)
    f1 = rng.standard_normal((B, N, C)).astype(np.float32)
    jm = JaxLocalFeatureTransformer(C, nhead, layer_names)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(f0), jnp.asarray(f1))["params"]
    port = LocalFeatureTransformer(C, nhead, layer_names)
    load_jax_params(port, params)
    return jm, params, port, f0, f1


@pytest.mark.parametrize(
    "B,N,C,nhead,layer_names,chunk",
    [
        (2, 64, 128, 8, ("self", "cross", "self", "cross"), 32),
        (1, 96, 128, 4, ("cross", "self"), 32),
        # N > 256 routes flax to its plain (unpacked) linear attention
        (1, 320, 128, 8, ("self", "cross"), 64),
        # head dim 64 (tpu_optimized_config()'s coarse 256/4)
        (1, 128, 128, 2, ("self", "cross"), 64),
        (1, 128, 256, 4, ("self", "cross"), 64),
    ],
)
def test_reference_matches_pallas_and_flax_f32(rng, B, N, C, nhead, layer_names, chunk):
    jm, params, port, f0, f1 = _make(rng, B, N, C, nhead, layer_names)
    j0, j1 = jnp.asarray(f0), jnp.asarray(f1)
    fused = jax_coarse_transformer_fused(j0, j1, params, layer_names, nhead,
                                         chunk=chunk, interpret=True)
    flax = jm.apply({"params": params}, j0, j1)
    layers = pack_layers(port, torch.float32)
    got = coarse_transformer_reference(_t(f0), _t(f1), layers, layer_names, nhead)
    # the wrapper runs the plain version for CPU tensors
    wrapped = coarse_transformer_fused(_t(f0), _t(f1), layers, layer_names, nhead)
    for i in range(2):
        np.testing.assert_array_equal(wrapped[i].numpy(), got[i].numpy())
        for ref in (fused, flax):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=2e-4, atol=2e-4)


def test_pack_layer_matches_jax_layer_values(rng):
    _, params, port, _, _ = _make(rng, 1, 16, 128, 8, ("self",))
    got = pack_layer(port.layer_0, torch.float32)
    ref = jax_layer_values(params["layer_0"], jnp.float32)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = frag_unpack(g) if g.ndim == 4 else g  # weights are in fragment order
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_frag_pack_layout():
    """Lane l = 4g + t holds, of each 16x16 tile, rows 2t, 2t+1, 2t+8, 2t+9
    of column g, then the same of column g + 8 (the mma.m16n8k16 B operand);
    strips of 16 columns are outermost."""
    K, N = 32, 48
    w = torch.arange(K * N, dtype=torch.float32).reshape(K, N)
    p = frag_pack(w)
    assert p.shape == (N // 16, K // 16, 32, 8)
    nt, kt, g, t = 2, 1, 3, 1
    rows = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9] * 2
    cols = [g] * 4 + [g + 8] * 4
    want = [w[kt * 16 + r, nt * 16 + c] for r, c in zip(rows, cols)]
    assert p[nt, kt, 4 * g + t].tolist() == [float(v) for v in want]
    assert torch.equal(frag_unpack(p), w)


def _layer_weights(C):
    """wq, wmerge [C, C], wmlp1 [2C, 2C], wmlp2 [2C, C] holding distinct values."""
    shapes = ((C, C), (C, C), (2 * C, 2 * C), (2 * C, C))
    sizes = [k * n for k, n in shapes]
    flat = torch.arange(sum(sizes), dtype=torch.float64)
    return [p.reshape(shape) for p, shape in zip(torch.split(flat, sizes), shapes, strict=True)]


@pytest.mark.parametrize("C", [128, 256])
def test_apply_image_round_trip(C):
    """The apply kernel's weight image holds every weight once, 8 C^2 values,
    and unpacks to the weights; made from the packed LayerValues by one
    gather, it equals the plain image and is kept while the weights stay."""
    ws = _layer_weights(C)
    image = apply_image_plain(*ws)
    assert image.shape == (8 * C * C,)
    assert torch.equal(torch.sort(image).values, torch.arange(8.0 * C * C, dtype=torch.float64))
    for got, w in zip(apply_image_unpack(image, C), ws, strict=True):
        assert torch.equal(got, w)
    ones, zeros = torch.ones(C), torch.zeros(C)
    lv = layer_values(ws[0], torch.zeros(C, 2 * C, dtype=torch.float64), ws[1], ones, zeros,
                      ws[2], ws[3], ones, zeros)
    got = apply_image(lv)
    assert torch.equal(got, image)
    assert apply_image(lv) is got
    lv2 = lv._replace(wmlp2=frag_pack(2 * ws[3]))
    assert torch.equal(apply_image_unpack(apply_image(lv2), C)[3], 2 * ws[3])
    lv.wq.mul_(2)  # an in-place change of a weight is seen
    assert torch.equal(apply_image_unpack(apply_image(lv), C)[0], 2 * ws[0])


@pytest.mark.parametrize("C", [128, 256])
def test_apply_image_layout(C):
    """Entries at the offsets the kernel reads them from (csrc/wgmma.cuh):
    each k-step of a product is [N, 16] K-major, core matrices of 8 rows x 8
    k values, (n // 8, k // 8) row-major, 64 values each; wq, then wmerge,
    then per APPLY_HIDDEN_CHUNK-column hidden chunk c wmlp1[:, chunk c] and
    wmlp2[chunk c, :]."""
    ws = _layer_weights(C)
    image = apply_image_plain(*ws)
    hc = APPLY_HIDDEN_CHUNK

    def at(k, n, N):  # offset of B[k, n] in the k-step tiles of a [K, N] operand
        kk = k % 16
        return (k // 16) * 16 * N + ((n // 8) * 2 + kk // 8) * 64 + (n % 8) * 8 + kk % 8

    for k, n in ((0, 0), (9, 3), (C - 1, C - 1), (17, C // 2 + 5)):
        assert image[at(k, n, C)] == ws[0][k, n]
        assert image[C * C + at(k, n, C)] == ws[1][k, n]
    chunk = 3 * C * hc  # values of one hidden chunk: wmlp1's columns, wmlp2's rows
    for c, k, n in ((0, 0, 0), (1, 2 * C - 1, 63), (2 * C // hc - 1, C + 8, 17)):
        base = 2 * C * C + c * chunk
        assert image[base + at(k, n, hc)] == ws[2][k, c * hc + n]
    for c, k, n in ((0, 0, 0), (1, 63, C - 1), (2 * C // hc - 1, 40, 9)):
        base = 2 * C * C + c * chunk + 2 * C * hc
        assert image[base + at(k, n, C)] == ws[3][c * hc + k, n]


def test_pack_layers_sees_new_weights(rng):
    """The packed operands are cached on the transformer; loading new
    weights in place must replace them."""
    _, params, port, _, _ = _make(rng, 1, 16, 128, 8, ("self", "cross"))
    first = pack_layers(port, torch.float32)
    assert pack_layers(port, torch.float32) is first
    new = jax.tree_util.tree_map(lambda a: np.asarray(a) * 2.0, params)
    load_jax_params(port, new)
    second = pack_layers(port, torch.float32)
    assert second is not first
    np.testing.assert_array_equal(frag_unpack(second[1].wq).numpy(),
                                  2.0 * np.asarray(params["layer_1"]["q_proj"]["kernel"]))
    assert pack_layers(port, torch.bfloat16)[0].wq.dtype == torch.bfloat16


def _wkv(C):
    """wkv [C, 2C] holding distinct values."""
    return torch.arange(2 * C * C, dtype=torch.float64).reshape(C, 2 * C)


@pytest.mark.parametrize("C", [128, 256])
def test_stats_image_round_trip(C):
    """The stats kernel's weight image holds each of wkv's 2 C^2 values once
    and unpacks to wkv; made from the packed LayerValues by one gather, it
    equals the plain image and is kept while wkv stays the same tensor at
    the same version."""
    wkv = _wkv(C)
    image = stats_image_plain(wkv)
    assert image.shape == (2 * C * C,)
    assert torch.equal(torch.sort(image).values, torch.arange(2.0 * C * C, dtype=torch.float64))
    assert torch.equal(stats_image_unpack(image, C), wkv)
    ws = _layer_weights(C)
    ones, zeros = torch.ones(C), torch.zeros(C)
    lv = layer_values(ws[0], wkv, ws[1], ones, zeros, ws[2], ws[3], ones, zeros)
    got = stats_image(lv)
    assert torch.equal(got, image)
    assert stats_image(lv) is got
    lv2 = lv._replace(wkv=frag_pack(2 * wkv))
    assert torch.equal(stats_image_unpack(stats_image(lv2), C), 2 * wkv)
    lv.wkv.mul_(3)  # an in-place change of wkv is seen
    assert torch.equal(stats_image_unpack(stats_image(lv), C), 3 * wkv)


@pytest.mark.parametrize("C", [128, 256])
def test_stats_image_layout(C):
    """Entries at the offsets the stats kernel reads them from: head group
    hg (STATS_GROUP K features) holds 2 C STATS_GROUP values, the columns
    wk[:, group] then wv[:, group] of a [C, 2 STATS_GROUP] product, each
    k-step [N, 16] K-major in 8x8 core matrices, (n // 8, k // 8) row-major
    (csrc/wgmma.cuh)."""
    wkv = _wkv(C)
    image = stats_image_plain(wkv)
    sg, N = STATS_GROUP, 2 * STATS_GROUP

    def at(k, n):  # offset of B[k, n] in the k-step tiles of a [C, N] operand
        kk = k % 16
        return (k // 16) * 16 * N + ((n // 8) * 2 + kk // 8) * 64 + (n % 8) * 8 + kk % 8

    for hg in range(C // sg):
        base = hg * C * N
        for k, n in ((0, 0), (9, 3), (C - 1, sg - 1), (17, 77)):
            assert image[base + at(k, n)] == wkv[k, hg * sg + n]  # a K column
            assert image[base + at(k, sg + n)] == wkv[k, C + hg * sg + n]  # its V column


def test_stats_image_sees_new_weights(rng):
    """A layer of `pack_layers`' cache keeps its stats image; weights loaded
    in place give new packed layers and so a new image."""
    _, params, port, _, _ = _make(rng, 1, 16, 128, 8, ("self", "cross"))
    image = stats_image(pack_layers(port, torch.float32)[1])
    assert stats_image(pack_layers(port, torch.float32)[1]) is image
    new = jax.tree_util.tree_map(lambda a: np.asarray(a) * 2.0, params)
    load_jax_params(port, new)
    got = stats_image_unpack(stats_image(pack_layers(port, torch.float32)[1]), 128)
    want = np.concatenate([new["layer_1"]["k_proj"]["kernel"], new["layer_1"]["v_proj"]["kernel"]],
                          axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("G,S,C", [(8, 4800, 256), (4, 4800, 256), (8, 4800, 128),
                                   (200, 64, 256), (1, 4837, 256), (3, 1, 128)])
def test_stats_plan(G, S, C):
    """The stats grid: every tile of an image in exactly one run, no run
    empty, and one block a run and head group filling 132 SMs at most once
    unless the images alone need more (a run an image then)."""
    sms = 132
    per, chunks = stats_plan(G, S, C, sms)
    tiles = -(-S // ROW_TILE)
    assert (chunks - 1) * per < tiles <= chunks * per
    blocks = G * chunks * (C // STATS_GROUP)
    assert blocks <= sms or per == tiles
    if per > 1:  # shorter runs would not fit the card at once
        assert G * (C // STATS_GROUP) * -(-tiles // (per - 1)) > sms


@pytest.mark.parametrize("C,nhead", [(128, 4), (256, 8)])
def test_stats_bounds_hold_the_tpu_kernels_stats(rng, C, nhead):
    """`stats_reference_bounds`, the card tests' tolerance for the stats
    kernel, holds the TPU kernel's own stats (`_layer_stats` in interpret
    mode on bf16 operands: another f32 summation order, rounded here once
    as the merge rounds) against the port's plain stats, and is never
    looser than the layer's 5e-2 + 2e-2 |x|."""
    G, S, D = 2, 96, C // nhead
    _, params, port, _, _ = _make(rng, 1, 16, C, nhead, ("self",))
    jsrc = jnp.asarray(rng.standard_normal((G, S, C)).astype(np.float32)).astype(jnp.bfloat16)
    kv, ko = _layer_stats(jsrc, jax_layer_values(params["layer_0"], jnp.bfloat16)[1], 32, True)
    lv = pack_layer(port.layer_0, torch.bfloat16)
    ref_kv, ref_ks, kv_tol, ks_tol = stats_reference_bounds(
        _t(np.asarray(jsrc.astype(jnp.float32))).bfloat16(), lv, nhead)
    m = np.asarray(kv, np.float32).reshape(G, nhead, D, nhead, D)
    blocks = np.stack([m[:, h, :, h] for h in range(nhead)], axis=1)
    got_kv = pack_heads(_t(blocks).bfloat16()).float()
    got_ks = _t(np.asarray(ko, np.float32)[:, :, 0]).bfloat16().float()
    assert ((got_kv - ref_kv).abs() <= kv_tol).all()
    assert ((got_ks - ref_ks).abs() <= ks_tol).all()
    assert (kv_tol <= 5e-2 + 2e-2 * ref_kv.abs()).all()
    assert (ks_tol <= 5e-2 + 2e-2 * ref_ks.abs()).all()


@pytest.mark.parametrize("left_out", [False, True])
def test_stats_bounds_catch_a_tile_left_out(rng, left_out):
    """At the serving forward's self call [8, 4800, 256] (chip_smoke.py's
    weights: N(0, 1 / fan-in)), the plain stats summed in another f32 order
    (64-token tiles, the tiles in reverse) keep to `stats_reference_bounds`,
    and the same sums with one tile of one image left out (the fault a run
    or plan off by one tile would make) break it at many entries of that
    image, kv and ks alike."""
    G, S, C, nhead = 8, 4800, 256, 8
    D = C // nhead
    g = torch.Generator().manual_seed(0)

    def w(i, o):
        return (torch.randn(i, o, generator=g) * i**-0.5).bfloat16()

    ones, zeros = torch.ones(C), torch.zeros(C)
    lv = layer_values(w(C, C), w(C, 2 * C), w(C, C), ones, zeros, w(2 * C, 2 * C), w(2 * C, C),
                      ones, zeros)
    src = _t(rng.standard_normal((G, S, C)).astype(np.float32)).bfloat16()
    ref_kv, ref_ks, kv_tol, ks_tol = stats_reference_bounds(src, lv, nhead)
    K, V = (t.float() for t in _stats_terms(src, lv))
    if left_out:  # tile 10 of image 3
        keep = torch.ones(G, S, 1)
        keep[3, 640:704] = 0
        K, V = K * keep, V * keep
    kv = torch.zeros(G, nhead, D, D)
    ks = torch.zeros(G, C)
    for t0 in reversed(range(0, S, ROW_TILE)):
        Kt, Vt = K[:, t0:t0 + ROW_TILE], V[:, t0:t0 + ROW_TILE]
        kv += torch.einsum("gshd,gshv->ghdv", Kt.view(G, -1, nhead, D), Vt.view(G, -1, nhead, D))
        ks += Kt.sum(dim=1)
    kv_past = (pack_heads(kv.bfloat16()).float() - ref_kv).abs() > kv_tol
    ks_past = (ks.bfloat16().float() - ref_ks).abs() > ks_tol
    if not left_out:
        assert not kv_past.any() and not ks_past.any()
    else:
        others = [i for i in range(G) if i != 3]
        assert not kv_past[others].any() and not ks_past[others].any()
        assert kv_past[3].float().mean() > 0.5 and ks_past[3].float().mean() > 0.9


@pytest.mark.parametrize(
    "case", [(("self", "cross") * 4, 256, 8, 4800), (("self",), 64, 8, 4800),
             (("swap",), 256, 8, 4800), (("self",), 256, 8, 7)],
)
def test_gate_agrees_with_jax(case):
    """The JAX gate's cases. The one difference is the Mosaic rule that the
    token count have a multiple-of-8 divisor (N = 7): CUDA blocks mask their
    ragged last tile, so the port takes it."""
    got = coarse_transformer_supported(*case)
    if case[3] == 7:
        assert got and not jax_coarse_transformer_supported(*case)
    else:
        assert got == jax_coarse_transformer_supported(*case)
