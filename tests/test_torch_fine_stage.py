"""K6: the port's fine stage against the JAX package's.

`fine_stage_reference` (what `fine_stage_fused` runs on the CPU) against
`ops/pallas_fine_stage.fine_stage_fused` in interpret mode, in both output
modes, on the same flax weights carried across by `load_jax_params`, at
float32 (JAX at `highest` matmul precision, tests/conftest.py). Also
`fine_from_heatmaps` against its JAX counterpart, and the layout of the
kernel's weight image (`fine_image`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.matching.fine import fine_from_heatmaps as jax_fine_from_heatmaps
from featurematching_tpu.models.transformer import (
    LocalFeatureTransformer as JaxLocalFeatureTransformer,
)
from featurematching_tpu.ops.pallas_fine_stage import fine_stage_fused as jax_fine_stage_fused
from featurematching_tpu.ops.pallas_fine_stage import (
    fine_stage_supported as jax_fine_stage_supported,
)
from featurematching_tpu_torch.matching.fine import fine_from_heatmaps
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops.coarse_transformer import frag_pack, layer_values, pack_layers
from featurematching_tpu_torch.ops.fine_stage import (
    fine_image,
    fine_image_plain,
    fine_image_unpack,
    fine_stage_fused,
    fine_stage_reference,
    fine_stage_supported,
)
from featurematching_tpu_torch.utils.weights import load_jax_params


def _t(a):
    return torch.tensor(np.asarray(a))


def _make(rng, B_, N, C, nhead, layer_names):
    w0 = rng.standard_normal((B_, N, C)).astype(np.float32)
    w1 = rng.standard_normal((B_, N, C)).astype(np.float32)
    jm = JaxLocalFeatureTransformer(C, nhead, layer_names)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(w0), jnp.asarray(w1))["params"]
    mixes = [{"kernel": (0.3 * rng.standard_normal((N, 1))).astype(np.float32),
              "bias": rng.standard_normal(1).astype(np.float32)} for _ in range(2)]
    port = LocalFeatureTransformer(C, nhead, layer_names)
    load_jax_params(port, params)
    port_mixes = [(_t(m["kernel"][:, 0]), _t(m["bias"])) for m in mixes]
    return params, mixes, pack_layers(port, torch.float32), port_mixes, w0, w1


CASES = [
    (8, 49, 64, 8, ("self", "cross")),
    (6, 25, 64, 4, ("self", "cross")),
    (4, 49, 128, 8, ("self", "cross", "self", "cross")),
    (4, 49, 64, 1, ("cross",)),
    (4, 49, 64, 1, ("self", "cross")),  # tpu_optimized_config()'s fine 64/1
]


@pytest.mark.parametrize("B_,N,C,nhead,layer_names", CASES)
def test_plain_mode_matches_pallas_f32(rng, B_, N, C, nhead, layer_names):
    params, mixes, layers, pmixes, w0, w1 = _make(rng, B_, N, C, nhead, layer_names)
    ref = jax_fine_stage_fused(jnp.asarray(w0), jnp.asarray(w1), params, *mixes,
                               layer_names, nhead, chunk=2, interpret=True)
    got = fine_stage_reference(_t(w0), _t(w1), layers, *pmixes, layer_names, nhead)
    wrapped = fine_stage_fused(_t(w0), _t(w1), layers, *pmixes, layer_names, nhead)
    assert [tuple(g.shape) for g in got] == [(B_, N, C), (B_, N, C), (B_, C), (B_, C)]
    for g, w, r in zip(got, wrapped, ref, strict=True):
        np.testing.assert_array_equal(w.numpy(), g.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B_,N,C,nhead,layer_names", CASES[:2] + CASES[3:])
def test_fold_mode_matches_pallas_f32(rng, B_, N, C, nhead, layer_names):
    """Heatmaps [B_, N]: padded taps carry no mass, rows sum to 1."""
    params, mixes, layers, pmixes, w0, w1 = _make(rng, B_, N, C, nhead, layer_names)
    ref = jax_fine_stage_fused(jnp.asarray(w0), jnp.asarray(w1), params, *mixes,
                               layer_names, nhead, chunk=2, interpret=True,
                               fold_softargmax=True)
    got = fine_stage_fused(_t(w0), _t(w1), layers, *pmixes, layer_names, nhead,
                           fold_softargmax=True)
    for g, r in zip(got, ref, strict=True):
        assert tuple(g.shape) == (B_, N) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_fine_from_heatmaps(rng):
    B, K = 2, 6
    logits = rng.standard_normal((2, B, K, 49)).astype(np.float32)
    heat = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    kp = (100 * rng.random((2, B, K, 2))).astype(np.float32)
    ref = jax_fine_from_heatmaps(jnp.asarray(heat[0]), jnp.asarray(heat[1]),
                                 jnp.asarray(kp[0]), jnp.asarray(kp[1]), 7, 2.0)
    got = fine_from_heatmaps(_t(heat[0]), _t(heat[1]), _t(kp[0]), _t(kp[1]), 7, 2.0)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "case", [(("self", "cross"), 64, 8), (("self", "cross"), 128, 8),
             (("self", "cross"), 8, 2), (("swap",), 64, 8)],
)
def test_gate_agrees_with_jax(case):
    assert fine_stage_supported(*case) == jax_fine_stage_supported(*case)


def _image_weights(C):
    """wq [C, C], wkv [C, 2C], wmerge [C, C], wmlp1 [2C, 2C], wmlp2 [2C, C]
    holding distinct values."""
    shapes = ((C, C), (C, 2 * C), (C, C), (2 * C, 2 * C), (2 * C, C))
    sizes = [k * n for k, n in shapes]
    flat = torch.arange(sum(sizes), dtype=torch.float64)
    return [p.reshape(shape) for p, shape in zip(torch.split(flat, sizes), shapes, strict=True)]


@pytest.mark.parametrize("C", [64, 128])
def test_fine_image_round_trip(C):
    """The kernel's weight image holds every weight once, 10 C^2 values, and
    unpacks to the weights; made from the packed LayerValues by one gather,
    it equals the plain image and is kept while the weights stay."""
    ws = _image_weights(C)
    image = fine_image_plain(*ws)
    assert image.shape == (10 * C * C,)
    assert torch.equal(torch.sort(image).values, torch.arange(10.0 * C * C, dtype=torch.float64))
    for got, w in zip(fine_image_unpack(image, C), ws, strict=True):
        assert torch.equal(got, w)
    ones, zeros = torch.ones(C), torch.zeros(C)
    lv = layer_values(ws[0], ws[1], ws[2], ones, zeros, ws[3], ws[4], ones, zeros)
    got = fine_image(lv)
    assert torch.equal(got, image)
    assert fine_image(lv) is got
    lv2 = lv._replace(wkv=frag_pack(2 * ws[1]))
    assert torch.equal(fine_image_unpack(fine_image(lv2), C)[1], 2 * ws[1])
    lv.wmlp2.mul_(2)  # an in-place change of a weight is seen
    assert torch.equal(fine_image_unpack(fine_image(lv), C)[4], 2 * ws[4])


@pytest.mark.parametrize("C", [64, 128])
def test_fine_image_layout(C):
    """Entries at the offsets the kernel reads them from (csrc/wgmma.cuh,
    csrc/fine_stage.cu): each k-step of a product is [N, 16] K-major, core
    matrices of 8 rows x 8 k values, (n // 8, k // 8) row-major, 64 values
    each; wq, wkv, wmerge, wmlp1 and wmlp2 one after another, so N columns
    of a wider weight (K's or V's half of wkv, a half of wmlp1) are the
    first or second half of each of its k-steps."""
    ws = _image_weights(C)
    image = fine_image_plain(*ws)

    def at(k, n, N):  # offset of B[k, n] in the k-step tiles of a [K, N] operand
        kk = k % 16
        return (k // 16) * 16 * N + ((n // 8) * 2 + kk // 8) * 64 + (n % 8) * 8 + kk % 8

    base = 0
    for w in ws:
        K, N = w.shape
        for k, n in ((0, 0), (9, 3), (K - 1, N - 1), (17, N // 2 + 5), (K // 2, N // 2)):
            assert image[base + at(k, n, N)] == w[k, n]
        half = (k // 16) * 16 * N + 8 * N + at(k % 16, n % (N // 2), N // 2)
        assert image[base + half] == w[k, N // 2 + n % (N // 2)]  # the second half's k-step
        base += K * N
