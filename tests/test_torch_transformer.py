"""The head-packed linear attention and the form the port's EncoderLayer picks.

flax's EncoderLayer takes `linear_attention_packed` when both sequences are
at most 256 tokens long (the fine windows among them); that form rounds the
attention output to the input dtype and multiplies it by the rounded Z*S.
The port's packed form equals the JAX function at f32 and, bit for bit, in
bf16; it is also held to its rounding points in PyTorch alone, and the fine
transformer in bf16 against flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.models.transformer import (
    LocalFeatureTransformer as JaxLocalFeatureTransformer,
)
from featurematching_tpu.ops.attention import (
    linear_attention_packed as jax_linear_attention_packed,
)
from featurematching_tpu_torch.models import transformer
from featurematching_tpu_torch.ops.attention import (
    elu_feature_map,
    linear_attention,
    linear_attention_packed,
)
from featurematching_tpu_torch.utils.weights import load_jax_params


def _qkv(seed, L, S, H=8, D=8, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, L, H, D)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, S, H, D)).astype(np.float32)
    return [torch.tensor(a).to(dtype) for a in (q, k, v)]


def test_packed_equals_jax_at_f32():
    q, k, v = _qkv(0, 49, 49)
    ref = jax_linear_attention_packed(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(linear_attention_packed(q, k, v).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_packed_equals_jax_bit_for_bit_in_bf16():
    q, k, v = _qkv(2, 49, 49)
    ref = jax_linear_attention_packed(*(jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, k, v)))
    got = linear_attention_packed(*(t.bfloat16() for t in (q, k, v)))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@torch.no_grad()
def test_fine_transformer_in_bf16_against_flax():
    """The fine windows' (self, cross) stack at d=64, 8 heads, 49 tokens, in
    bf16 on both sides: both outputs within one bf16 ulp of their largest
    entry (2^-7 max |x|) and equal on more than nine entries in ten; the
    single rounding the port had before differed on more than a third."""
    rng = np.random.default_rng(0)
    names = ("self", "cross")
    f0, f1 = (rng.standard_normal((4, 49, 64)).astype(np.float32) for _ in range(2))
    j0, j1 = (jnp.asarray(f, jnp.bfloat16) for f in (f0, f1))
    flax_layer = JaxLocalFeatureTransformer(64, 8, names, dtype=jnp.bfloat16)
    params = flax_layer.init(jax.random.PRNGKey(1), j0, j1)["params"]
    refs = [np.asarray(r.astype(jnp.float32))
            for r in jax.jit(flax_layer.apply)({"params": params}, j0, j1)]
    port = transformer.LocalFeatureTransformer(64, 8, names)
    load_jax_params(port, params)

    def run():
        return [t.float().numpy() for t in port(torch.tensor(f0).bfloat16(),
                                                 torch.tensor(f1).bfloat16())]

    for got, ref in zip(run(), refs):
        assert np.abs(got - ref).max() <= 2.0**-7 * np.abs(ref).max()
        assert (got != ref).mean() < 0.1
    form = transformer.attention_form
    try:
        transformer.attention_form = lambda L, S: linear_attention
        old = run()
    finally:
        transformer.attention_form = form
    for got, ref in zip(old, refs):
        assert (got != ref).mean() > 0.3


@pytest.mark.parametrize("L,S,packed", [(49, 49, True), (256, 256, True), (257, 49, False),
                                        (49, 300, False), (4800, 4800, False)])
def test_encoder_layer_picks_the_form_by_length(monkeypatch, L, S, packed):
    calls = []

    def spy(name, fn):
        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(transformer, "linear_attention", spy("per-head", linear_attention))
    monkeypatch.setattr(transformer, "linear_attention_packed",
                        spy("packed", linear_attention_packed))
    layer = transformer.EncoderLayer(64, 8)
    layer(torch.randn(1, L, 64), torch.randn(1, S, 64))
    assert calls == ["packed" if packed else "per-head"]


def test_packed_bf16_rounding_points():
    """out = bf16(Q'·KV) * bf16(Z·S), with KV the bf16 block-diagonal K'ᵀV';
    the per-head form rounds once, at the end, and differs."""
    q, k, v = _qkv(1, 49, 49, dtype=torch.bfloat16)
    B, L, H, D = q.shape
    S, C = k.shape[1], H * D
    Q = elu_feature_map(q).reshape(B, L, C).float()
    K = elu_feature_map(k).reshape(B, S, C).float()
    V = (v / S).reshape(B, S, C).float()
    blocks = torch.block_diag(*[torch.ones(D, D)] * H)
    kv = ((K.transpose(1, 2) @ V) * blocks).bfloat16().float()
    z = 1.0 / ((Q * K.sum(1, keepdim=True)).reshape(B, L, H, D).sum(-1) + 1e-6)
    want = (Q @ kv).bfloat16().reshape(B, L, H, D) * (z * S).bfloat16()[..., None]
    got = linear_attention_packed(q, k, v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert not torch.equal(got, linear_attention(q, k, v))
