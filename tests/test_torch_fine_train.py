"""K10: the port's differentiable fine transformer against the JAX package's.

On the CPU, where `fine_transformer_train` runs its plain twin, with inputs
made by numpy from a seed and flax weights carried across by
`load_jax_params` (JAX at `highest` matmul precision, tests/conftest.py):

- the stack's value, both input gradients and every parameter gradient
  against flax autodiff of the per-op `LocalFeatureTransformer` at f32, in
  the fine cases of tests/test_pallas_fine_grad.py, within 2e-4 of each
  leaf's max;
- one layer's backward (`layer_backward` over the plain twin) against
  `pallas_fine_grad._layer_bwd_call` in interpret mode, in f32 and in bf16
  (head dims 8 and 64),
  the cross layer with and without the saved o0;
- the gate, the `use_fused_train` dispatch, no saving under no_grad, and
  weights written by a fused optimizer step seen by the next forward;
- the window stage's weight image (`train_image`): its layout, its round
  trip, and its cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.models.transformer import (
    LocalFeatureTransformer as JaxLocalFeatureTransformer,
)
from featurematching_tpu.ops.pallas_fine_grad import _layer_bwd_call
from featurematching_tpu.ops.pallas_fine_stage import _layer_values as jax_layer_values
from featurematching_tpu.ops.pallas_fine_stage import fine_stage_fused as jax_fine_stage_fused
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops import fine_transformer_train as ftt
from featurematching_tpu_torch.ops.coarse_transformer import (
    encoder_reference,
    frag_pack,
    layer_values,
    pack_layer,
)
from featurematching_tpu_torch.ops.fine_stage import fine_layer_forward, fine_train_supported
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree


def _t(a):
    return torch.tensor(np.asarray(a))


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _make(rng, B_, N, C, nhead, layer_names):
    f0 = (rng.standard_normal((B_, N, C)) * 0.5).astype(np.float32)
    f1 = (rng.standard_normal((B_, N, C)) * 0.5).astype(np.float32)
    jm = JaxLocalFeatureTransformer(C, nhead, layer_names)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(f0), jnp.asarray(f1))["params"]
    port = LocalFeatureTransformer(C, nhead, layer_names, use_fused_train=True)
    load_jax_params(port, params)
    return jm, params, port, f0, f1


@pytest.fixture
def backward_calls(monkeypatch):
    """The calls of the plain twin's backward made through the K10 wrapper."""
    calls = []
    twin = ftt.fine_layer_backward_reference

    def spy(*args):
        calls.append(args)
        return twin(*args)

    monkeypatch.setattr(ftt, "fine_layer_backward_reference", spy)
    return calls


@pytest.mark.parametrize("B_,N,C,nhead,layer_names", [
    (8, 49, 64, 8, ("self", "cross")),
    (6, 25, 64, 4, ("cross", "self")),
])
def test_stack_gradients_match_flax_autodiff(rng, backward_calls, B_, N, C, nhead, layer_names):
    """Value, both input gradients and every weight gradient vs flax
    autodiff of the per-op stack (f32), through the K10 path."""
    jm, params, port, f0, f1 = _make(rng, B_, N, C, nhead, layer_names)
    c0 = rng.standard_normal((B_, N, C)).astype(np.float32)
    c1 = rng.standard_normal((B_, N, C)).astype(np.float32)

    def loss_ref(p, a, b):
        r0, r1 = jm.apply({"params": p}, a, b)
        return jnp.sum(r0 * c0) + 2.0 * jnp.sum(r1 * c1)

    vr, (gp, g0, g1) = jax.jit(jax.value_and_grad(loss_ref, argnums=(0, 1, 2)))(
        params, jnp.asarray(f0), jnp.asarray(f1))
    a, b = _t(f0).requires_grad_(), _t(f1).requires_grad_()
    o0, o1 = port(a, b)
    loss = (o0 * _t(c0)).sum() + 2.0 * (o1 * _t(c1)).sum()
    loss.backward()
    assert len(backward_calls) == sum(1 if n == "self" else 2 for n in layer_names)
    np.testing.assert_allclose(float(loss), float(vr), rtol=1e-4)
    got = _leaves({"params": to_jax_tree(port, grads=True), "f0": a.grad.numpy(),
                   "f1": b.grad.numpy()})
    ref = _leaves({"params": gp, "f0": g0, "f1": g1})
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got[k], r, rtol=2e-4, atol=2e-4 * scale, err_msg=k)


# One layer's backward against the TPU kernel. In f32 the rounding points
# are no-ops: only the order of f32 sums differs. In bf16 both sides round
# at the same points; a sum taken in another order can put a value on the
# other side of a bf16 rounding (2^-8 relative), the port rounds dK_sum once
# where the TPU kernel rounds dKOnes's entries and sums them, so entries are
# held within 2e-2 of the tensor's max (a few bf16 ulps), as K9's call is.
# A bf16 rounding that falls the other way in the recomputed forward (one K
# entry of one window at this seed) moves that window's attention and can
# flip a ReLU, which moves a few entries by more: in bf16 all but 0.5% of the
# entries are held so, and the whole tensor within 2e-2 of its norm.
BF16_REL = 2e-2
BF16_OUTLIERS = 5e-3


def _close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    if rel < BF16_REL:
        np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * float(np.abs(ref).max()),
                                   err_msg=name)
        return
    err = np.abs(got - ref)
    off = float((err > rel * (np.abs(ref) + float(np.abs(ref).max()))).mean())
    assert off <= BF16_OUTLIERS, f"{name}: {off:.2e} of the entries off"
    assert np.linalg.norm(err) <= rel * np.linalg.norm(ref), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,with_o0", [("self", False), ("cross", False), ("cross", True)])
def test_layer_backward_matches_pallas_kernel(rng, kind, with_o0, dtype):
    _layer_backward_against_pallas(rng, kind, with_o0, dtype, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_backward_matches_pallas_kernel_at_head_dim_64(rng, dtype):
    """tpu_optimized_config()'s fine stage: one head of 64, a cross layer
    with the forward's first output saved."""
    _layer_backward_against_pallas(rng, "cross", True, dtype, 1)


def _layer_backward_against_pallas(rng, kind, with_o0, dtype, nhead):
    G, N, C = 4, 49, 64
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, params, port, _, _ = _make(rng, 1, N, C, nhead, ("self",))
    x0, x1, d0, d1 = (rng.standard_normal((G, N, C)).astype(np.float32) for _ in range(4))
    jx0, jx1, jd0, jd1 = (jnp.asarray(a).astype(jdt) for a in (x0, x1, d0, d1))
    lv = pack_layer(port.layer_0, tdt)
    tx0, tx1, td0, td1 = (_t(np.asarray(a, np.float32)).to(tdt) for a in (jx0, jx1, jd0, jd1))
    o0 = jo0 = None
    if kind == "cross":  # the forward's first output, as the JAX forward saves it
        zmix = {"kernel": jnp.zeros((N, 1), jnp.float32), "bias": jnp.zeros((1,), jnp.float32)}
        jo0 = jax_fine_stage_fused(jx0, jx1, params, zmix, zmix, (kind,), nhead, chunk=G,
                                   interpret=True)[0]
        o0 = _t(np.asarray(jo0, np.float32)).to(tdt)
    wvals = jax_layer_values(params["layer_0"], jdt)
    jo0 = jo0 if with_o0 else None  # None: the TPU kernel replays it
    rdx0, rdx1, rwg = _layer_bwd_call(kind, jx0, jx1, jd0, jd1, wvals, nhead, N, G, True, o0=jo0)
    gdx0, gdx1, gwg = ftt.layer_backward(kind, tx0, tx1, o0, td0, td1, lv, nhead)
    rel = 1e-5 if dtype == "float32" else BF16_REL
    _close(gdx0.float().numpy(), rdx0, rel, "dx0")
    _close(gdx1.float().numpy(), rdx1, rel, "dx1")
    names = ("dwq", "dwkv", "dwmerge", "dn1s", "dn1b", "dw1", "dw2", "dn2s", "dn2b")
    for name, a, r in zip(names, gwg, rwg, strict=True):
        _close(a.numpy(), np.asarray(r).reshape(a.shape), rel, name)


def test_gate():
    """What the kernels take: C = 64, head dim 8, 16 or 64, at most 64 taps,
    any number of self/cross layers (one launch a layer)."""
    assert fine_train_supported(("self", "cross"), 64, 8, 49)
    assert fine_train_supported(("self", "cross") * 3, 64, 4, 64)
    assert not fine_train_supported(("self", "cross", "self", "cross"), 128, 8, 49)  # C = 128
    assert not fine_train_supported(("self",), 64, 16, 49)  # head dim 4
    assert fine_train_supported(("self", "cross"), 64, 1, 49)  # head dim 64
    assert not fine_train_supported(("self",), 64, 2, 49)  # head dim 32
    assert not fine_train_supported(("self",), 64, 8, 65)  # taps
    assert not fine_train_supported(("swap",), 64, 8, 49)


def _grads_through(tf, f0, f1):
    a, b = f0.clone().requires_grad_(), f1.clone().requires_grad_()
    o0, o1 = tf(a, b)
    (o0.square().sum() + o1.square().sum()).backward()
    return [a.grad, b.grad] + [p.grad for p in tf.parameters()]


def test_c128_takes_no_k10(rng, backward_calls):
    """The JAX test case (4, 49, 128, 8, 4 layers) fails the port's fine
    gate: no K10 call. C = 128 passes the coarse gate, so the switch takes
    K9 (its twin here), whose gradients equal those of the per-op stack
    switched off to f32 rounding. The weights come from a fixed seed: the two
    stacks sum in other orders, so for some weights (about 5 seeds in 100) a
    ReLU input within f32 rounding of 0 takes the other branch and moves a
    few entries by more than the tolerance."""
    names = ("self", "cross", "self", "cross")
    f0, f1 = (_t(rng.standard_normal((4, 49, 128)).astype(np.float32)) for _ in range(2))
    torch.manual_seed(0)
    on = LocalFeatureTransformer(128, 8, names, use_fused_train=True)
    off = LocalFeatureTransformer(128, 8, names)
    off.load_state_dict(on.state_dict())
    got, ref = _grads_through(on, f0, f1), _grads_through(off, f0, f1)
    assert backward_calls == []
    for a, r in zip(got, ref, strict=True):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


def test_forward_is_k6s_layer_by_layer(rng):
    """The Function's forward is `fine_layer_forward` a layer, which on the
    CPU is the plain encoder in the stack's order (cross: w1 attends the
    updated w0)."""
    _, _, port, f0, f1 = _make(rng, 3, 49, 64, 8, ("self", "cross"))
    a, b = _t(f0), _t(f1)
    lvs = [pack_layer(getattr(port, f"layer_{i}"), torch.float32) for i in range(2)]
    ref0, ref1 = encoder_reference(a, a, lvs[0], 8), encoder_reference(b, b, lvs[0], 8)
    ref0 = encoder_reference(ref0, ref1, lvs[1], 8)
    ref1 = encoder_reference(ref1, ref0, lvs[1], 8)
    s0, s1 = fine_layer_forward(a, b, lvs[0], "self", 8)
    got = fine_layer_forward(s0, s1, lvs[1], "cross", 8)
    for g, r in zip(got, (ref0, ref1)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        out = port(a, b)
    for g, r in zip(out, got):
        assert torch.equal(g, r)


def test_no_grad_saves_nothing(rng, monkeypatch):
    """Under no_grad the stack runs the same forward without the Function."""
    _, _, port, f0, f1 = _make(rng, 2, 49, 64, 8, ("self", "cross"))

    def applied(*args):
        raise AssertionError("the autograd Function ran under no_grad")

    monkeypatch.setattr(ftt.FineTransformerTrain, "apply", applied)
    with torch.no_grad():
        o0, o1 = port(_t(f0), _t(f1))
    assert o0.shape == (2, 49, 64) and torch.isfinite(o1).all()


def test_forward_sees_weights_the_optimizer_wrote(rng):
    """The fused AdamW step writes the parameters without bumping their
    version counters: the next forward must still use the new weights."""
    _, _, port, f0, f1 = _make(rng, 2, 49, 64, 8, ("self", "cross"))
    a, b = _t(f0), _t(f1)
    o0, o1 = port(a, b)
    (o0.square().sum() + o1.square().sum()).backward()
    versions = [p._version for p in port.parameters()]
    torch.optim.AdamW(port.parameters(), lr=0.1, fused=True).step()
    assert [p._version for p in port.parameters()] == versions  # the trap
    fresh = LocalFeatureTransformer(64, 8, ("self", "cross"), use_fused_train=True)
    fresh.load_state_dict(port.state_dict())
    got, ref = port(a, b), fresh(a, b)
    assert not torch.equal(got[0], o0)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("C", [64, 128])
def test_train_image_round_trip(C):
    """The window stage's weight image holds every weight once, 10 C^2
    values, each weight W [in, out] as the 64-row blocks of its input
    transposed, [out, 64] boxes in the 128-byte swizzle (row r's 16-byte
    chunk c at chunk position c ^ (r % 8)); it unpacks to the weights; made
    from the packed LayerValues by one gather it equals the plain image, and
    it is kept while the weights stay the same tensors at the same
    versions."""
    shapes = ((C, C), (C, 2 * C), (C, C), (2 * C, 2 * C), (2 * C, C))
    sizes = [k * n for k, n in shapes]
    flat = torch.arange(sum(sizes), dtype=torch.float64)
    ws = [p.reshape(shape) for p, shape in zip(torch.split(flat, sizes), shapes, strict=True)]
    image = ftt.train_image_plain(*ws)
    assert image.shape == (10 * C * C,)
    assert torch.equal(torch.sort(image).values, flat)
    for got, w in zip(ftt.train_image_unpack(image, C), ws, strict=True):
        assert torch.equal(got, w)
    # wkv's box (the image's second): element (r, c) of W[:64]ᵀ, r = its output
    box = image[C * C:C * C + 2 * C * 64]
    for r, c in ((0, 0), (1, 0), (5, 17), (9, 63), (2 * C - 1, 40)):
        assert box[r * 64 + ((c // 8) ^ (r % 8)) * 8 + c % 8] == ws[1][c, r]
    ones, zeros = torch.ones(C), torch.zeros(C)
    lv = layer_values(ws[0], ws[1], ws[2], ones, zeros, ws[3], ws[4], ones, zeros)
    got = ftt.train_image(lv)
    assert torch.equal(got, image)
    assert ftt.train_image(lv) is got
    lv2 = lv._replace(wkv=frag_pack(2 * ws[1]))
    assert torch.equal(ftt.train_image_unpack(ftt.train_image(lv2), C)[1], 2 * ws[1])
    lv.wmlp2.mul_(2)  # an in-place change of a weight is seen
    assert torch.equal(ftt.train_image_unpack(ftt.train_image(lv), C)[4], 2 * ws[4])
