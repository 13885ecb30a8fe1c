"""K9: the port's differentiable coarse transformer against the JAX package's.

On the CPU, where `coarse_transformer_train` runs its plain twin, with
inputs made by numpy from a seed and flax weights carried across by
`load_jax_params` (JAX at `highest` matmul precision, tests/conftest.py):

- the stack's value, both input gradients and every parameter gradient
  against flax autodiff of the per-op `LocalFeatureTransformer` at f32, in
  the cases of tests/test_pallas_coarse_grad.py, within 2e-4 of each leaf's
  max as that test holds the TPU kernel;
- one call's backward (`apply_backward_reference`, then
  `stats_backward_reference`) against `pallas_coarse_grad._apply_bwd` and
  `_stats_bwd` in interpret mode, fed the same stats, in f32 and in bf16,
  at head dims 16 and 64;
- the gate and the `use_fused_train` dispatch (fine windows take K10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.models.transformer import (
    LocalFeatureTransformer as JaxLocalFeatureTransformer,
)
from featurematching_tpu.ops.pallas_coarse_grad import _apply_bwd, _blockmask, _stats_bwd
from featurematching_tpu.ops.pallas_coarse_transformer import _layer_stats
from featurematching_tpu.ops.pallas_fine_stage import _layer_values as jax_layer_values
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops import coarse_transformer_train as ctt
from featurematching_tpu_torch.ops.coarse_transformer import (
    pack_heads,
    pack_layer,
    stats_image,
    stats_image_unpack,
)
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree


def _t(a):
    return torch.tensor(np.asarray(a))


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _make(rng, B, N, C, nhead, layer_names):
    f0 = (rng.standard_normal((B, N, C)) * 0.5).astype(np.float32)
    f1 = (rng.standard_normal((B, N, C)) * 0.5).astype(np.float32)
    jm = JaxLocalFeatureTransformer(C, nhead, layer_names)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(f0), jnp.asarray(f1))["params"]
    port = LocalFeatureTransformer(C, nhead, layer_names, use_fused_train=True)
    load_jax_params(port, params)
    return jm, params, port, f0, f1


@pytest.fixture
def backward_calls(monkeypatch):
    """The calls of the plain twin's backward made through the K9 wrapper."""
    calls = []
    twin = ctt.coarse_layer_backward_reference

    def spy(*args):
        calls.append(args)
        return twin(*args)

    monkeypatch.setattr(ctt, "coarse_layer_backward_reference", spy)
    return calls


@pytest.mark.parametrize("B,N,C,nhead,layer_names", [
    (2, 64, 128, 8, ("self", "cross")),
    (1, 96, 128, 4, ("cross", "self", "cross")),
])
def test_stack_gradients_match_flax_autodiff(rng, backward_calls, B, N, C, nhead, layer_names):
    """Value, both input gradients and every weight gradient vs flax
    autodiff of the per-op stack (f32), through the K9 path."""
    jm, params, port, f0, f1 = _make(rng, B, N, C, nhead, layer_names)
    w0 = rng.standard_normal((B, N, C)).astype(np.float32)
    w1 = rng.standard_normal((B, N, C)).astype(np.float32)

    def loss_ref(p, a, b):
        r0, r1 = jm.apply({"params": p}, a, b)
        return jnp.sum(r0 * w0) + 2.0 * jnp.sum(r1 * w1)

    vr, (gp, g0, g1) = jax.value_and_grad(loss_ref, argnums=(0, 1, 2))(
        params, jnp.asarray(f0), jnp.asarray(f1))
    a, b = _t(f0).requires_grad_(), _t(f1).requires_grad_()
    o0, o1 = port(a, b)
    loss = (o0 * _t(w0)).sum() + 2.0 * (o1 * _t(w1)).sum()
    loss.backward()
    calls = sum(1 if n == "self" else 2 for n in layer_names)
    assert len(backward_calls) == calls  # one twin backward an encoder call
    np.testing.assert_allclose(float(loss), float(vr), rtol=1e-4)
    got = _leaves({"params": to_jax_tree(port, grads=True), "f0": a.grad.numpy(),
                   "f1": b.grad.numpy()})
    ref = _leaves({"params": gp, "f0": g0, "f1": g1})
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got[k], r, rtol=2e-4, atol=2e-4 * scale, err_msg=k)


# One call's backward against the TPU kernels, given the same stats. In f32
# the rounding points are no-ops: only the order of f32 sums differs. In bf16
# both sides round at the same points; a sum taken in another order can put
# a value on the other side of a bf16 rounding (2^-8 relative), and the
# port rounds dK_sum once where the TPU kernel rounds dKOnes's entries and
# sums them, so each tensor is held within 2e-2 of its max (a few bf16 ulps).
BF16_REL = 2e-2


def _close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_call_backward_matches_pallas_kernels(rng, kind, dtype):
    _call_backward_against_pallas(rng, kind, dtype, 128, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_call_backward_matches_pallas_kernels_at_head_dim_64(rng, dtype):
    """tpu_optimized_config()'s head dim 64 (here C = 128 with 2 heads, the
    smallest width the TPU kernels take with it), a cross call."""
    _call_backward_against_pallas(rng, "cross", dtype, 128, 2)


def _call_backward_against_pallas(rng, kind, dtype, C, nhead):
    G, N = 2, 64
    D = C // nhead
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, params, port, _, _ = _make(rng, 1, N, C, nhead, ("self",))
    p0 = params["layer_0"]
    x = rng.standard_normal((G, N, C)).astype(np.float32)
    src = x if kind == "self" else rng.standard_normal((G, N, C)).astype(np.float32)
    g = rng.standard_normal((G, N, C)).astype(np.float32)
    jx, jsrc, jg = (jnp.asarray(a).astype(jdt) for a in (x, src, g))
    wvals = jax_layer_values(p0, jdt)
    kv, ko = _layer_stats(jsrc, wvals[1], 32, True)
    bm = _blockmask(C, nhead)
    (jdx, jdkv, jdko, dwq, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b) = _apply_bwd(
        jx, jg, kv, ko, bm, wvals, 32, True)
    jdsrc, jdwkv = _stats_bwd(jsrc, jdkv, jdko, wvals[1], 32, True)

    def blocks(m):  # each head's diagonal [D, D] block of [G, C, C]
        m = np.asarray(m, np.float32).reshape(G, nhead, D, nhead, D)
        return np.stack([m[:, h, :, h] for h in range(nhead)], axis=1)

    lv = pack_layer(port.layer_0, tdt)
    tx, tsrc, tg = (_t(np.asarray(a, np.float32)).to(tdt) for a in (jx, jsrc, jg))
    tkv = pack_heads(_t(blocks(kv)).to(tdt))
    tks = _t(np.asarray(ko)[:, :, 0]).to(tdt)
    rel = 1e-5 if dtype == "float32" else BF16_REL
    got = ctt.apply_backward_reference(tx, tkv, tks, tg, N, lv, nhead)
    ref = (jdx, blocks(jdkv), np.asarray(jdko, np.float32).sum(-1),
           dwq, dwm, dn1s[0], dn1b[0], dw1, dw2, dn2s[0], dn2b[0])
    names = ("dx", "dkv", "dks", "dwq", "dwmerge", "dn1s", "dn1b", "dw1", "dw2", "dn2s", "dn2b")
    for name, a, r in zip(names, got, ref, strict=True):
        _close(a.float().numpy(), r, rel, name)
    # the stats backward on the TPU kernel's own dKV and dKOnes
    dsrc, dwkv = ctt.stats_backward_reference(
        tsrc, _t(blocks(jdkv)), _t(np.asarray(jdko, np.float32).sum(-1)), lv, nhead)
    _close(dsrc.float().numpy(), jdsrc, rel, "dsrc")
    _close(dwkv.numpy(), jdwkv, rel, "dwkv")
    # and the whole call through the wrapper, which runs the twin on the CPU
    dx, dsrc2, wg = ctt.coarse_layer_backward(tx, tsrc, tkv, tks, tg, lv,
                                              ctt.train_values(lv), nhead)
    assert torch.equal(dx, got[0]) and len(wg) == 9
    assert dsrc2.shape == tsrc.shape and dsrc2.dtype == tdt


def test_gate():
    assert ctt.coarse_train_supported(("self", "cross") * 4, 256, 8, 4800)
    assert ctt.coarse_train_supported(("cross",), 128, 4, 7)  # ragged tiles are masked
    assert not ctt.coarse_train_supported(("self",), 64, 8, 4800)  # C % 128
    assert ctt.coarse_train_supported(("self", "cross") * 4, 256, 4, 4800)  # head dim 64
    assert not ctt.coarse_train_supported(("self",), 128, 2, 4800)  # head dim 64 at C = 128
    # the backward takes exactly these (C, head dim) pairs
    assert ctt.TRAIN_WIDTHS == ((128, 16), (128, 32), (256, 16), (256, 32), (256, 64))
    assert not ctt.coarse_train_supported(("swap",), 256, 8, 4800)


def _grads_through(tf, f0, f1):
    a, b = f0.clone().requires_grad_(), f1.clone().requires_grad_()
    o0, o1 = tf(a, b)
    (o0.square().sum() + o1.square().sum()).backward()
    return [a.grad, b.grad] + [p.grad for p in tf.parameters()]


@pytest.mark.parametrize("C,N0,N1", [(64, 160, 160), (128, 64, 80)])
def test_dispatch_falls_back_to_the_per_op_stack(rng, backward_calls, C, N0, N1):
    """C = 64 (the coarse gate fails; 160 tokens, too many for the fine
    gate) and features of unequal shapes take the per-op stack: no K9 call,
    and the gradients equal those of the stack with the switch off."""
    names = ("self", "cross")
    f0 = _t(rng.standard_normal((1, N0, C)).astype(np.float32))
    f1 = _t(rng.standard_normal((1, N1, C)).astype(np.float32))
    on = LocalFeatureTransformer(C, 8, names, use_fused_train=True)
    off = LocalFeatureTransformer(C, 8, names)
    off.load_state_dict(on.state_dict())
    got, ref = _grads_through(on, f0, f1), _grads_through(off, f0, f1)
    assert backward_calls == []
    for a, r in zip(got, ref, strict=True):
        assert torch.isfinite(a).all() and torch.equal(a, r)


def test_dispatch_takes_k10_for_fine_windows(rng, backward_calls, monkeypatch):
    """Fine windows (C = 64, 49 tokens) fail the coarse gate and pass the
    fine one: the switch no longer raises but takes K10 (its plain twin
    here), as flax does, and no K9 call."""
    from featurematching_tpu_torch.ops import fine_transformer_train as ftt

    k10 = []
    twin = ftt.fine_layer_backward_reference
    monkeypatch.setattr(ftt, "fine_layer_backward_reference",
                        lambda *a: k10.append(1) or twin(*a))
    tf = LocalFeatureTransformer(64, 8, ("self", "cross"), use_fused_train=True)
    w = _t(rng.standard_normal((4, 49, 64)).astype(np.float32)).requires_grad_()
    o0, o1 = tf(w, w * 0.5)
    (o0.sum() + o1.sum()).backward()
    assert (len(k10), len(backward_calls)) == (3, 0)
    assert torch.isfinite(w.grad).all()


def test_no_grad_saves_nothing(rng, monkeypatch):
    """Under no_grad the stack runs the same forward without the Function."""
    _, _, port, f0, f1 = _make(rng, 1, 64, 128, 8, ("self", "cross"))
    def applied(*args):
        raise AssertionError("the autograd Function ran under no_grad")

    monkeypatch.setattr(ctt.CoarseTransformerTrain, "apply", applied)
    with torch.no_grad():
        o0, o1 = port(_t(f0), _t(f1))
    assert o0.shape == (1, 64, 128) and torch.isfinite(o1).all()


def test_forward_sees_weights_the_optimizer_wrote(rng):
    """The fused AdamW step writes the parameters without bumping their
    version counters: the next forward must still use the new weights."""
    _, _, port, f0, f1 = _make(rng, 1, 64, 128, 8, ("self", "cross"))
    a, b = _t(f0), _t(f1)
    o0, o1 = port(a, b)
    (o0.square().sum() + o1.square().sum()).backward()
    versions = [p._version for p in port.parameters()]
    torch.optim.AdamW(port.parameters(), lr=0.1, fused=True).step()
    assert [p._version for p in port.parameters()] == versions  # the trap
    fresh = LocalFeatureTransformer(128, 8, ("self", "cross"), use_fused_train=True)
    fresh.load_state_dict(port.state_dict())
    got, ref = port(a, b), fresh(a, b)
    assert not torch.equal(got[0], o0)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_stats_image_sees_weights_the_optimizer_wrote(rng):
    """The fused AdamW step writes the parameters without bumping their
    version counters. The forward packs its layers anew each call
    (`coarse_transformer_train`), so the stats kernel's weight image made
    from them holds the new wk and wv."""
    _, _, port, f0, f1 = _make(rng, 1, 64, 128, 8, ("self", "cross"))
    o0, o1 = port(_t(f0), _t(f1))
    (o0.square().sum() + o1.square().sum()).backward()
    before = stats_image(pack_layer(port.layer_0, torch.float32))
    torch.optim.AdamW(port.parameters(), lr=0.1, fused=True).step()
    after = stats_image(pack_layer(port.layer_0, torch.float32))
    layer = port.layer_0
    wkv = torch.cat([layer.k_proj.weight.detach().t(), layer.v_proj.weight.detach().t()], dim=1)
    assert not torch.equal(after, before)
    assert torch.equal(stats_image_unpack(after, 128), wkv)


def _sw128(row, col):
    """Element offset of (row, col) in [rows, 64] bf16 rows in the 128-byte
    swizzle: 16-byte chunk col // 8 of row `row` at chunk position
    (col // 8) ^ (row % 8)."""
    return row * 64 + (((col // 8) ^ row) % 8) * 8 + col % 8


@pytest.mark.parametrize("C", [128, 256])
def test_stats_bwd_image_reads_both_ways(rng, C):
    """stats_bwd's weight image, as the kernel's descriptors address a
    unit's C / 64 boxes of [64, 64] (4096 values each): K-major
    (`sw128_desc`, N the box's 64 rows, K its 64 columns) it is the B
    operand of [K | V] = src W_u, W_u = [wk_u | wv_u] [C, 64]; MN-major
    (`sw128_mn_desc`: K rows in 8-row atoms, the N columns in 64-wide
    blocks a box apart) it is the B of dsrc += [dkf | dv]_u W_uᵀ, whose
    four k-steps are the unit's 16-row slices. Over the units the second
    reading gives [dkf | dv] wkvᵀ. The image of a packed layer is the
    plain image of its weights, and it unpacks to wkv."""
    unit = ctt.SB_UNIT
    wkv = torch.tensor(rng.standard_normal((C, 2 * C)), dtype=torch.float32)
    image = ctt.stats_bwd_image_plain(wkv)
    assert image.shape == (2 * C * C,) and torch.equal(ctt.stats_bwd_image_unpack(image, C), wkv)
    c = torch.arange(C)[:, None]  # the input (W_u's row)
    j = torch.arange(2 * unit)[None, :]  # the unit's output (W_u's column)
    kmajor = (c // 64) * 4096 + _sw128(j, c % 64)  # K = c, N = j
    mn = (c // 64) * 4096 + (j // 8) * 512 + _sw128(j % 8, c % 64)  # K = j, N = c
    a = torch.tensor(rng.standard_normal((5, 2 * C)), dtype=torch.float32)  # [dkf | dv] rows
    dsrc = torch.zeros(5, C)
    for u in range(C // unit):
        base = u * C * 2 * unit
        wu = torch.cat([wkv[:, unit * u:unit * (u + 1)], wkv[:, C + unit * u:C + unit * (u + 1)]],
                       dim=1)
        assert torch.equal(image[base + kmajor], wu)
        bt = image[base + mn].t()  # [K = 64 outputs, N = C inputs]
        assert torch.equal(bt, wu.t())
        au = torch.cat([a[:, unit * u:unit * (u + 1)], a[:, C + unit * u:C + unit * (u + 1)]],
                       dim=1)
        for kk in range(2 * unit // 16):  # the product's k-steps
            dsrc += au[:, 16 * kk:16 * kk + 16] @ bt[16 * kk:16 * kk + 16]
    torch.testing.assert_close(dsrc, a @ wkv.t(), rtol=1e-5, atol=1e-4)
    torch.manual_seed(0)
    layer = LocalFeatureTransformer(C, 8, ("self",), use_fused_train=True).layer_0
    lv = pack_layer(layer, torch.float32)
    assert torch.equal(ctt.stats_bwd_image(lv), ctt.stats_bwd_image_plain(ctt.frag_unpack(lv.wkv)))
