"""The port's plain twin of the differentiable Swin block (K8) against the
JAX package's `swin_block_train` (Pallas, interpret mode, as
`tests/test_pallas_swin_block_grad.py` runs it) and its jnp reference.

At float32, with inputs made by numpy from a seed: the output, dx and every
parameter gradient under autograd, with the shift mask and the drop-path
scales, at head dims 16 and 64, at the JAX test's tolerance (5e-4; 2e-4 for
the output). rel_bias
is also carried back to its (2w-1)^2 table through the port's
`_rel_pos_bias_from_table` index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.models.backbone_swin import (
    _rel_pos_bias_from_table as jax_rel_pos_bias_from_table,
)
from featurematching_tpu.ops.pallas_swin_block_grad import (
    swin_block_train as jax_swin_block_train,
)
from featurematching_tpu.ops.pallas_swin_block_grad import (
    swin_block_train_reference as jax_swin_block_train_reference,
)
from featurematching_tpu_torch.models.backbone_swin import _rel_pos_bias_from_table
from featurematching_tpu_torch.ops.swin_block_train import (
    PARAM_KEYS,
    swin_block_train,
    swin_block_train_reference,
)

N, W = 16, 4  # 4x4 windows keep the interpret-mode kernel quick


def _params(rng, C, h):
    hid = 4 * C

    def r(*s, scale=1.0, shift=0.0):
        return (rng.standard_normal(s) * scale + shift).astype(np.float32)

    return {
        "ln1_scale": r(C, scale=0.1, shift=1.0), "ln1_bias": r(C, scale=0.1),
        "w_qkv": r(C, 3 * C, scale=C**-0.5), "b_qkv": r(3 * C, scale=0.1),
        "rel_bias": r(h, N, N, scale=0.1), "w_proj": r(C, C, scale=C**-0.5),
        "b_proj": r(C, scale=0.1), "ln2_scale": r(C, scale=0.1, shift=1.0),
        "ln2_bias": r(C, scale=0.1), "w_mlp1": r(C, hid, scale=C**-0.5),
        "b_mlp1": r(hid, scale=0.1), "w_mlp2": r(hid, C, scale=hid**-0.5), "b_mlp2": r(C, scale=0.1),
    }


def _torch_grads(fn, x, params, g):
    xt = torch.tensor(x, requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out = fn(xt, pt)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), xt.grad.numpy(), {k: v.grad.numpy() for k, v in pt.items()}


def _jax_grads(fn, x, params, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    dx, dp = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx), {k: np.asarray(v) for k, v in dp.items()}


def _close(got, ref, tol):
    out, dx, dp = got
    rout, rdx, rdp = ref
    np.testing.assert_allclose(out, rout, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dx, rdx, rtol=tol, atol=tol)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(dp[k], rdp[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("masked,scaled", [(False, False), (True, True)])
def test_plain_twin_against_jax(masked, scaled):
    """12 windows of C = 32, 2 heads; the masked case has the JAX test's
    two-region mask on 4 of 6 mask windows (window w takes mask[w % 6]) and
    kills branch 1 on half the windows while scaling the rest by 1/keep."""
    rng = np.random.default_rng(1)
    B_, C, h, nW = 12, 32, 2, 6
    params = _params(rng, C, h)
    x = rng.standard_normal((B_, N, C)).astype(np.float32)
    g = rng.standard_normal((B_, N, C)).astype(np.float32)
    mask = s1 = s2 = None
    if masked:
        mask = np.zeros((nW, N, N), np.float32)
        mask[2:, : N // 2, N // 2:] = -100.0
        mask[2:, N // 2:, : N // 2] = -100.0
    if scaled:
        s1 = (np.arange(B_) % 2).astype(np.float32) / 0.5
        s2 = np.ones(B_, np.float32) / 0.8
    mask_pw = None if mask is None else jnp.asarray(mask)[jnp.arange(B_) % nW]
    js1 = None if s1 is None else jnp.asarray(s1)
    js2 = None if s2 is None else jnp.asarray(s2)
    tm, ts1, ts2 = (None if a is None else torch.tensor(a) for a in (mask, s1, s2))
    got = _torch_grads(lambda x_, p_: swin_block_train(x_, tm, ts1, ts2, p_, h), x, params, g)
    kernel = _jax_grads(lambda x_, p_: jax_swin_block_train(x_, mask_pw, js1, js2, p_, h, 4, True),
                        x, params, g)
    ones = jnp.ones(B_)
    ref = _jax_grads(lambda x_, p_: jax_swin_block_train_reference(
        x_, mask_pw, ones if js1 is None else js1, ones if js2 is None else js2, p_, h),
        x, params, g)
    _close(got, kernel, 5e-4)
    _close(got, ref, 5e-4)


def test_plain_twin_against_jax_at_head_dim_64():
    """tpu_optimized_config()'s head dim 64: 6 windows of C = 64, one head,
    under the two-region mask and drop-path scales, as above."""
    rng = np.random.default_rng(4)
    B_, C, h, nW = 6, 64, 1, 3
    params = _params(rng, C, h)
    x = rng.standard_normal((B_, N, C)).astype(np.float32)
    g = rng.standard_normal((B_, N, C)).astype(np.float32)
    mask = np.zeros((nW, N, N), np.float32)
    mask[1:, : N // 2, N // 2:] = -100.0
    mask[1:, N // 2:, : N // 2] = -100.0
    s1 = (np.arange(B_) % 2).astype(np.float32) / 0.5
    s2 = np.ones(B_, np.float32) / 0.8
    mask_pw = jnp.asarray(mask)[jnp.arange(B_) % nW]
    js1, js2 = jnp.asarray(s1), jnp.asarray(s2)
    tm, ts1, ts2 = (torch.tensor(a) for a in (mask, s1, s2))
    got = _torch_grads(lambda x_, p_: swin_block_train(x_, tm, ts1, ts2, p_, h), x, params, g)
    kernel = _jax_grads(lambda x_, p_: jax_swin_block_train(x_, mask_pw, js1, js2, p_, h, 3, True),
                        x, params, g)
    _close(got, kernel, 5e-4)


def test_rel_bias_gradient_reaches_the_table():
    """d out / d table through the index, as the JAX package chains it."""
    rng = np.random.default_rng(2)
    B_, C, h = 4, 32, 2
    params = _params(rng, C, h)
    table = rng.standard_normal(((2 * W - 1) ** 2, h)).astype(np.float32) * 0.1
    x = rng.standard_normal((B_, N, C)).astype(np.float32)
    g = rng.standard_normal((B_, N, C)).astype(np.float32)

    def jfn(tab):
        p = dict(jax.tree.map(jnp.asarray, params), rel_bias=jax_rel_pos_bias_from_table(tab, W, h))
        return jax_swin_block_train(jnp.asarray(x), None, None, None, p, h, 4, True)

    _, vjp = jax.vjp(jfn, jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    tt = torch.tensor(table, requires_grad=True)
    p = {k: torch.tensor(v) for k, v in params.items()}
    p["rel_bias"] = _rel_pos_bias_from_table(tt, W, h)
    swin_block_train(torch.tensor(x), None, None, None, p, h).backward(torch.tensor(g))
    np.testing.assert_allclose(tt.grad.numpy(), ref, rtol=5e-4, atol=5e-4)


def test_no_gradient_reaches_mask_or_scales():
    rng = np.random.default_rng(3)
    B_, C, h = 4, 32, 2
    p = {k: torch.tensor(v) for k, v in _params(rng, C, h).items()}
    x = torch.tensor(rng.standard_normal((B_, N, C)).astype(np.float32), requires_grad=True)
    mask = torch.zeros(2, N, N, requires_grad=True)
    s = torch.ones(B_, requires_grad=True)
    out = swin_block_train(x, mask, s, s, p, h)
    out.sum().backward()
    assert x.grad is not None and mask.grad is None and s.grad is None
    # scales of 1 are no scales
    ref = swin_block_train_reference(x.detach(), None, None, None, p, h)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("windows,per_sm,sms,grid", [
    (1, 1, 132, 1),          # one window: one block
    (132, 1, 132, 132),      # one window a block: a full wave
    (133, 1, 132, 132),      # one past it: block 0 walks two windows
    (160, 1, 132, 132),      # the training step's C = 256 sites
    (640, 1, 132, 132),      # its C = 128 sites: five rounds
    (2400, 1, 132, 132),     # its C = 64 sites
    (2400, 2, 132, 264),     # two blocks an SM
])
def test_mlp_grid_takes_the_blocks_the_card_holds(windows, per_sm, sms, grid):
    """mlp_bwd's persistent grid: the blocks resident at once (blocks an SM
    x SMs), never more than the windows; each block then walks windows
    blockIdx, + grid, .., so the rounds are ceil(windows / grid)."""
    from featurematching_tpu_torch.ops.swin_block_train import mlp_grid

    assert mlp_grid(windows, per_sm, sms) == grid
    walked = sorted(b + k * grid for b in range(grid) for k in range(-(-windows // grid))
                    if b + k * grid < windows)
    assert walked == list(range(windows))
