"""The port's sparse focal loss (K7's plain twin and its forward) against the
JAX package's `sparse_focal_loss` and `naive_sparse_focal_loss`.

At float32, with inputs made by numpy from a seed: the loss value and
df0 / df1 with masked rows and duplicate GT pairs, and the plain
row / column log-sum-exps and the backward's softmax terms against the
materialised loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.ops.sparse_focal_loss import (
    naive_sparse_focal_loss as jax_naive_sparse_focal_loss,
)
from featurematching_tpu.ops.sparse_focal_loss import sparse_focal_loss as jax_sparse_focal_loss
from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_lse
from featurematching_tpu_torch.ops.sparse_focal_loss import (
    naive_sparse_focal_loss,
    per_pair_loss_and_grad,
    sparse_focal_backward,
    sparse_focal_loss,
)


def _inputs(seed, B=2, L=70, S=56, C=32, G=24):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, S, C)).astype(np.float32)
    f0 = 0.6 * rng.standard_normal((B, L, C)).astype(np.float32)
    f0[:, :S] += f1  # row i < S is most like column i: confident pairs
    gi = rng.integers(0, L, (B, G)).astype(np.int32)
    gj = rng.integers(0, S, (B, G)).astype(np.int32)
    gi[:, :8] = gj[:, :8] = np.arange(8)  # pairs near the clip at 1
    gi[:, 8:10], gj[:, 8:10] = gi[:, 10:12], gj[:, 10:12]  # duplicate pairs
    mask = rng.random((B, G)) < 0.75
    return f0, f1, gi, gj, mask, 1.0 / (C * 0.1)


def _port(f0, f1, gi, gj, mask, inv_temp, fn=sparse_focal_loss):
    a, b = torch.tensor(f0, requires_grad=True), torch.tensor(f1, requires_grad=True)
    loss = fn(a, b, torch.tensor(gi).long(), torch.tensor(gj).long(), torch.tensor(mask), inv_temp)
    loss.backward()
    return float(loss), a.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_value_and_gradients_against_jax(seed):
    f0, f1, gi, gj, mask, inv_temp = _inputs(seed)
    got = _port(f0, f1, gi, gj, mask, inv_temp)
    args = (jnp.asarray(gi), jnp.asarray(gj), jnp.asarray(mask), inv_temp)
    for fn in (jax_sparse_focal_loss, jax_naive_sparse_focal_loss):
        loss, (d0, d1) = jax.value_and_grad(lambda a, b: fn(a, b, *args), argnums=(0, 1))(
            jnp.asarray(f0), jnp.asarray(f1))
        np.testing.assert_allclose(got[0], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got[1], np.asarray(d0), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[2], np.asarray(d1), rtol=1e-4, atol=1e-6)


def test_port_naive_loss_agrees():
    f0, f1, gi, gj, mask, inv_temp = _inputs(2)
    got = _port(f0, f1, gi, gj, mask, inv_temp)
    ref = _port(f0, f1, gi, gj, mask, inv_temp, fn=naive_sparse_focal_loss)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=1e-6)


def test_lse_and_softmax_terms():
    """The plain LSEs equal logsumexp of the materialised sim; the softmax
    terms equal the gradient of -sum(a_r lse_r) - sum(a_c lse_c)."""
    f0, f1, *_, inv_temp = _inputs(3)
    rng = np.random.default_rng(4)
    a_r = torch.tensor(rng.random((2, 70)).astype(np.float32))
    a_c = torch.tensor(rng.random((2, 56)).astype(np.float32))
    t0, t1 = torch.tensor(f0, requires_grad=True), torch.tensor(f1, requires_grad=True)
    sim = t0 @ t1.transpose(1, 2) * inv_temp
    lse_r, lse_c = torch.logsumexp(sim, 2), torch.logsumexp(sim, 1)
    (-(a_r * lse_r).sum() - (a_c * lse_c).sum()).backward()
    got_r, got_c = dual_softmax_lse(torch.tensor(f0), torch.tensor(f1), inv_temp)
    np.testing.assert_allclose(got_r.numpy(), lse_r.detach().numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), lse_c.detach().numpy(), rtol=1e-6, atol=1e-5)
    df0, df1 = sparse_focal_backward(torch.tensor(f0), torch.tensor(f1), a_r, got_r, a_c, got_c,
                                     inv_temp)
    np.testing.assert_allclose(df0.numpy(), t0.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(df1.numpy(), t1.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_clipped_pairs_get_no_gradient():
    logc = torch.tensor([np.log(1e-7), np.log(0.5), np.log(1 - 1e-8)], dtype=torch.float32)
    _, d = per_pair_loss_and_grad(logc, 0.25, 2.0)
    assert d[0] == 0 and d[2] == 0 and d[1] != 0
