"""The port's sparse focal loss (K7's plain twin and its forward) against the
JAX package's `sparse_focal_loss` and `naive_sparse_focal_loss`.

At float32, with inputs made by numpy from a seed: the loss value and
df0 / df1 with masked rows and duplicate GT pairs, and the plain
row / column log-sum-exps and the backward's softmax terms against the
materialised loss. Also the kernel's work decomposition (`plan`, `pieces`):
every owned row of both passes in one unit, every tile of the other side
once a unit, one owner a unit, and a grid the card holds at once.
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
    TILE,
    UNIT_ROWS,
    block_range,
    naive_sparse_focal_loss,
    per_pair_loss_and_grad,
    pieces,
    plan,
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


# L and S at tile edges (64) and planned-unit edges (128 owned rows)
_EDGES = [1, 63, 64, 65, UNIT_ROWS + 1, 200, 4800]


def _check_plan(B, L, S, sms, per_sm):
    p = plan(B, L, S, sms, per_sm)
    assert 1 <= p.grid <= sms * per_sm and p.grid <= p.total
    runs = pieces(B, p)
    assert len(runs) == p.grid
    ends = [block_range(p, k) for k in range(p.grid)]
    assert ends[0][0] == 0 and ends[-1][1] == p.total
    assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))
    seen = {}  # (pass, image, row block) -> [tile0, tile1) of each piece
    owners = {}
    for k, run in enumerate(runs):
        assert sum(q.tile1 - q.tile0 for q in run) == ends[k][1] - ends[k][0]
        for i, q in enumerate(run):
            unit = (q.pass_, q.image, q.row_block)
            seen.setdefault(unit, []).append((q.tile0, q.tile1))
            if q.owner:
                assert q.tile0 == 0
                owners[unit] = owners.get(unit, 0) + 1
            else:  # a later piece is its block's first: one partial slot a block
                assert i == 0 and q.tile0 > 0
    for ps, (n_own, n_oth) in enumerate(((L, S), (S, L))):
        rows = -(-n_own // UNIT_ROWS)
        tiles = -(-n_oth // TILE)
        units = {(ps, b, rb) for b in range(B) for rb in range(rows)}
        assert units <= set(seen) and {u for u in seen if u[0] == ps} == units
        for b in range(B):  # every owned row of every image in exactly one unit
            rows_b = sorted(r for _, ub, rb in units if ub == b
                            for r in range(rb * UNIT_ROWS, min(n_own, (rb + 1) * UNIT_ROWS)))
            assert rows_b == list(range(n_own))
        for u in units:  # every tile of the other side once, one owner
            spans = sorted(seen[u])
            assert spans[0][0] == 0 and spans[-1][1] == tiles
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert owners.get(u) == 1


@pytest.mark.parametrize("L", _EDGES)
@pytest.mark.parametrize("C, per_sm", [(64, 2), (128, 1), (256, 1)])
@pytest.mark.parametrize("B", [1, 4])
def test_plan_covers_every_row_and_tile_once(B, C, per_sm, L):
    """Both passes' units cover every (image, row) once and every tile of
    the other side once a unit, on a grid within what 132 SMs hold (the
    blocks an SM as the card reports them at width C: two at 64, one at
    128 and 256)."""
    for S in _EDGES:
        _check_plan(B, L, S, 132, per_sm)
