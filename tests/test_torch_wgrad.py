"""The weight-gradient product dW = Aᵀ B (`ops/wgrad.py`, `csrc/wgrad.cuh`)
on the CPU: its plain twin against the JAX package's `_dot_g`, the
contraction the TPU backward kernels use for their weight gradients; the
kernel's cut of a launch (`plan`, `split_ranges`: every token once, in
order, a grid that fills the card once); and the bound's census of the
training step's 142 products in 28 launches (`kernel_bounds.wgrad_groups`,
`wgrad_work`, `wgrad_group_work`), held to the products the three
backwards' wrappers say their kernels make.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.ops.pallas_coarse_grad import _dot_g
from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.ops import coarse_transformer_train as ctt
from featurematching_tpu_torch.ops import fine_transformer_train as ftt
from featurematching_tpu_torch.ops import swin_block_train as sbt
from featurematching_tpu_torch.ops.wgrad import (
    STAGE,
    TILE_M,
    partial_floats,
    plan,
    split_ranges,
    tile_width,
    wgrad,
    wgrad_group,
    wgrad_reference,
)
from featurematching_tpu_torch.utils.kernel_bounds import (
    bound_ms,
    swin_sites,
    total,
    train_calls,
    wgrad_calls,
    wgrad_group_work,
    wgrad_groups,
    wgrad_work,
)

# the step's (M, N) shapes and their calls a step
STEP_SHAPES = {
    (256, 512): 36, (256, 256): 31, (512, 256): 12, (64, 64): 9, (64, 128): 9,
    (256, 768): 7, (256, 1024): 7, (1024, 256): 7, (64, 192): 3, (64, 256): 3,
    (256, 64): 3, (128, 384): 3, (128, 128): 3, (128, 512): 3, (512, 128): 3, (128, 64): 3,
}


def _bf16_pair(seed, T, M, N):
    """A [T, M] and B [T, N], bf16-valued, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.standard_normal((T, M)), dtype=torch.float32).bfloat16()
    b = torch.tensor(rng.standard_normal((T, N)), dtype=torch.float32).bfloat16()
    return a, b


@pytest.mark.parametrize("M, N", [(64, 64), (64, 192), (128, 64), (256, 512)])
@pytest.mark.parametrize("T", [1, 63, 65, 4097])
def test_twin_against_jax_dot_g(T, M, N):
    """ops/wgrad.wgrad on CPU tensors (the twin) against `_dot_g` on the same
    bf16 inputs, within 1e-5 of max |JAX|: both accumulate exact bf16
    products in f32, in another order."""
    a, b = _bf16_pair(T * 7 + M + N, T, M, N)
    got = wgrad(a, b)
    ref = np.asarray(_dot_g(jnp.asarray(a.float().numpy(), dtype=jnp.bfloat16),
                            jnp.asarray(b.float().numpy(), dtype=jnp.bfloat16)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert ref.dtype == np.float32
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_twin_is_the_f32_product():
    a, b = _bf16_pair(3, 130, 64, 128)
    c, d = _bf16_pair(4, 130, 256, 64)
    assert torch.equal(wgrad(a, b), wgrad_reference(a, b))
    assert torch.equal(wgrad_reference(a, b), a.float().t() @ b.float())
    got = wgrad_group([(a, b), (c, d)])
    assert torch.equal(got[0], wgrad_reference(a, b))
    assert torch.equal(got[1], c.float().t() @ d.float())


def _check_plan(calls, sms):
    """One launch's products: each product's splits' token ranges run from 0
    to T, contiguous, ascending and non-empty, whole stages but the last;
    every product the same number of splits where its stages allow; the
    launch's blocks (tiles x splits) within one block an SM wherever its
    tiles are, and at least half the card where the stages allow."""
    plans = plan(calls, sms)
    tiles = sum(p.m_tiles * p.n_tiles for p in plans)
    want = max(1, sms // tiles)
    for (T, M, N), p in zip(calls, plans):
        assert p.nt == tile_width(N) and N % p.nt == 0 and p.nt in (64, 128, 192, 256)
        assert p.m_tiles == -(-M // TILE_M) and p.n_tiles * p.nt == N
        ranges = split_ranges(T, p)
        assert len(ranges) == p.splits >= 1
        assert ranges[0][0] == 0 and ranges[-1][1] == T
        assert all(t0 < t1 for t0, t1 in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(t1 - t0 == p.per * STAGE for t0, t1 in ranges[:-1])
        assert p.stages == -(-T // STAGE) and (p.splits - 1) * p.per < p.stages <= p.splits * p.per
        assert p.splits <= min(want, p.stages)
        assert p.splits >= min(want, p.stages) // 2
    blocks = sum(p.m_tiles * p.n_tiles * p.splits for p in plans)
    if tiles <= sms:
        assert blocks <= sms
        assert blocks >= min(sms // 2, sum(p.m_tiles * p.n_tiles * p.stages for p in plans) // 2)
    else:
        assert all(p.splits == 1 for p in plans)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 4097, 9600, 401408])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_takes_every_token_once_in_order(sms, T):
    """Every (M, N) of the step alone, at ragged and large T."""
    for M, N in STEP_SHAPES:
        _check_plan([(T, M, N)], sms)


@pytest.mark.parametrize("sms", [132, 114])
def test_plan_of_the_steps_launches(sms):
    """The step's 28 launches, a backward's products each (K8's four, K9's
    and K10's six)."""
    for group in wgrad_groups(ModelConfig()):
        _check_plan([pr[:3] for pr in group], sms)


def test_plan_refuses_what_the_kernel_does_not_take():
    for T, M, N in [(0, 64, 64), (64, 96, 64), (64, 32, 64), (64, 64, 96), (64, 64, 32)]:
        with pytest.raises(ValueError):
            plan([(T, M, N)], 132)
    with pytest.raises(ValueError):
        plan([(64, 64, 64)] * 7, 132)
    with pytest.raises(ValueError):
        plan([], 132)


def test_partial_scratch_of_a_launch():
    """A launch's products write their partials side by side: splits x M x N
    of each product with more than one split, at least 1 float."""
    calls = [(153600, 64, 192), (153600, 64, 64), (153600, 64, 256), (153600, 256, 64)]
    plans = plan(calls, 132)
    want = sum(p.splits * M * N for (T, M, N), p in zip(calls, plans))
    assert all(p.splits > 1 for p in plans) and partial_floats(calls, 132) == want
    assert partial_floats([(64, 64, 64)], 132) == 1  # one stage: one split, no partials


def test_step_census_at_tpu_optimized_config():
    """tpu_optimized_config()'s training step (head dim 64 throughout) makes
    the default's weight-gradient products: their shapes depend on C and
    the token counts, not on the heads. So the same 142 products in 28
    launches, each launch planned as the default's."""
    from featurematching_tpu_torch.config import tpu_optimized_config

    tpu, default = tpu_optimized_config().model, ModelConfig()
    assert (tpu.coarse.nhead, tpu.fine.nhead, tpu.swin.num_heads) == (4, 1, (1, 2, 4))
    groups = wgrad_groups(tpu)
    assert groups == wgrad_groups(default) and len(groups) == 28
    assert len(wgrad_calls(tpu)) == 142


def test_step_census_is_the_backwards_calls():
    """The bound's census of one training step at default_config(), 640x480,
    batch 4: 142 products in 28 launches, K8's four a block, K9's and K10's
    six an encoder call, as the wrappers of their backwards list them."""
    cfg = ModelConfig()
    calls = wgrad_calls(cfg)
    assert len(calls) == 142 and len(wgrad_groups(cfg)) == 28
    assert Counter((M, N) for _, M, N in calls) == Counter(STEP_SHAPES)
    want = []
    for st in swin_sites(cfg, 8, 480, 640):
        want += sbt.wgrad_calls(st.windows * 64, st.C)
    for G, _ in train_calls(cfg.coarse.layer_names, 8):
        want += ctt.wgrad_calls(G * 4800, G * 4800, cfg.coarse.d_model)
    for G, _ in train_calls(cfg.fine.layer_names, 8 * cfg.match_coarse.max_gt_matches):
        want += ftt.wgrad_calls(G * 49, cfg.fine.d_model)
    assert calls == want
    assert sorted(Counter(T for T, _, _ in calls).items()) == [
        (10240, 28), (19200, 48), (38400, 24), (40960, 12), (153600, 12), (200704, 12),
        (401408, 6)]


def test_wgrad_work_and_the_steps_bound():
    """bytes T (M + N) 2 + M N 4, operations 2 T M N; the step's 142 products
    move 6.25 GB and do 674.8 GFLOP, every one bound by bytes, 1.866 ms in
    all at the H100's rates; a launch of a backward's products reads an
    operand two of them share once (K9's and K10's x, dy1, and src where it
    is x): 5.34 GB, 1.595 ms."""
    assert wgrad_work(100, 64, 192) == (100 * 256 * 2 + 64 * 192 * 4, 2 * 100 * 64 * 192)
    works = [wgrad_work(*c) for c in wgrad_calls(ModelConfig())]
    nbytes, flops = total(works)
    assert nbytes == pytest.approx(6.2519e9, rel=1e-4)
    assert flops == pytest.approx(674.8e9, rel=1e-3)
    bounds = [bound_ms(*w) for w in works]
    assert all(by == "bytes" for _, by in bounds)
    assert sum(b for b, _ in bounds) == pytest.approx(1.8662, abs=1e-4)
    grouped = [wgrad_group_work(g) for g in wgrad_groups(ModelConfig())]
    assert total(grouped)[1] == flops
    assert total(grouped)[0] == pytest.approx(5.3417e9, rel=1e-4)
    assert sum(bound_ms(*w)[0] for w in grouped) == pytest.approx(1.5945, abs=1e-4)
    T, C = 1000, 256  # a K9 cross call: x and dy1 read by two products each
    group = [(T, C, C, "x", "dqf"), (T, C, 2 * C, "x", "dy1"), (T, C, 2 * C, "msg", "dy1")]
    assert wgrad_group_work(group)[0] == (T * (C + C + 2 * C + C) * 2
                                          + (C * C + 2 * C * 2 * C) * 4)
