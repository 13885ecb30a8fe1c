"""The port's window attention (K11) and per-op Swin block against the JAX package.

With inputs made by numpy from a seed:
  * K11's plain twin against `window_attention_pallas` in interpret mode, N
    = 16 and 64, head dims 16, 32 and 64, with and without a shift mask,
    over several images' windows, and 3 heads of head dim 16 over 2
    windows: float32 within 1e-5; bfloat16 within the bound
    `BF16_ATOL`/`BF16_RTOL` below;
  * K11's grid (`plan`): every (window, head) in exactly one block at
    every site of `default_config()` and `tpu_optimized_config()` and at
    odd head counts, for 132, 114 and 1 block slots;
  * the per-op `WindowAttention` and `SwinBlock` (linen, use_fused_block
    False) against flax at float32 within 1e-5, shift 0 and 2 on a map that
    needs padding;
  * a small SwinUNet with `fused_attention` on (K11's twin) against flax
    with `window_attention_pallas` patched to interpret mode;
  * the Matcher with `swin.fused_block='off'` against the JAX eval step (the
    match sets equal, feat_c0 within 2e-4) and one training step with
    drop-path 0 against `make_train_step` (losses and every gradient leaf
    within 3e-4 of the leaf's max); a flax tree of that Matcher loads with
    no leaf missing or unused;
  * drop-path: the per-op block takes the same per-image masks as the fused
    one from the same generator state.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import featurematching_tpu.ops.pallas_window_attention as jax_pw
from featurematching_tpu.config import default_config as jax_default_config
from featurematching_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from featurematching_tpu.models import backbone_swin as jax_swin
from featurematching_tpu.ops.pallas_window_attention import window_attention_pallas
from featurematching_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from featurematching_tpu.train.step import _forward_with_loss as jax_forward_with_loss
from featurematching_tpu.train.step import create_train_state as jax_create_train_state
from featurematching_tpu.train.step import make_eval_step, make_train_step
from featurematching_tpu_torch.config import (
    Config,
    SwinConfig,
    config_from_dict,
    default_config,
    tpu_optimized_config,
)
from featurematching_tpu_torch.models import backbone_swin
from featurematching_tpu_torch.models.backbone_swin import (
    SwinBlockParams,
    SwinUNet,
    WindowAttentionParams,
    window_attention_per_op,
)
from featurematching_tpu_torch.models.matcher import Matcher
from featurematching_tpu_torch.ops import window_attention as wa
from featurematching_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_reference,
    window_attention_supported,
)
from featurematching_tpu_torch.train.step import create_train_state, eval_step, forward_with_loss
from featurematching_tpu_torch.utils.kernel_bounds import swin_sites
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree

GRAD_RTOL = 3e-4  # ROADMAP's per-leaf gradient tolerance at f32
# The flax init key of the Matcher tests. At key 0 one input of the first
# coarse layer's ReLU is 3.0e-7, and the two frameworks' float32 sums put it
# on opposite sides of 0: that unit's column of mlp1's gradient differs by
# its whole contribution (6e-3 of the leaf's max) while every other entry
# agrees within 2e-4. That is the ReLU's step, not the per-op block; at key 1
# no coarse ReLU input lies within 5e-6 of 0.
KEY = 1
# bf16, twin against the Pallas kernel: both round p to bf16 and the output
# to bf16 after f32 sums taken in another order. Where a sum lands within
# float32 rounding of a bf16 boundary the two roundings differ by one bf16
# ulp: 2^-8 of the output (rtol), and for the probabilities at most 2^-8 of
# sum_j p_j |v_j| <= 2^-8 max |v| (|v| < 5 for these normal inputs: atol)
BF16_RTOL = 2**-7
BF16_ATOL = 2e-2


def _t(a):
    return torch.tensor(np.asarray(a))


def _qkv_inputs(rng, B_, N, C, h, nW):
    qkv = rng.standard_normal((B_, N, 3 * C)).astype(np.float32)
    bias = (rng.standard_normal((h, N, N)) * 0.1).astype(np.float32)
    mask = None
    if nW:  # regions as a shift mask makes them: isolated quarters on some windows
        mask = np.zeros((nW, N, N), np.float32)
        mask[1:, : N // 2, N // 2:] = -100.0
        mask[1:, N // 2:, : N // 2] = -100.0
    return qkv, bias, mask


def _np(x):
    return np.asarray(x, np.float32)


def _plan_sites():
    """(windows, C, heads) of every K11 site of both configurations at
    640x480, batch 4, and of odd head counts and small window counts."""
    out = set()
    for cfg in (default_config().model, tpu_optimized_config().model):
        out.update((st.windows, st.C, st.heads) for st in swin_sites(cfg, 8, 480, 640))
    out.update((w, d * h, h) for w in (1, 7, 133) for d, h in
               ((16, 3), (16, 5), (16, 7), (32, 3), (32, 5), (32, 7), (64, 3), (16, 16)))
    return sorted(out)


@pytest.mark.parametrize("slots", [132, 114, 1])
@pytest.mark.parametrize("windows,C,heads", _plan_sites())
def test_plan_covers_each_window_and_head_once(windows, C, heads, slots):
    """The kernel's grid (`plan`, `run_windows`, `group_heads` as the kernel
    cuts them): every (window, head) in exactly one block, no run empty, no
    more blocks than the card holds at once where it holds a block a group."""
    p = wa.plan(windows, C, slots)
    assert p.grid == p.groups * p.runs and p.groups == -(-C // wa.GROUP_COLS)
    assert p.grid <= max(slots, p.groups)
    seen = np.zeros((windows, heads), np.int64)
    for block in range(p.grid):
        group, run = divmod(block, p.runs)
        w0, w1 = wa.run_windows(run, p.runs, windows)
        assert w1 > w0
        seen[w0:w1, list(wa.group_heads(group, C, heads))] += 1
    assert (seen == 1).all()


class TestKernelTwin:
    @pytest.mark.parametrize("N", [16, 64])
    @pytest.mark.parametrize("d", [16, 32, 64])
    @pytest.mark.parametrize("nW", [0, 3])
    def test_twin_against_pallas_f32(self, N, d, nW):
        """3 images of 2 or 3 windows (B_ = 6 or 9), 2 heads; window b takes
        mask[b % nW]. d = 32 has a scale that is not a power of two."""
        rng = np.random.default_rng(N + d + nW)
        h = 2
        C = h * d
        B_ = 3 * (nW or 2)
        qkv, bias, mask = _qkv_inputs(rng, B_, N, C, h, nW)
        scale = d**-0.5
        ref = window_attention_pallas(jnp.asarray(qkv), jnp.asarray(bias),
                                      None if mask is None else jnp.asarray(mask), h, scale,
                                      chunk=B_, interpret=True)
        got = window_attention(_t(qkv), _t(bias), None if mask is None else _t(mask), h, scale)
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("d,nW", [(16, 4), (32, 0), (64, 4)])
    def test_twin_against_pallas_bf16(self, d, nW):
        rng = np.random.default_rng(d)
        N, h = 64, 64 // d
        C = h * d
        B_ = 8
        qkv, bias, mask = _qkv_inputs(rng, B_, N, C, h, nW)
        qkv = qkv.astype(jnp.bfloat16)
        scale = d**-0.5
        ref = window_attention_pallas(jnp.asarray(qkv), jnp.asarray(bias),
                                      None if mask is None else jnp.asarray(mask), h, scale,
                                      chunk=B_, interpret=True)
        got = window_attention(_t(qkv.astype(np.float32)).bfloat16(), _t(bias),
                               None if mask is None else _t(mask), h, scale)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)

    def test_twin_against_pallas_odd_heads(self):
        """3 heads of head dim 16 (C = 48, one head group short of its four
        heads on the card), 2 windows, the second masked."""
        rng = np.random.default_rng(48)
        h, d, B_ = 3, 16, 2
        qkv, bias, mask = _qkv_inputs(rng, B_, 64, h * d, h, 2)
        ref = window_attention_pallas(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask), h,
                                      d**-0.5, chunk=B_, interpret=True)
        got = window_attention(_t(qkv), _t(bias), _t(mask), h, d**-0.5)
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)

    def test_supported(self):
        assert window_attention_supported(64, 64, 4)
        assert window_attention_supported(64, 256, 4)  # head dim 64
        assert window_attention_supported(64, 64, 2)  # head dim 32
        assert not window_attention_supported(16, 64, 4)  # 4x4 windows
        assert not window_attention_supported(64, 64, 8)  # head dim 8
        assert not window_attention_supported(64, 512, 8)  # C > 256


def _flax_block_params(module, x, *args):
    return module.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)["params"]


class TestPerOpAgainstFlax:
    @pytest.mark.parametrize("d,masked", [(16, False), (32, True), (8, True)])
    def test_window_attention(self, d, masked):
        """The per-op math (q scaled in the dtype, then the product) at f32."""
        rng = np.random.default_rng(d)
        w, h = 4, 2
        N, C = w * w, 2 * d
        x = rng.standard_normal((6, N, C)).astype(np.float32)
        mask = _qkv_inputs(rng, 6, N, C, h, 3)[2] if masked else None
        mod = jax_swin.WindowAttention(C, w, h)
        params = _flax_block_params(mod, x, None if mask is None else jnp.asarray(mask))
        ref = mod.apply({"params": params}, jnp.asarray(x),
                        None if mask is None else jnp.asarray(mask))
        port = WindowAttentionParams(C, w, h)
        load_jax_params(port, params)
        got = window_attention_per_op(_t(x), None if mask is None else _t(mask), port, h, w,
                                      fused=False)
        np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shift", [0, 2])
    def test_swin_block(self, shift):
        """A 10x13 map padded to 12x16 with 4x4 windows, C = 32, 2 heads:
        LN1 before the padding, the roll and its mask, the MLP."""
        rng = np.random.default_rng(shift)
        B, H, W, C, h, w = 2, 10, 13, 32, 2, 4
        x = rng.standard_normal((B, H * W, C)).astype(np.float32)
        mod = jax_swin.SwinBlock(dim=C, num_heads=h, window=w, shift=shift)
        params = mod.init(jax.random.PRNGKey(shift), jnp.asarray(x), H, W)["params"]
        params = jax.tree.map(  # LN scales and biases away from 1 and 0
            lambda p: p + 0.1 * jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
        ref = mod.apply({"params": params}, jnp.asarray(x), H, W)
        cfg = SwinConfig(embed_dim=C, depths=(1,), depths_up=(1,), num_heads=(h,), window_size=w)
        net = SwinUNet(dataclasses.replace(Config().model, swin=cfg))
        blk = SwinBlockParams(C, h, w)
        load_jax_params(blk, params)
        got = net._block_per_op(_t(x), H, W, blk, shift, 0.0, False, None, False)
        np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=1e-5, atol=1e-5)


def _unet_kwargs():
    """8x8 windows and heads (1, 1, 1): head dims 16, 32 and 64, each in K11's
    limits; depth 2 in the first stage for a shifted block."""
    return dict(in_channels=3, embed_dim=16, depths=(2, 1, 1), depths_up=(1, 1, 1),
                num_heads=(1, 1, 1), window=8, drop_path_rate=0.0)


def test_swin_unet_with_fused_attention_on(monkeypatch):
    """The port's SwinUNet with every attention through K11's twin against
    flax with `window_attention_pallas` in interpret mode, 2 images 64x64."""
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    monkeypatch.setattr(jax_pw, "window_attention_pallas",
                        functools.partial(window_attention_pallas, interpret=True))
    mod = jax_swin.SwinUNet(**_unet_kwargs(), fused_attention=True)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref_c, ref_f = mod.apply(variables, jnp.asarray(x))
    k = _unet_kwargs()
    cfg = SwinConfig(embed_dim=k["embed_dim"], depths=k["depths"], depths_up=k["depths_up"],
                     num_heads=k["num_heads"], window_size=k["window"], drop_path_rate=0.0)
    net = SwinUNet(dataclasses.replace(Config().model, swin=cfg))
    load_jax_params(net, variables["params"])
    calls = []
    twin = wa.window_attention_reference
    monkeypatch.setattr(wa, "window_attention_reference", lambda *a: calls.append(1) or twin(*a))
    with torch.no_grad():
        got_c, got_f = net(_t(x), fused_block=False, fused_attention=True)
    assert len(calls) == 7  # every block: 4 encoder, 3 decoder
    np.testing.assert_allclose(got_c.numpy(), _np(ref_c), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_f.numpy(), _np(ref_f), rtol=1e-5, atol=1e-5)
    calls.clear()
    with torch.no_grad():  # in training the per-op attention, as flax's use_fused and deterministic
        net(_t(x), train=True, fused_block=False, fused_attention=True)
    assert calls == []


def _per_op_jax_config():
    """A small Swin configuration with the per-op block (4x4 windows, so no
    K11 on either side), both transformers per-op, drop-path 0."""
    cfg = jax_default_config()
    m = cfg.model
    model = dataclasses.replace(
        m, compute_dtype="float32",
        swin=dataclasses.replace(m.swin, embed_dim=16, depths=(1, 1, 1), depths_up=(1, 1, 1),
                                 num_heads=(1, 2, 4), window_size=4, fused_block="off",
                                 drop_path_rate=0.0),
        coarse=dataclasses.replace(m.coarse, fused_train="off", layer_names=("self", "cross")),
        fine=dataclasses.replace(m.fine, fused_train="off"),
        match_coarse=dataclasses.replace(m.match_coarse, max_matches=32, max_gt_matches=32,
                                         thr=1e-6, border_rm=0),
    )
    opt = dataclasses.replace(cfg.trainer.optimizer, warmup_steps=0)
    return dataclasses.replace(cfg, model=model,
                               trainer=dataclasses.replace(cfg.trainer, batch_size=2, optimizer=opt))


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def per_op_setup():
    jc = _per_op_jax_config()
    batch = jax_synthetic_batch(np.random.default_rng(0), batch_size=2, image_size=(64, 64),
                                num_gt=32)
    jb = jax.tree.map(jnp.asarray, batch)
    tx = jax_build_optimizer(jc.trainer.optimizer, 2, jc.trainer.steps_per_epoch)
    model, state = jax_create_train_state(jc, tx, jax.random.PRNGKey(KEY), jb)

    def loss_fn(params):
        losses, _, _ = jax_forward_with_loss(model, jc, params, state.batch_stats, jb, None, True)
        return losses.loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    _, metrics = jax.jit(make_train_step(model, jc))(state, jb, jax.random.PRNGKey(1))
    out, losses = jax.jit(make_eval_step(model, jc))(state, jb)
    return dict(cfg=jc, batch=batch, params=state.params, grads=grads, metrics=metrics,
                eval_out=out, eval_losses=losses)


def _port_state(setup):
    pc = config_from_dict(Config, dataclasses.asdict(setup["cfg"]))
    state = create_train_state(pc, device="cpu", seed=0, global_batch_size=2)
    load_jax_params(state.model, setup["params"])  # raises on a missing or unused leaf
    return state


class TestMatcherPerOp:
    def test_flax_tree_loads_with_nothing_missing_or_unused(self, per_op_setup):
        state = _port_state(per_op_setup)
        assert set(_leaves(to_jax_tree(state.model))) == set(_leaves(per_op_setup["params"]))
        assert state.model.swin_switches(train=False) == (False, False)

    def test_eval_step(self, per_op_setup, monkeypatch):
        state = _port_state(per_op_setup)
        blocks = []
        per_op = SwinUNet._block_per_op
        monkeypatch.setattr(SwinUNet, "_block_per_op",
                            lambda *a, **k: blocks.append(1) or per_op(*a, **k))
        out, losses = eval_step(state, per_op_setup["batch"])
        assert len(blocks) == 6
        ref, ref_losses = per_op_setup["eval_out"], per_op_setup["eval_losses"]
        np.testing.assert_allclose(out.feat_c0.numpy(), _np(ref.feat_c0), atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(out.coarse.mask.numpy(), np.asarray(ref.coarse.mask))
        m = out.coarse.mask.numpy()
        assert m.any()
        for name in ("i_ids", "j_ids"):
            np.testing.assert_array_equal(getattr(out.coarse, name).numpy()[m],
                                          np.asarray(getattr(ref.coarse, name))[m])
        np.testing.assert_allclose(out.fine.mkpts0_f.numpy()[m], _np(ref.fine.mkpts0_f)[m],
                                   atol=1e-3, rtol=1e-4)
        for k in ("loss", "loss_c", "loss_f"):
            np.testing.assert_allclose(float(getattr(losses, k)), float(getattr(ref_losses, k)),
                                       rtol=GRAD_RTOL, err_msg=k)

    def test_training_step_gradients(self, per_op_setup):
        state = _port_state(per_op_setup)
        losses, _ = forward_with_loss(state.model, state.cfg, per_op_setup["batch"], train=True)
        losses.loss.backward()
        for k in ("loss", "loss_c", "loss_f"):
            np.testing.assert_allclose(float(getattr(losses, k).detach()),
                                       float(per_op_setup["metrics"][k]), rtol=GRAD_RTOL,
                                       err_msg=k)
        got = _leaves(to_jax_tree(state.model, grads=True))
        ref = _leaves(per_op_setup["grads"])
        assert set(got) == set(ref)
        for k, r in ref.items():
            assert np.abs(got[k] - r).max() <= GRAD_RTOL * np.abs(r).max() + 1e-9, k


def test_per_op_block_draws_the_fused_blocks_masks(monkeypatch):
    """From the same generator state both forms draw the same per-image keep
    masks, block by block; the per-op block applies them per image: where
    both of an image's branches are dropped its tokens pass unchanged."""
    cfg = config_from_dict(Config, dataclasses.asdict(_per_op_jax_config())).model
    cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, drop_path_rate=0.5))
    model = Matcher(cfg, device="cpu", seed=3)
    draws = {True: [], False: []}
    real = backbone_swin.drop_path_draws
    form = []

    def spy(*a):
        d = real(*a)
        draws[form[0]].append(None if d is None else d.clone())
        return d

    monkeypatch.setattr(backbone_swin, "drop_path_draws", spy)
    seen = []
    per_op = SwinUNet._block_per_op

    def block_spy(self, x, *a):
        y = per_op(self, x, *a)
        seen.append((x, y))
        return y

    monkeypatch.setattr(SwinUNet, "_block_per_op", block_spy)
    imgs = torch.rand(6, 64, 64, 3)
    for fused in (True, False):
        form[:] = [fused]
        g = torch.Generator().manual_seed(11)
        with torch.no_grad():
            model.backbone(imgs, train=True, generator=g, fused_block=fused)
    assert len(draws[True]) == len(draws[False]) == 6
    dropped_both = 0
    for a, b, (x, y) in zip(draws[True], draws[False], seen):
        assert (a is None and b is None) or torch.equal(a, b)
        if b is not None:
            gone = ~b[0] & ~b[1]
            dropped_both += int(gone.sum())
            assert torch.equal(y[gone], x[gone])
            if (~gone).any():
                assert not torch.equal(y[~gone], x[~gone])
    assert dropped_both > 0
