"""The ResNet-FPN family against the JAX package, on the CPU.

With inputs made by numpy from a seed and float32 throughout (JAX at
`highest` matmul precision, tests/conftest.py):
- `ResNetFPN` against flax (small dims, small images, one whose 1/8 map is a
  single row, so the x2 upsampling meets a side of 1), with seeded random
  BatchNorm statistics on both sides (mean ~ N(0, 0.1), var in [0.5, 2]),
  so a statistic that fails to load shows; and the upsampling alone;
- the sine positional encoding against JAX's;
- the Matcher at `tiny_test_config()` on the golden regression's own inputs
  and init (`tests/test_golden_regression.py`) against flax `Matcher.apply`
  and against `tests/golden/matcher_tiny.npz`;
- the coarse-only Matcher at `loftr_tiny_config()` on a small grayscale pair
  against flax, with random BatchNorm statistics and the port's seeded
  weights carried across;
- the float32 plain twins of K1 and K5 (through K9's forward) at the
  teacher's widths against the Pallas kernels they replace, in interpret
  mode, and the layouts the float32 kernels read;
- the gates: which kernels the float32 kernels leave lacking.
Each JAX program runs once, in a module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.config import loftr_tiny_config as jax_loftr_tiny_config
from featurematching_tpu.config import tiny_test_config as jax_tiny_test_config
from featurematching_tpu.models.backbone_resnet_fpn import ResNetFPN as JaxResNetFPN
from featurematching_tpu.models.backbone_resnet_fpn import _upsample2x as jax_upsample2x
from featurematching_tpu.models.matcher import Matcher as JaxMatcher
from featurematching_tpu.models.matcher import (
    sine_positional_encoding as jax_sine_positional_encoding,
)
from featurematching_tpu_torch.config import (
    Config,
    ModelConfig,
    config_from_dict,
    loftr_tiny_config,
    tiny_test_config,
)
from featurematching_tpu_torch.models import backbone_resnet_fpn as rf
from featurematching_tpu_torch.models.matcher import Matcher, sine_positional_encoding
from featurematching_tpu_torch.ops import coarse_transformer as k5
from featurematching_tpu_torch.ops import dual_softmax as k1
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree

GOLDEN = "tests/golden/matcher_tiny.npz"
BACKBONE_RTOL = 1e-5  # of each output's largest magnitude
PE_ATOL = 1e-6
MCONF_ATOL = 1e-5
# the golden regression's tolerances (tests/test_golden_regression.py)
GOLD_MCONF = dict(rtol=1e-4, atol=1e-6)
GOLD_KPTS = dict(rtol=1e-4, atol=5e-3)
GOLD_FEAT_RTOL = 1e-3
MIN_VALID = 8  # valid slots the coarse-only pair must give


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max())


def _random_stats(tree, rng):
    """A flax batch_stats tree of the same shapes, seeded: mean ~ N(0, 0.1),
    var uniform in [0.5, 2]."""
    if "mean" in tree:
        n = np.asarray(tree["mean"]).shape
        return {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in tree.items()}


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (3, 1), (4, 5)])
def test_upsample2x_matches_jax(shape):
    """align_corners x2, a side of 1 included."""
    x = np.random.default_rng(0).standard_normal((2, *shape, 3)).astype(np.float32)
    ref = jax_upsample2x(jnp.asarray(x))
    got = rf.upsample2x(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,H,W", [(2, 32, 48), (1, 8, 24)])
def test_resnet_fpn_matches_flax(B, H, W):
    """Small dims (8, 12, 16), random BN statistics; at 8 x 24 the 1/8 map
    is one row."""
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(tiny_test_config().model, input_channels=2)
    x = rng.random((B, H, W, 2)).astype(np.float32)
    jm = JaxResNetFPN(initial_dim=8, block_dims=(8, 12, 16))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = _random_stats(jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), rng)
    ref = jax.jit(jm.apply)({"params": variables["params"], "batch_stats": stats},
                            jnp.asarray(x))
    port = rf.ResNetFPN(cfg)
    load_jax_params(port, jax.tree_util.tree_map(np.asarray, variables["params"]), stats)
    with torch.no_grad():
        got = port(_t(x))
        coarse_only = port(_t(x), fine=False)
    for g, r in zip(got, ref, strict=True):
        assert tuple(g.shape) == r.shape
        assert _rel(g.numpy(), r) <= BACKBONE_RTOL
    assert torch.equal(coarse_only[0], got[0]) and coarse_only[1] is None


def test_resnet_fpn_runs_cudnn_in_float32_with_timed_algorithms():
    """The forward turns cuDNN's TF32 off and its algorithm timing on for
    its convolutions, keeps the caller's other settings (deterministic
    here) and gives the caller's settings back."""
    port = rf.ResNetFPN(tiny_test_config().model)
    cudnn = torch.backends.cudnn
    seen = []
    real = rf.F.conv2d

    def spy(*a, **k):
        seen.append((cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic))
        return real(*a, **k)

    before = cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic
    try:
        cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = True, False, True
        rf.F.conv2d = spy
        with torch.no_grad():
            port(torch.rand(1, 16, 16, 1))
        assert seen and set(seen) == {(False, True, True)}
        assert (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic) == (True, False, True)
    finally:
        rf.F.conv2d = real
        cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = before


@pytest.mark.parametrize("h,w,C", [(6, 8, 16), (60, 80, 256)])
def test_sine_positional_encoding_matches_jax(h, w, C):
    got = sine_positional_encoding((h, w), C)
    ref = jax_sine_positional_encoding((h, w), C)
    assert got.shape == (h, w, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=PE_ATOL)


def test_batch_stats_load_and_write_back_loudly():
    """Statistics load into the running buffers and come back from
    `to_jax_tree(batch_stats=True)`; a missing or an unused statistic
    raises, as a parameter does."""
    port = rf.ResNetFPN(tiny_test_config().model)
    params = to_jax_tree(port)
    stats = _random_stats(to_jax_tree(port, batch_stats=True), np.random.default_rng(2))
    load_jax_params(port, params, stats)
    back = to_jax_tree(port, batch_stats=True)
    np.testing.assert_array_equal(back["layer2_0"]["bn_down"]["var"],
                                  stats["layer2_0"]["bn_down"]["var"])
    np.testing.assert_array_equal(port.bn1.running_mean.numpy(), stats["bn1"]["mean"])
    with pytest.raises(KeyError, match="layer1_bn"):
        load_jax_params(port, params, {k: v for k, v in stats.items() if k != "layer1_bn"})
    with pytest.raises(KeyError, match="bn9"):
        load_jax_params(port, params, dict(stats, bn9={"mean": np.zeros(8, np.float32)}))
    with pytest.raises(KeyError, match="running_mean"):
        load_jax_params(port, params)


def test_profiles_convert_from_jax():
    """Both new profiles convert field for field, and the two fields the
    port now holds keep their values."""
    for jax_cfg, ours in ((jax_loftr_tiny_config(), loftr_tiny_config()),
                          (jax_tiny_test_config(), tiny_test_config())):
        assert config_from_dict(Config, dataclasses.asdict(jax_cfg)) == ours
    d = dataclasses.asdict(jax_loftr_tiny_config().model)
    d["positional_encoding"] = False
    d["resnet_fpn"]["block_dims"] = [8, 12, 16]
    got = config_from_dict(ModelConfig, d)
    assert got.positional_encoding is False and got.resnet_fpn.block_dims == (8, 12, 16)


@pytest.fixture(scope="module")
def golden_run():
    """The golden regression's pair and init (PRNGKey(42)) through flax,
    jitted once; the port loads the same variables."""
    cfg = jax_tiny_test_config()
    model = JaxMatcher(cfg.model)
    rng = np.random.default_rng(1234)
    img0 = rng.random((1, 64, 96, 1)).astype(np.float32)
    img1 = np.roll(img0, 8, axis=2)
    variables = jax.jit(model.init)(jax.random.PRNGKey(42), jnp.asarray(img0), jnp.asarray(img1))
    ref = jax.jit(model.apply)(variables, jnp.asarray(img0), jnp.asarray(img1))
    port = Matcher(tiny_test_config().model, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, variables)
    load_jax_params(port, tree["params"], tree["batch_stats"])
    with torch.no_grad():
        got = port(_t(img0), _t(img1))
    return ref, got


def test_tiny_test_config_matches_flax(golden_run):
    """The whole Matcher (ResNet-FPN, the sine encoding, the per-op coarse
    and fine stacks, K1's twin) on the golden's pair: the same match list
    (ids and mask over every slot), mconf within MCONF_ATOL, the fine
    keypoints within the golden test's tolerances."""
    ref, got = golden_run
    for name in ("i_ids", "j_ids", "mask"):
        np.testing.assert_array_equal(getattr(got.coarse, name).numpy(),
                                      np.asarray(getattr(ref.coarse, name)))
    np.testing.assert_allclose(got.coarse.mconf.numpy(), np.asarray(ref.coarse.mconf),
                               rtol=0, atol=MCONF_ATOL)
    for name in ("mkpts0_f", "mkpts1_f"):
        np.testing.assert_allclose(getattr(got.fine, name).numpy(),
                                   np.asarray(getattr(ref.fine, name)), **GOLD_KPTS)
    assert _rel(got.feat_c0.numpy(), ref.feat_c0) <= 1e-4


def test_tiny_test_config_matches_the_golden_file(golden_run):
    """The port against `tests/golden/matcher_tiny.npz` at the golden
    regression's own tolerances."""
    _, got = golden_run
    want = dict(np.load(GOLDEN))
    for name in ("i_ids", "j_ids", "mask"):
        np.testing.assert_array_equal(getattr(got.coarse, name).numpy(), want[name])
    np.testing.assert_allclose(got.coarse.mconf.numpy(), want["mconf"], **GOLD_MCONF)
    for name in ("mkpts0_f", "mkpts1_f"):
        np.testing.assert_allclose(getattr(got.fine, name).numpy(), want[name], **GOLD_KPTS)
    np.testing.assert_allclose(got.feat_c0.sum(dim=(1, 2)).numpy(), want["feat_c0_sum"],
                               rtol=GOLD_FEAT_RTOL)


def test_coarse_only_loftr_tiny_matches_flax():
    """The teacher's profile (coarse-only, ResNet-FPN 128 / (128, 196,
    256), the sine encoding, 8 layers at (256, 8)) on a 64 x 80 grayscale
    pair (batch 2, the second pair shifted) with thr 1e-4: the port's
    seeded weights and random BN statistics carried to flax; the match
    lists equal over the valid slots, at least MIN_VALID of them."""
    rng = np.random.default_rng(3)
    thr = 1e-4
    jcfg = jax_loftr_tiny_config().model
    jcfg = dataclasses.replace(jcfg, match_coarse=dataclasses.replace(jcfg.match_coarse, thr=thr))
    cfg = config_from_dict(ModelConfig, dataclasses.asdict(jcfg))
    port = Matcher(cfg, device="cpu", seed=7)
    stats = _random_stats(to_jax_tree(port, batch_stats=True), rng)
    load_jax_params(port, to_jax_tree(port), stats)
    img0 = rng.random((2, 64, 80, 1)).astype(np.float32)
    img1 = np.concatenate([img0[:1], np.roll(img0[1:], 8, axis=2)])
    ref = jax.jit(JaxMatcher(jcfg).apply)({"params": to_jax_tree(port), "batch_stats": stats},
                                          jnp.asarray(img0), jnp.asarray(img1))
    with torch.no_grad():
        got = port(_t(img0), _t(img1))
    assert _rel(got.feat_c0.numpy(), ref.feat_c0) <= 1e-4
    mask = np.asarray(ref.coarse.mask)
    np.testing.assert_array_equal(got.coarse.mask.numpy(), mask)
    assert mask.sum() >= MIN_VALID
    for name in ("i_ids", "j_ids"):
        np.testing.assert_array_equal(getattr(got.coarse, name).numpy()[mask],
                                      np.asarray(getattr(ref.coarse, name))[mask])
    np.testing.assert_allclose(got.coarse.mconf.numpy(), np.asarray(ref.coarse.mconf),
                               rtol=0, atol=MCONF_ATOL)
    np.testing.assert_array_equal(got.fine.mkpts0_f[..., :2].numpy(),
                                  got.coarse.mkpts0_c.numpy())


@pytest.mark.parametrize("B,L,S", [(1, 96, 80), (2, 64, 64)])
def test_k1_float32_twin_at_the_teacher_width(B, L, S):
    """K1's plain twin in float32 at C = 256 against the Pallas kernel in
    interpret mode, with planted exact ties (a repeated f1 row, a repeated
    f0 row): the maxima within 2e-4 relative, the argmaxes equal (the first
    index on ties)."""
    from featurematching_tpu.ops.pallas_dual_softmax import dual_softmax_match_stats as jax_k1

    rng = np.random.default_rng(4)
    C = 256
    f0 = rng.standard_normal((B, L, C)).astype(np.float32)
    f1 = (0.8 * f0[:, rng.permutation(L)[:S]] + 0.6 * rng.standard_normal((B, S, C))).astype(
        np.float32)
    f1[:, 5] = f1[:, 3]
    f0[:, 9] = f0[:, 2]
    ref = jax_k1(jnp.asarray(f0), jnp.asarray(f1), 0.1, impl="pallas", row_tile=L // 2,
                 interpret=True)
    got = k1.dual_softmax_match_stats(_t(f0), _t(f1), 0.1)
    for g, r in ((got.row_max, ref.row_max), (got.col_max, ref.col_max)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=1e-7)
    for g, r in ((got.row_argmax, ref.row_argmax), (got.col_argmax, ref.col_argmax)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_k5_float32_twin_through_k9_forward_at_the_teacher_width():
    """K9's forward twin (K5's stats and apply per encoder call) in float32
    at (256, 32) over a self and a cross layer against the JAX K9 forward
    (`pallas_coarse_grad.coarse_transformer_train`, interpret mode) and flax,
    on the same weights; each call's kv and ks as the twin returns them
    (kv in `pack_heads` order, the order K9's backward twin reads)."""
    from featurematching_tpu.models.transformer import LocalFeatureTransformer as JaxLFT
    from featurematching_tpu.ops.pallas_coarse_grad import coarse_transformer_train as jax_k9
    from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
    from featurematching_tpu_torch.ops.coarse_transformer_train import _forward, pack_layer

    rng = np.random.default_rng(5)
    B, N, C, h, names = 1, 96, 256, 8, ("self", "cross")
    f0 = rng.standard_normal((B, N, C)).astype(np.float32)
    f1 = rng.standard_normal((B, N, C)).astype(np.float32)
    jm = JaxLFT(C, h, names)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(f0), jnp.asarray(f1))["params"]
    fused = jax_k9(jnp.asarray(f0), jnp.asarray(f1), params, names, h, chunk=32,
                   interpret=True)
    flax = jm.apply({"params": params}, jnp.asarray(f0), jnp.asarray(f1))
    port = LocalFeatureTransformer(C, h, names, use_fused_train=True)
    load_jax_params(port, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = port(_t(f0), _t(f1))
        layers = [pack_layer(port.layer_0, torch.float32), pack_layer(port.layer_1, torch.float32)]
        _, calls = _forward(_t(f0), _t(f1), layers, names, h)
    for i in range(2):
        for ref in (fused, flax):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=2e-4, atol=2e-4)
    x, _, kv, ks = calls[0]
    ref_kv, ref_ks = k5.stats_reference(x, layers[0], h)
    assert kv.dtype == ks.dtype == torch.float32
    np.testing.assert_array_equal(kv.numpy(), k5.pack_heads(ref_kv).numpy())
    np.testing.assert_array_equal(ks.numpy(), ref_ks.numpy())


@pytest.mark.parametrize("G,S", [(8, 4800), (4, 4800), (2, 33), (1, 1)])
def test_float32_plans_cover_every_tile(G, S):
    """K5's float32 stats runs and K1's float32 splits cover every tile once."""
    per, chunks = k5.f32_stats_plan(G, S, 132)
    tiles = -(-S // k5.F32_TILE)
    assert per * (chunks - 1) < tiles <= per * chunks
    n_split, chunk = k1.f32_plan(G, S, S, 132)
    n_ct = -(-S // k1.F32_TILE)
    assert chunk * (n_split - 1) < n_ct <= chunk * n_split


@pytest.mark.parametrize("nhead", [4, 8, 16])
def test_float32_coarse_gate_takes_head_dim_32_only(nhead):
    """With the switches 'on' (as on the card), the teacher's profile at
    head dims 64, 32 and 16 (C = 256): K5's float32 kernels take head dim
    32 alone, so the gate names K9's forward at the other two."""
    teacher = loftr_tiny_config().model
    cfg = dataclasses.replace(teacher, coarse=dataclasses.replace(
        teacher.coarse, fused_train="on", nhead=nhead))
    lacking = Matcher(cfg, device="cpu").widths_lacking()
    if nhead == 8:
        assert lacking == []
    else:
        assert len(lacking) == 1 and lacking[0].startswith("K9's forward (K5's kernels)")
        assert "((256, 32),) at float32" in lacking[0], lacking


def test_gates_name_the_kernels_that_lack_float32():
    """With the switches 'on' (as on the card): the teacher's profile needs
    only K1 and K5 (K9's forward) at float32, so nothing lacks; FastMatcher
    at float32 names K2, K3, K4 and K6 (and refuses ResNet-FPN); a training
    Swin Matcher at float32 names K9's and K10's backwards, wgrad and K7;
    one whose switches select K8 or K11 names them too."""
    from featurematching_tpu_torch.models.fast_inference import FastMatcher

    on = dict(fused_train="on")
    teacher = loftr_tiny_config().model
    teacher = dataclasses.replace(teacher, coarse=dataclasses.replace(teacher.coarse, **on))
    assert Matcher(teacher, device="cpu").widths_lacking() == []
    tiny = tiny_test_config().model
    assert Matcher(dataclasses.replace(
        tiny, coarse=dataclasses.replace(tiny.coarse, **on),
        fine=dataclasses.replace(tiny.fine, **on)), device="cpu").widths_lacking() == []
    with pytest.raises(ValueError, match="Matcher"):
        FastMatcher(dataclasses.replace(teacher, coarse_only=False), device="cpu")
    # a shallow Swin (the gates read widths and switches, not depth)
    shallow = ModelConfig()
    shallow = dataclasses.replace(shallow, swin=dataclasses.replace(
        shallow.swin, depths=(1, 1, 1)))
    f32 = dataclasses.replace(shallow, compute_dtype="float32")
    lacking = " ".join(FastMatcher(f32, device="cpu").widths_lacking())
    assert all(k in lacking for k in ("K2", "K3", "K4", "K6")) and "K5" not in lacking
    swin = dataclasses.replace(
        f32, swin=dataclasses.replace(f32.swin, fused_block="off", fused_attention="off"),
        coarse=dataclasses.replace(f32.coarse, **on), fine=dataclasses.replace(f32.fine, **on))
    lacking = Matcher(swin, device="cpu").widths_lacking()
    for k in ("K9's backward", "K10", "wgrad", "K7"):
        assert any(m.startswith(k) for m in lacking), (k, lacking)
    assert not any(m.startswith(("K8", "K11")) for m in lacking)
    for switch, k in (("fused_block", "K8"), ("fused_attention", "K11")):
        sel = dataclasses.replace(swin, swin=dataclasses.replace(swin.swin, **{switch: "on"}))
        assert any(m.startswith(k) for m in Matcher(sel, device="cpu").widths_lacking())
    bf16 = dataclasses.replace(swin, compute_dtype="bfloat16")
    assert Matcher(bf16, device="cpu").widths_lacking() == []
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        Matcher(tiny, device="cpu")(torch.rand(1, 16, 16, 1), torch.rand(1, 16, 16, 1),
                                    train=True)
