"""The port's serving forward and its modules against the JAX package.

The slice: `featurematching_tpu.models.fast_inference.make_fast_matcher_fn`
(interpret mode, so its plain coarse-transformer and fine-stage branches)
against the port's `FastMatcher` on the CPU, on the same `Matcher.init`
weights carried across by `load_jax_params`, at 64x64, float32, with a
shallow Swin (depths 2/2/2) and a two-layer coarse transformer; at
`default_config()` and at `tpu_optimized_config()` (head dim 64 throughout,
with every fused gate holding, so JAX's Pallas kernels in interpret mode
against the port's twins).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.config import default_config as jax_default_config
from featurematching_tpu.config import tpu_optimized_config as jax_tpu_optimized_config
from featurematching_tpu.matching.coarse import (
    extract_matches_from_stats as jax_extract_matches_from_stats,
)
from featurematching_tpu.matching.fine import fine_soft_argmax as jax_fine_soft_argmax
from featurematching_tpu.matching.fine import gather_fine_windows as jax_gather_fine_windows
from featurematching_tpu.models import Matcher
from featurematching_tpu.models import backbone_swin as jax_swin
from featurematching_tpu.models.fast_inference import make_fast_matcher_fn, swin_backbone_fast
from featurematching_tpu.models.transformer import (
    LocalFeatureTransformer as JaxLocalFeatureTransformer,
)
from featurematching_tpu.ops.attention import linear_attention as jax_linear_attention
from featurematching_tpu.ops.attention import (
    linear_attention_packed as jax_linear_attention_packed,
)
from featurematching_tpu.ops.pallas_dual_softmax import MatchStats as JaxMatchStats
from featurematching_tpu_torch.config import ModelConfig, config_from_dict
from featurematching_tpu_torch.matching.coarse import extract_matches_from_stats
from featurematching_tpu_torch.matching.fine import fine_soft_argmax, gather_fine_windows
from featurematching_tpu_torch.models import backbone_swin
from featurematching_tpu_torch.models.fast_inference import FastMatcher
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops.attention import linear_attention
from featurematching_tpu_torch.ops.dual_softmax import MatchStats
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _match_set(i_ids, j_ids, mask, b):
    m = np.asarray(mask[b])
    return set(zip(np.asarray(i_ids[b])[m].tolist(), np.asarray(j_ids[b])[m].tolist()))


def _shallow(cfg):
    """The slice's shallow shape: Swin depths 2/2/2, two coarse layers, at
    float32 with a low threshold and 32 matches a pair."""
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        match_coarse=dataclasses.replace(cfg.match_coarse, thr=1e-6, max_matches=32),
        swin=dataclasses.replace(cfg.swin, depths=(2, 2, 2), fused_attention="off"),
        coarse=dataclasses.replace(cfg.coarse, layer_names=("self", "cross")),
    )


def _setup(mcfg):
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = jax.jit(Matcher(mcfg).init)(jax.random.PRNGKey(0), img, img)
    port = FastMatcher(config_from_dict(ModelConfig, dataclasses.asdict(mcfg)), device="cpu")
    load_jax_params(port, variables["params"])
    return mcfg, variables, make_fast_matcher_fn(mcfg, interpret=True), port


@pytest.fixture(scope="module")
def slice_setup():
    return _setup(_shallow(jax_default_config().model))


@pytest.fixture(scope="module")
def tpu_slice():
    return _setup(_shallow(jax_tpu_optimized_config().model))


def _pair(seed, B):
    a = np.random.default_rng(seed).random((B, 64, 64, 3)).astype(np.float32)
    return a, np.roll(a, 8, axis=2)


class TestSlice:
    @pytest.mark.parametrize("B,seed", [(1, 0), (3, 7)])
    def test_forward_matches_jax(self, slice_setup, B, seed):
        """Match sets equal per pair over the masked slots; feat_c0 within
        5e-3; mkpts0_f within 5e-2 where the masks agree (f32 both sides;
        the differences are sum orders and the TPU kernel's erf
        approximation)."""
        _, variables, jax_fwd, port = slice_setup
        a, b = _pair(seed, B)
        ref = jax_fwd(variables, jnp.asarray(a), jnp.asarray(b))
        got = port(_t(a), _t(b))
        np.testing.assert_allclose(_np(got.feat_c0), np.asarray(ref.feat_c0), atol=5e-3, rtol=5e-3)
        for i in range(B):
            ref_set = _match_set(ref.coarse.i_ids, ref.coarse.j_ids, ref.coarse.mask, i)
            got_set = _match_set(got.coarse.i_ids, got.coarse.j_ids, got.coarse.mask, i)
            assert got_set == ref_set, f"pair {i} match set diverged"
        rm, gm = np.asarray(ref.coarse.mask), got.coarse.mask.numpy()
        assert rm.any(), "no matches to compare"
        assert (rm == gm).all()
        np.testing.assert_allclose(_np(got.fine.mkpts0_f)[gm], np.asarray(ref.fine.mkpts0_f)[rm],
                                   atol=5e-2, rtol=1e-2)
        np.testing.assert_allclose(_np(got.fine.mkpts1_f)[gm], np.asarray(ref.fine.mkpts1_f)[rm],
                                   atol=5e-2, rtol=1e-2)

    def test_plain_branches_match_fused(self, slice_setup, monkeypatch):
        """Where the fused gates fail, the plain LocalFeatureTransformer,
        window mix and fine_soft_argmax run; in f32 they compute what the
        fused branches' plain versions do."""
        _, _, _, port = slice_setup
        a, b = _pair(4, 2)
        fused = port(_t(a), _t(b))
        monkeypatch.setattr(FastMatcher, "use_fused_coarse", lambda self, n: False)
        monkeypatch.setattr(FastMatcher, "use_fused_fine", lambda self: False)
        plain = port(_t(a), _t(b))
        np.testing.assert_allclose(_np(plain.feat_c0), _np(fused.feat_c0), atol=1e-4, rtol=1e-4)
        assert torch.equal(plain.coarse.mask, fused.coarse.mask)
        np.testing.assert_allclose(_np(plain.fine.mkpts0_f), _np(fused.fine.mkpts0_f),
                                   atol=1e-3, rtol=1e-4)

    def test_backbone_matches_jax(self, slice_setup):
        mcfg, variables, _, port = slice_setup
        a, _ = _pair(1, 2)
        ref_c, ref_f = swin_backbone_fast(variables["params"], jnp.asarray(a), mcfg, interpret=True)
        got_c, got_f = port.backbone(_t(a))
        np.testing.assert_allclose(_np(got_c), np.asarray(ref_c), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(_np(got_f), np.asarray(ref_f), atol=2e-3, rtol=2e-3)

    def test_identical_images_match_on_the_diagonal(self, slice_setup):
        _, _, _, port = slice_setup
        a, _ = _pair(2, 2)
        out = port(_t(a), _t(a))
        m = out.coarse.mask
        assert m.sum() > 0
        assert (out.coarse.i_ids == out.coarse.j_ids)[m].all()


class TestTpuOptimizedSlice:
    """tpu_optimized_config(): Swin heads (1, 2, 4), coarse 256/4, fine 64/1."""

    def test_weights_cross(self, tpu_slice):
        """load_jax_params takes the config's tree as it is: every port leaf
        equals its flax leaf, and the tree is the default's but for the
        relative-position bias tables, whose last axis is each stage's heads."""
        _, variables, _, port = tpu_slice
        flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
        got = {jax.tree_util.keystr(k): v for k, v in flat(to_jax_tree(port))}
        ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat(variables["params"])}
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        dcfg = _shallow(jax_default_config().model)
        img = jnp.zeros((1, 64, 64, 3), jnp.float32)
        default = jax.eval_shape(Matcher(dcfg).init, jax.random.PRNGKey(0), img, img)["params"]
        shapes = {jax.tree_util.keystr(k): v.shape for k, v in flat(default)}
        assert shapes.keys() == ref.keys()
        differ = {k for k in ref if ref[k].shape != shapes[k]}
        assert differ and all(k.endswith("['rel_pos_bias']") for k in differ), differ

    def test_forward_matches_jax(self, tpu_slice):
        """Every fused gate holding (on the CPU the kernels' twins), against
        the JAX forward: match sets equal per pair, feat_c0 within 5e-3,
        mkpts0_f within 5e-2 where the masks agree (TestSlice's limits)."""
        _, variables, jax_fwd, port = tpu_slice
        B, seed = 2, 7
        assert port.use_fused_coarse(16) and port.use_fused_fine()
        # at float32 (this comparison's dtype) the gate names the kernels
        # that take bfloat16 alone (K2 with K3 and K4, and K6) and K5, whose
        # float32 form takes head dim 32 alone (this config's is 64)
        lacking = port.widths_lacking()
        assert [m.split(" ")[0] for m in lacking] == ["K2", "K5", "K6"]
        assert all("take bfloat16" in m or "takes bfloat16" in m
                   or "((256, 32),) at float32" in m for m in lacking)
        a, b = _pair(seed, B)
        ref = jax_fwd(variables, jnp.asarray(a), jnp.asarray(b))
        got = port(_t(a), _t(b))
        np.testing.assert_allclose(_np(got.feat_c0), np.asarray(ref.feat_c0),
                                   atol=5e-3, rtol=5e-3)
        rm, gm = np.asarray(ref.coarse.mask), got.coarse.mask.numpy()
        assert rm.any(), "no matches to compare"
        for i in range(B):
            assert (_match_set(ref.coarse.i_ids, ref.coarse.j_ids, rm, i)
                    == _match_set(got.coarse.i_ids, got.coarse.j_ids, gm, i)), i
        np.testing.assert_allclose(_np(got.fine.mkpts0_f)[gm],
                                   np.asarray(ref.fine.mkpts0_f)[rm], atol=5e-2, rtol=1e-2)


class TestEntryPoint:
    def test_default_device_is_cuda_and_raises_without_it(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FastMatcher(ModelConfig())

    def test_config_from_jax_config(self):
        cfg = config_from_dict(ModelConfig, dataclasses.asdict(jax_default_config().model))
        assert cfg == ModelConfig()

    def test_gates_follow_the_kernels_limits(self):
        """tpu_optimized_config()'s coarse (C 256, head dim 64) and fine (C 64,
        head dim 64) widths pass the JAX gates, and K5's and K6's forward
        kernels take them: the fused branches run (on the CPU their plain
        versions), end to end. The training gates take them too (K9's and
        K10's backwards at head dim 64); coarse C 128 with head dim 64 only
        where there is no gradient to take, so the training Matcher's
        `widths_lacking` names it where K9 is selected. A width the JAX gate
        takes and no kernel does (coarse C 256 with 2 heads of 128; a fine
        stage of 3 layers or of 81 taps) is what `widths_lacking` names and
        construction on the card raises on."""
        from featurematching_tpu.config import tpu_optimized_config

        from featurematching_tpu_torch.models.matcher import Matcher as PortMatcher
        from featurematching_tpu_torch.ops.coarse_transformer_train import coarse_train_supported
        from featurematching_tpu_torch.ops.fine_stage import fine_train_supported

        cfg = config_from_dict(ModelConfig, dataclasses.asdict(tpu_optimized_config().model))
        port = FastMatcher(cfg, device="cpu")
        assert port.use_fused_coarse(64) and port.use_fused_fine()
        assert port.widths_lacking() == []
        c, f = cfg.coarse, cfg.fine
        assert coarse_train_supported(c.layer_names, c.d_model, c.nhead, 4800)
        assert fine_train_supported(f.layer_names, f.d_model, f.nhead, f.window_size**2)
        # with no gradient to take, the forward kernels' widths: K5's, K6's
        assert coarse_train_supported(c.layer_names, c.d_model, c.nhead, 4800, True)
        assert fine_train_supported(f.layer_names, f.d_model, f.nhead, f.window_size**2, True)
        assert not coarse_train_supported(c.layer_names, 128, 2, 4800)
        assert coarse_train_supported(c.layer_names, 128, 2, 4800, True)
        # so the training Matcher with K9 selected names that width: on the
        # card its construction refuses it
        narrow = dataclasses.replace(cfg, coarse=dataclasses.replace(
            c, d_model=128, nhead=2, fused_train="on"))
        lacking = PortMatcher(narrow, device="cpu").widths_lacking()
        assert len(lacking) == 1 and lacking[0].startswith("K9") and "C 128" in lacking[0]
        assert PortMatcher(cfg, device="cpu").widths_lacking() == []
        default = FastMatcher(ModelConfig(), device="cpu")
        assert default.use_fused_coarse(4800) and default.use_fused_fine()
        assert default.widths_lacking() == []
        wide = dataclasses.replace(cfg, coarse=dataclasses.replace(c, nhead=2))
        lacking = FastMatcher(wide, device="cpu").widths_lacking()
        assert len(lacking) == 1 and lacking[0].startswith("K5") and "2 heads" in lacking[0]
        # K6 takes at most 2 layers and 64 taps; the JAX gate takes more, so the
        # fused branch is chosen and the card refuses it
        for fine, what in ((dict(layer_names=("self", "cross", "self")), "3 layers"),
                           (dict(window_size=9), "81 taps")):
            deep = dataclasses.replace(cfg, fine=dataclasses.replace(f, **fine))
            model = FastMatcher(deep, device="cpu")
            lacking = model.widths_lacking()
            assert model.use_fused_fine()
            assert len(lacking) == 1 and lacking[0].startswith("K6") and what in lacking[0]
        a, b = _pair(5, 1)
        out = port(_t(a), _t(b))
        assert out.feat_c0.shape == (1, 64, 256) and torch.isfinite(out.feat_c0).all()
        assert torch.isfinite(out.fine.mkpts0_f).all()

    def test_patch_expand_per_op_form(self, slice_setup, monkeypatch):
        """Where patch_expand_ln's kernel limits fail, depth-to-space, the LN
        chain and the dense head run: in f32 the backbone's outputs equal the
        fused branch's plain version to rounding."""
        import featurematching_tpu_torch.models.fast_inference as fi

        _, _, _, port = slice_setup
        a, _ = _pair(6, 1)
        ref = port.backbone(_t(a))
        monkeypatch.setattr(fi, "patch_expand_supported", lambda c4, head: False)
        got = port.backbone(_t(a))
        for g, r in zip(got, ref, strict=True):
            np.testing.assert_allclose(_np(g), _np(r), atol=1e-4, rtol=1e-4)

    def test_load_jax_params_fails_loudly(self, slice_setup):
        mcfg, variables, _, _ = slice_setup
        port = FastMatcher(config_from_dict(ModelConfig, dataclasses.asdict(mcfg)), device="cpu")
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        extra = dict(params, unused_layer={"kernel": np.zeros((2, 2), np.float32)})
        with pytest.raises(KeyError, match="unused_layer"):
            load_jax_params(port, extra)
        missing = {k: v for k, v in params.items() if k != "fine_merge"}
        with pytest.raises(KeyError, match="fine_merge"):
            load_jax_params(port, missing)


class TestSwinHelpers:
    def test_window_partition_and_reverse(self, rng):
        x = rng.standard_normal((2, 16, 24, 5)).astype(np.float32)
        ref = jax_swin.window_partition(jnp.asarray(x), 8)
        got = backbone_swin.window_partition(_t(x), 8)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
        back = backbone_swin.window_reverse(got, 8, 16, 24)
        np.testing.assert_array_equal(_np(back), x)

    @pytest.mark.parametrize("Hp,Wp", [(16, 16), (64, 80), (32, 40)])
    def test_shift_mask(self, Hp, Wp):
        np.testing.assert_array_equal(
            backbone_swin._shift_attn_mask(Hp, Wp, 8, 4), jax_swin._shift_attn_mask(Hp, Wp, 8, 4)
        )

    def test_rel_pos_bias(self, rng):
        table = rng.standard_normal((225, 4)).astype(np.float32)
        ref = jax_swin._rel_pos_bias_from_table(jnp.asarray(table), 8, 4)
        got = backbone_swin._rel_pos_bias_from_table(_t(table), 8, 4)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


class TestTransformer:
    @pytest.mark.parametrize("L,S", [(96, 80), (49, 49)])
    def test_linear_attention(self, rng, L, S):
        q = rng.standard_normal((2, L, 8, 8)).astype(np.float32)
        k, v = rng.standard_normal((2, 2, S, 8, 8)).astype(np.float32)
        got = _np(linear_attention(_t(q), _t(k), _t(v)))
        for fn in (jax_linear_attention, jax_linear_attention_packed):
            ref = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("d,h,L", [(256, 8, 60), (64, 8, 49)])
    def test_local_feature_transformer(self, rng, d, h, L):
        """Coarse (d=256) and fine (d=64) shapes; cross layers feed the
        updated feat0 to feat1."""
        names = ("self", "cross")
        f0 = rng.standard_normal((2, L, d)).astype(np.float32)
        f1 = rng.standard_normal((2, L, d)).astype(np.float32)
        jm = JaxLocalFeatureTransformer(d, h, names)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(f0), jnp.asarray(f1))["params"]
        r0, r1 = jm.apply({"params": params}, jnp.asarray(f0), jnp.asarray(f1))
        port = LocalFeatureTransformer(d, h, names)
        load_jax_params(port, params)
        g0, g1 = port(_t(f0), _t(f1))
        np.testing.assert_allclose(_np(g0), np.asarray(r0), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(g1), np.asarray(r1), atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("d,h,L,route", [(256, 4, 60, "coarse_transformer_train"),
                                             (64, 1, 49, "fine_transformer_train")])
    def test_fused_switch_at_head_dim_64(self, rng, monkeypatch, d, h, L, route):
        """tpu_optimized_config()'s coarse (256/4) and fine (64/1) stacks with
        `use_fused_train`: without a gradient to take, the forward kernels'
        widths hold and the stack runs through K9's or K10's forward (K5's or
        K6's kernel; the twin here), equal to the per-op stack within 1e-4;
        with one, the backward's widths hold too (K9's and K10's backwards
        take head dim 64), and the stack runs through K9 or K10 again."""
        import featurematching_tpu_torch.models.transformer as tr

        port = LocalFeatureTransformer(d, h, ("self", "cross"))
        f0, f1 = (_t(rng.standard_normal((2, L, d)).astype(np.float32)) for _ in range(2))
        with torch.no_grad():
            ref = port(f0, f1)
        port.use_fused_train = True
        calls = []
        real = getattr(tr, route)
        monkeypatch.setattr(tr, route, lambda *a: calls.append(1) or real(*a))
        with torch.no_grad():
            got = port(f0, f1)
        assert calls == [1]
        for g_, r in zip(got, ref, strict=True):
            np.testing.assert_allclose(_np(g_), _np(r), atol=1e-4, rtol=1e-4)
        port(f0, f1)[0].sum().backward()
        assert calls == [1, 1] and port.layer_0.q_proj.weight.grad is not None


class TestMatching:
    def test_extract_matches_padding_order(self, rng):
        """Most scores are 0 (ties): the stable sort orders them as
        jax.lax.top_k does, so every slot, padding included, agrees."""
        B, h, w = 2, 8, 10
        L = h * w
        row_arg = rng.integers(0, L, (B, L)).astype(np.int32)
        col_arg = rng.integers(0, L, (B, L)).astype(np.int32)
        for b in range(B):  # make a dozen rows mutual
            for i in rng.choice(L, 12, replace=False):
                col_arg[b, row_arg[b, i]] = i
        row_max = rng.random((B, L)).astype(np.float32)
        col_max = rng.random((B, L)).astype(np.float32)
        arrs = (row_max, row_arg, col_max, col_arg)
        ref = jax_extract_matches_from_stats(JaxMatchStats(*map(jnp.asarray, arrs)),
                                             (h, w), (h, w), 0.3, 1, 48)
        got = extract_matches_from_stats(MatchStats(*map(_t, arrs)), (h, w), (h, w), 0.3, 1, 48)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    def test_gather_fine_windows_at_borders(self, rng):
        B, hc, wc, C = 2, 6, 8, 4
        feat = rng.standard_normal((B, hc * 4, wc * 4, C)).astype(np.float32)
        ids = np.array([[0, 7, 40, 47, 21], [5, 42, 0, 13, 30]], np.int32)
        ref = jax_gather_fine_windows(jnp.asarray(feat), jnp.asarray(ids), (hc, wc), 7, 4)
        got = gather_fine_windows(_t(feat), _t(ids).long(), (hc, wc), 7, 4)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))

    def test_fine_soft_argmax(self, rng):
        B, K, C = 2, 5, 16
        args = [rng.standard_normal(s).astype(np.float32) for s in
                [(B, K, C), (B, K, C), (B, K, 49, C), (B, K, 49, C), (B, K, 2), (B, K, 2)]]
        ref = jax_fine_soft_argmax(*map(jnp.asarray, args), 7, 2.0)
        got = fine_soft_argmax(*map(_t, args), 7, 2.0)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), np.asarray(r), atol=1e-5, rtol=1e-5)
