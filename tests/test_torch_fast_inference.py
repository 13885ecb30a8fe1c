"""The port's serving forward and its modules against the JAX package.

The slice: `featurematching_tpu.models.fast_inference.make_fast_matcher_fn`
(interpret mode, so its plain coarse-transformer and fine-stage branches)
against the port's `FastMatcher` on the CPU, on the same `Matcher.init`
weights carried across by `load_jax_params`, at 64x64, float32, with a
shallow Swin (depths 2/2/2) and a two-layer coarse transformer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.config import default_config as jax_default_config
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
from featurematching_tpu_torch.utils.weights import load_jax_params


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _match_set(i_ids, j_ids, mask, b):
    m = np.asarray(mask[b])
    return set(zip(np.asarray(i_ids[b])[m].tolist(), np.asarray(j_ids[b])[m].tolist()))


@pytest.fixture(scope="module")
def slice_setup():
    cfg = jax_default_config().model
    mcfg = dataclasses.replace(
        cfg, compute_dtype="float32",
        match_coarse=dataclasses.replace(cfg.match_coarse, thr=1e-6, max_matches=32),
        swin=dataclasses.replace(cfg.swin, depths=(2, 2, 2), fused_attention="off"),
        coarse=dataclasses.replace(cfg.coarse, layer_names=("self", "cross")),
    )
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = jax.jit(Matcher(mcfg).init)(jax.random.PRNGKey(0), img, img)
    port = FastMatcher(config_from_dict(ModelConfig, dataclasses.asdict(mcfg)), device="cpu")
    load_jax_params(port, variables["params"])
    return mcfg, variables, make_fast_matcher_fn(mcfg, interpret=True), port


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
        head dim 64) shapes pass the JAX gates but not K5's and K6's kernels:
        the plain branches run, and on the CPU the forward runs end to end."""
        from featurematching_tpu.config import tpu_optimized_config

        cfg = config_from_dict(ModelConfig, dataclasses.asdict(tpu_optimized_config().model))
        port = FastMatcher(cfg, device="cpu")
        assert not port.use_fused_coarse(64) and not port.use_fused_fine()
        default = FastMatcher(ModelConfig(), device="cpu")
        assert default.use_fused_coarse(4800) and default.use_fused_fine()
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
