"""The port's four kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain version; the JAX side
runs its Pallas kernel in interpret mode (and, where it has one, its jnp
reference). Inputs come from a seeded numpy generator and go to both sides as
float32 unless a test says otherwise; JAX runs at `highest` matmul precision
(tests/conftest.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.models.backbone_swin import _shift_attn_mask as jax_shift_mask
from featurematching_tpu.ops.pallas_dual_softmax import (
    _stats_reference as jax_stats_reference,
)
from featurematching_tpu.ops.pallas_dual_softmax import (
    dual_softmax_match_stats as jax_dual_softmax,
)
from featurematching_tpu.ops.pallas_ln import layer_norm_chain as jax_layer_norm_chain
from featurematching_tpu.ops.pallas_patch_expand import patch_expand_ln as jax_patch_expand_ln
from featurematching_tpu.ops.pallas_swin_block import swin_block_fused as jax_swin_block_fused
from featurematching_tpu.ops.pallas_swin_block import (
    swin_block_reference as jax_swin_block_reference,
)
from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_match_stats
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain
from featurematching_tpu_torch.ops.patch_expand import patch_expand_ln
from featurematching_tpu_torch.ops.swin_block import swin_block_fused


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


class TestLayerNormChain:
    """K3: ops/pallas_ln.layer_norm_chain."""

    @pytest.mark.parametrize("two", [False, True])
    @pytest.mark.parametrize("shape", [(2, 300, 64), (7, 100, 32)])
    def test_f32(self, rng, shape, two):
        C = shape[-1]
        x = rng.standard_normal(shape).astype(np.float32)
        s1, s2 = (1 + 0.1 * rng.standard_normal((2, C))).astype(np.float32)
        b1, b2 = (0.1 * rng.standard_normal((2, C))).astype(np.float32)
        extra = (s2, b2) if two else ()
        ref = jax_layer_norm_chain(
            jnp.asarray(x), jnp.asarray(s1), jnp.asarray(b1),
            *map(jnp.asarray, extra), interpret=True,
        )
        got = layer_norm_chain(_t(x), _t(s1), _t(b1), *map(_t, extra))
        # f32 throughout: only the order of the row sums differs
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=2e-5)

    def test_bf16_rounds_once(self, rng):
        x = rng.standard_normal((2, 300, 64)).astype(np.float32)
        s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
        b = (0.1 * rng.standard_normal(64)).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        ref = jax_layer_norm_chain(xb, jnp.asarray(s), jnp.asarray(b), jnp.asarray(s),
                                   jnp.asarray(b), interpret=True)
        got = layer_norm_chain(_t(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                               _t(s), _t(b), _t(s), _t(b))
        assert got.dtype == torch.bfloat16
        # both compute in f32 and round once to bf16: at most one ulp apart
        np.testing.assert_allclose(_np(got), np.asarray(ref.astype(jnp.float32)),
                                   atol=1.6e-2, rtol=8e-3)


class TestSwinBlock:
    """K2: ops/pallas_swin_block.swin_block_fused, C = 64, 4 heads (and head
    dim 64)."""

    @staticmethod
    def _params(rng, C, h, hid):
        n = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
        return {
            "ln1_scale": 1 + n(C, sc=0.1), "ln1_bias": n(C, sc=0.1),
            "w_qkv": n(C, 3 * C, sc=C**-0.5), "b_qkv": n(3 * C, sc=0.02),
            "rel_bias": n(h, 64, 64, sc=0.02),
            "w_proj": n(C, C, sc=C**-0.5), "b_proj": n(C, sc=0.02),
            "ln2_scale": 1 + n(C, sc=0.1), "ln2_bias": n(C, sc=0.1),
            "w_mlp1": n(C, hid, sc=C**-0.5), "b_mlp1": n(hid, sc=0.02),
            "w_mlp2": n(hid, C, sc=hid**-0.5), "b_mlp2": n(C, sc=0.02),
        }

    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_pallas_and_reference(self, rng, masked):
        C, h = 64, 4
        x = rng.standard_normal((8, 64, C)).astype(np.float32)  # 2 images of 16x16
        p = self._params(rng, C, h, 4 * C)
        mask = jax_shift_mask(16, 16, 8, 4) if masked else None
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        jm = jnp.asarray(mask) if masked else None
        fused = jax_swin_block_fused(jnp.asarray(x), jm, jp, h, interpret=True)
        ref = jax_swin_block_reference(jnp.asarray(x), jm, jp, h)
        got = swin_block_fused(_t(x), _t(mask) if masked else None,
                               {k: _t(v) for k, v in p.items()}, h)
        # f32: the TPU kernel's erf approximation (|err| <= 1.5e-7) and sum order
        np.testing.assert_allclose(_np(got), np.asarray(fused), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("C,h", [(64, 1), (128, 2)])
    def test_head_dim_64_matches_pallas(self, rng, C, h, masked):
        """tpu_optimized_config()'s head dim 64 on the 4 windows of a 16x16
        map, within the same 1e-4."""
        x = rng.standard_normal((4, 64, C)).astype(np.float32)
        p = self._params(rng, C, h, 4 * C)
        mask = jax_shift_mask(16, 16, 8, 4) if masked else None
        ref = jax_swin_block_fused(jnp.asarray(x), jnp.asarray(mask) if masked else None,
                                   {k: jnp.asarray(v) for k, v in p.items()}, h, interpret=True)
        got = swin_block_fused(_t(x), _t(mask) if masked else None,
                               {k: _t(v) for k, v in p.items()}, h)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=1e-4)

    def test_mask_is_looked_up_per_window(self, rng):
        """Window w of a 2-image batch uses mask[w % nW]: swapping the images'
        windows swaps the outputs."""
        C, h = 64, 4
        x = rng.standard_normal((8, 64, C)).astype(np.float32)
        p = {k: _t(v) for k, v in self._params(rng, C, h, 4 * C).items()}
        mask = _t(jax_shift_mask(16, 16, 8, 4))
        a = swin_block_fused(_t(x), mask, p, h)
        b = swin_block_fused(_t(np.concatenate([x[4:], x[:4]])), mask, p, h)
        np.testing.assert_allclose(_np(b), np.concatenate([_np(a)[4:], _np(a)[:4]]), atol=1e-6)


class TestPatchExpand:
    """K4: ops/pallas_patch_expand.patch_expand_ln."""

    @pytest.mark.parametrize(
        "B,H,W,Ce,head,emit_ln",
        [
            (2, 6, 10, 128, False, True),
            (2, 6, 10, 128, True, True),
            (1, 4, 8, 64, True, False),
            (3, 5, 7, 32, False, True),
        ],
    )
    def test_matches_pallas(self, rng, B, H, W, Ce, head, emit_ln):
        C4 = Ce // 4
        y = rng.standard_normal((B, H * W, Ce)).astype(np.float32)
        s1, s2 = (1 + 0.1 * rng.standard_normal((2, C4))).astype(np.float32)
        b1, b2 = (0.1 * rng.standard_normal((2, C4))).astype(np.float32)
        wh = (0.1 * rng.standard_normal((C4, 16))).astype(np.float32)
        bh = rng.standard_normal(16).astype(np.float32)
        ref = jax_patch_expand_ln(
            jnp.asarray(y), H, W, *map(jnp.asarray, (s1, b1, s2, b2)),
            jnp.asarray(wh) if head else None, jnp.asarray(bh) if head else None,
            emit_ln=emit_ln, interpret=True,
        )
        got = patch_expand_ln(
            _t(y), H, W, *map(_t, (s1, b1, s2, b2)),
            w_head=_t(wh) if head else None, b_head=_t(bh) if head else None,
            emit_ln=emit_ln,
        )
        assert len(got) == len(ref) == int(emit_ln) + int(head)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), np.asarray(r), atol=1e-4, rtol=1e-4)


class TestDualSoftmax:
    """K1: ops/pallas_dual_softmax.dual_softmax_match_stats, several row tiles."""

    @staticmethod
    def _compare(got, ref):
        np.testing.assert_allclose(_np(got.row_max), np.asarray(ref.row_max), rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(_np(got.col_max), np.asarray(ref.col_max), rtol=2e-4, atol=1e-7)
        np.testing.assert_array_equal(got.row_argmax.numpy(), np.asarray(ref.row_argmax))
        np.testing.assert_array_equal(got.col_argmax.numpy(), np.asarray(ref.col_argmax))

    @pytest.mark.parametrize("B,L,S,C", [(1, 256, 256, 64), (2, 384, 256, 128)])
    def test_matches_pallas(self, rng, B, L, S, C):
        f0 = rng.standard_normal((B, L, C)).astype(np.float32)
        f1 = rng.standard_normal((B, S, C)).astype(np.float32)
        ref = jax_dual_softmax(jnp.asarray(f0), jnp.asarray(f1), 0.1, impl="pallas",
                               row_tile=128, interpret=True)
        self._compare(dual_softmax_match_stats(_t(f0), _t(f1), 0.1), ref)

    def test_col_argmax_crosses_tiles(self, rng):
        """The best row of some columns lies past the first row tile."""
        B, L, S, C = 1, 256, 128, 32
        f0 = rng.standard_normal((B, L, C)).astype(np.float32) * 0.1
        f1 = rng.standard_normal((B, S, C)).astype(np.float32)
        for j in range(0, S, 7):
            f0[0, 130 + (j % 100)] = f1[0, j] * 2
        ref = jax_dual_softmax(jnp.asarray(f0), jnp.asarray(f1), 0.1, impl="pallas",
                               row_tile=128, interpret=True)
        got = dual_softmax_match_stats(_t(f0), _t(f1), 0.1)
        self._compare(got, ref)
        assert (got.col_argmax.numpy() >= 128).any()

    def test_matches_jnp_reference(self, rng):
        f0 = rng.standard_normal((2, 64, 32)).astype(np.float32)
        f1 = rng.standard_normal((2, 80, 32)).astype(np.float32)
        ref = jax_stats_reference(jnp.asarray(f0), jnp.asarray(f1), 1.0 / (32 * 0.1))
        self._compare(dual_softmax_match_stats(_t(f0), _t(f1), 0.1), ref)
