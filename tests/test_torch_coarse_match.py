"""The coarse stage's matching and the coarse-only Matcher against the JAX
package.

On the CPU, with inputs made by numpy from a seed: the port's
`dual_softmax_confidence` (the JAX rounding points) in float32 and bfloat16,
and in bfloat16 K1's rounding point (`ops/dual_softmax`), which the check
sees; `extract_matches` and `coarse_match` with a conf matrix (planted exact
ties within a row and within a column, equal scores of two matches, a matrix
with no valid match, grids below `max_matches` so the padding runs,
`border_rm` 0 and 2), and `coarse_match` without one (K1's plain twin
against the JAX statistics, with duplicated features); and the Matcher at
`coarse_only` against flax `Matcher.apply` on a coarse-only tree (a small
Swin configuration, the per-op block, 64x64, batch 2), loaded and written
back with no leftover leaf, and `FastMatcher` refusing it.
"""

import dataclasses
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.config import default_config as jax_default_config
from featurematching_tpu.matching import coarse as jax_coarse
from featurematching_tpu.models.matcher import Matcher as JaxMatcher
from featurematching_tpu_torch.config import ModelConfig, config_from_dict
from featurematching_tpu_torch.matching.coarse import (
    coarse_match,
    dual_softmax_confidence,
    extract_matches,
)
from featurematching_tpu_torch.models.fast_inference import FastMatcher
from featurematching_tpu_torch.models.matcher import Matcher
from featurematching_tpu_torch.ops import dual_softmax as k1
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree

CONF_RTOL = 1e-5  # max |port - JAX| / max |JAX| of the conf matrix
MCONF_ATOL = 1e-6
CONF_ATOL = 1e-5  # the Matcher's conf matrix against flax's (features within 2e-4)
SCALE = 8.0


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, ref):
    return float(np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_softmax_confidence_at_the_jax_rounding_points(dtype):
    """The product of the features in their dtype, accumulated in f32, then
    divided by C * T, as the JAX function does. In bf16 K1's plain twin,
    which rounds f0 / (C * T) to bf16 first, is farther than the tolerance
    (about 1.7e-3), so the check tells the two rounding points apart."""
    rng = np.random.default_rng(0)
    B, L, S, C = 2, 48, 40, 64
    f0 = rng.standard_normal((B, L, C)).astype(np.float32)
    f1 = rng.standard_normal((B, S, C)).astype(np.float32)
    f0[:, :S] += f1  # rows with a clear best column
    j0, j1 = jnp.asarray(f0).astype(dtype), jnp.asarray(f1).astype(dtype)
    ref = np.asarray(jax_coarse.dual_softmax_confidence(j0, j1, 0.1))
    t0, t1 = (_t(a.astype(jnp.float32)).to(getattr(torch, dtype)) for a in (j0, j1))
    got = dual_softmax_confidence(t0, t1, 0.1)
    assert got.dtype == torch.float32 and got.shape == (B, L, S)
    assert _rel(got.numpy(), ref) <= CONF_RTOL
    if dtype == "bfloat16":
        assert _rel(k1.dual_softmax_confidence(t0, t1, 1.0 / (C * 0.1)).numpy(), ref) > 1e-3


def _planted_conf(rng, B, L, S, empty):
    """Random conf with, in each pair, strong mutual maxima; a row whose
    maximum sits at two columns, a column whose maximum sits at two rows,
    and two matches of equal score. `empty`: every entry below thr."""
    conf = (rng.random((B, L, S)) * 0.1).astype(np.float32)
    if empty:
        return conf * 1e-2
    n = min(L, S)
    for b in range(B):
        rows, cols = rng.permutation(L)[:n], rng.permutation(S)[:n]
        conf[b, rows, cols] = 0.3 + 0.6 * rng.random(n)
        conf[b, rows[0], cols[0]] = conf[b, rows[0], cols[5]] = 0.95  # a tie within a row
        conf[b, rows[1], cols[1]] = conf[b, rows[2], cols[1]] = 0.97  # a tie within a column
        conf[b, rows[3], cols[3]] = conf[b, rows[4], cols[4]] = 0.5  # equal scores
    return conf


GRIDS = [((8, 10), (10, 8)), ((5, 6), (6, 5))]  # L = 80 and L = 30 against 32 slots


@pytest.mark.parametrize("grids", GRIDS, ids=["L80", "L30"])
@pytest.mark.parametrize("border_rm", [0, 2])
@pytest.mark.parametrize("empty", [False, True], ids=["planted", "empty"])
def test_extract_matches_and_coarse_match_from_a_matrix(grids, border_rm, empty):
    rng = np.random.default_rng(border_rm + 3 * empty)
    (h0, w0), (h1, w1) = grids
    B, L, S, K = 2, h0 * w0, h1 * w1, 32
    conf = _planted_conf(rng, B, L, S, empty)
    args = (grids[0], grids[1], 0.2, border_rm, K)
    ref = jax_coarse.extract_matches(jnp.asarray(conf), *args)
    got = extract_matches(_t(conf), *args)
    for name, g, r in zip(("i_ids", "j_ids", "mask"), got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=0, atol=MCONF_ATOL)
    n_valid = int(got[2].sum())
    assert n_valid == 0 if empty else n_valid > 0
    feats = np.zeros((B, L, 4), np.float32), np.zeros((B, S, 4), np.float32)
    ref_m, ref_conf = jax_coarse.coarse_match(*map(jnp.asarray, feats), *grids, SCALE, 0.2,
                                              border_rm, 0.1, K, conf=jnp.asarray(conf))
    got_m, got_conf = coarse_match(*map(_t, feats), *grids, SCALE, 0.2, border_rm, 0.1, K,
                                   conf=_t(conf))
    assert got_conf is not None and ref_conf is not None
    for name in ("i_ids", "j_ids", "mask", "mkpts0_c", "mkpts1_c"):
        np.testing.assert_array_equal(getattr(got_m, name).numpy(),
                                      np.asarray(getattr(ref_m, name)), err_msg=name)


def test_the_matrix_ties_are_taken_at_the_first_index():
    """Ties resolve as jnp.argmax resolves them: row 1's maximum at columns
    2 and 4 matches column 2; column 0's at rows 3 and 5 matches row 3; the
    zero-score padding slot takes the lowest row left, 2."""
    conf = np.full((1, 6, 6), 0.01, np.float32)
    conf[0, 1, [2, 4]] = 0.9
    conf[0, [3, 5], 0] = 0.8
    conf[0, 0, 5] = 0.7
    i, j, mask, _ = extract_matches(_t(conf), (2, 3), (2, 3), 0.2, 0, 4)
    assert i[0].tolist() == [1, 3, 0, 2] and j[0].tolist() == [2, 0, 5, 0]
    assert mask[0].tolist() == [True, True, True, False]


@pytest.mark.parametrize("grid", [(8, 10), (5, 6)], ids=["L80", "L30"])
@pytest.mark.parametrize("border_rm", [0, 2])
def test_coarse_match_without_a_matrix(grid, border_rm):
    """K1's plain twin (on the CPU) against the JAX statistics: features
    where row i of f0 leans to column i of f1 with its own strength (scores
    spread over (0, 1), apart by more than the two rounding points'
    difference), a column of f1 duplicated (an exact tie in every row) and
    a row of f0 duplicated (an exact tie in every column)."""
    rng = np.random.default_rng(7 + border_rm)
    B, L, C, K = 2, grid[0] * grid[1], 32, 32
    f1 = 0.5 * rng.standard_normal((B, L, C)).astype(np.float32)
    f1[:, 7] = f1[:, 3]
    f0 = 0.3 * rng.standard_normal((B, L, C)).astype(np.float32)
    f0 += rng.uniform(0.5, 2.0, (B, L, 1)).astype(np.float32) * f1
    f0[:, 9] = f0[:, 2]
    args = (grid, grid, SCALE, 0.05, border_rm, 0.1, K)
    ref, ref_conf = jax_coarse.coarse_match(jnp.asarray(f0), jnp.asarray(f1), *args)
    got, got_conf = coarse_match(_t(f0), _t(f1), *args)
    assert got_conf is None and ref_conf is None
    for name in ("i_ids", "j_ids", "mask", "mkpts0_c", "mkpts1_c"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.mconf.numpy(), np.asarray(ref.mconf), rtol=0, atol=MCONF_ATOL)
    assert int(got.mask.sum()) >= 2


def _coarse_only_jax_config():
    """A small Swin configuration (embed 16, depths 1/1/1 and 1/1/1, window
    4, the per-op block, f32) in the coarse-only mode, thr low enough that
    random weights match."""
    m = jax_default_config().model
    return dataclasses.replace(
        m, compute_dtype="float32", coarse_only=True,
        swin=dataclasses.replace(m.swin, embed_dim=16, depths=(1, 1, 1), depths_up=(1, 1, 1),
                                 num_heads=(1, 2, 4), window_size=4, fused_block="off",
                                 fused_attention="off", drop_path_rate=0.0),
        coarse=dataclasses.replace(m.coarse, fused_train="off", layer_names=("self", "cross")),
        match_coarse=dataclasses.replace(m.match_coarse, thr=1e-6, border_rm=0, max_matches=32),
    )


@pytest.fixture(scope="module")
def coarse_only_setup():
    jc = _coarse_only_jax_config()
    rng = np.random.default_rng(0)
    img0 = rng.random((2, 64, 64, 3)).astype(np.float32)
    img1 = np.roll(img0, 8, axis=2)
    model = JaxMatcher(jc)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(img0),
                                 jnp.asarray(img1))["params"]

    @jax.jit
    def run(params, a, b):
        return [model.apply({"params": params}, a, b, want_conf_matrix=w) for w in (False, True)]

    outs = run(params, jnp.asarray(img0), jnp.asarray(img1))
    return dict(cfg=jc, params=params, img0=img0, img1=img1, outs=outs)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, Mapping) else {path: np.asarray(v)})
    return out


def test_coarse_only_tree_loads_and_writes_back_whole(coarse_only_setup):
    """No fine_down_proj, fine_merge, fine_transformer or mixes: the flax
    tree loads with no missing or unused leaf, and writes back leaf for leaf."""
    cfg = config_from_dict(ModelConfig, dataclasses.asdict(coarse_only_setup["cfg"]))
    assert cfg.coarse_only
    model = Matcher(cfg, device="cpu")
    assert not any(n.startswith(("fine_", "mix_feat")) for n, _ in model.named_parameters())
    load_jax_params(model, coarse_only_setup["params"])
    ref = _leaves(coarse_only_setup["params"])
    got = _leaves(to_jax_tree(model))
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k], r, err_msg=k)


@pytest.mark.parametrize("want_conf", [False, True], ids=["stats", "matrix"])
def test_coarse_only_forward_against_flax(coarse_only_setup, want_conf):
    """The forward ends after the coarse stage, as flax's does: the matches
    (from K1's twin, or from the conf matrix), the "fine" keypoints the
    coarse centres with a zero third column, zero offsets and stds, and the
    fine ids the matches'."""
    s = coarse_only_setup
    model = Matcher(config_from_dict(ModelConfig, dataclasses.asdict(s["cfg"])), device="cpu")
    load_jax_params(model, s["params"])
    with torch.no_grad():
        out = model(_t(s["img0"]), _t(s["img1"]), want_conf_matrix=want_conf)
    ref = s["outs"][want_conf]
    np.testing.assert_allclose(out.feat_c0.numpy(), np.asarray(ref.feat_c0), atol=2e-4, rtol=2e-4)
    if want_conf:
        np.testing.assert_allclose(out.conf_matrix.numpy(), np.asarray(ref.conf_matrix), rtol=0,
                                   atol=CONF_ATOL)
    else:
        assert out.conf_matrix is None and ref.conf_matrix is None
    m = out.coarse.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(ref.coarse.mask))
    assert m.sum() >= 8
    for name in ("i_ids", "j_ids"):
        np.testing.assert_array_equal(getattr(out.coarse, name).numpy()[m],
                                      np.asarray(getattr(ref.coarse, name))[m], err_msg=name)
    for name in ("mkpts0_f", "mkpts1_f", "coords0", "coords1", "std0", "std1"):
        np.testing.assert_array_equal(getattr(out.fine, name).numpy()[m],
                                      np.asarray(getattr(ref.fine, name))[m], err_msg=name)
    np.testing.assert_array_equal(out.fine.mkpts0_f[..., :2].numpy(), out.coarse.mkpts0_c.numpy())
    assert not out.fine.mkpts0_f[..., 2].any()
    for got_ids, ids in zip(out.fine_ids, (out.coarse.i_ids, out.coarse.j_ids, out.coarse.mask)):
        assert torch.equal(got_ids, ids)


def test_fast_matcher_refuses_coarse_only():
    """The JAX serving forward reads the fine stage's weights, which a
    coarse-only tree lacks: FastMatcher raises at construction."""
    with pytest.raises(ValueError, match="coarse"):
        FastMatcher(dataclasses.replace(ModelConfig(), coarse_only=True), device="cpu")
