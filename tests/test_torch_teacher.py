"""The frozen teacher (`data/teacher.py`) against the JAX package's, on the CPU.

Native teacher checkpoints written by the JAX package's `save_teacher_ckpt`
at `tiny_test_config()` (with its fine stage) and `loftr_tiny_config()`
(coarse-only), holding the port's seeded weights and seeded random
BatchNorm statistics (mean ~ N(0, 0.1), var in [0.5, 2]). Both packages'
`make_teacher_fn` on the same uint8 pair (sides not a multiple of 8, so
the divisibility pad and the dropping of matches in it run) with a small
threshold: equal keypoint sets within KPT_ATOL px, at least MIN_MATCHES of
them. A file the port writes loads back into the JAX package's
`load_teacher_ckpt`. Each JAX teacher is built and run once, in a
module-scoped fixture.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from featurematching_tpu.config import loftr_tiny_config as jax_loftr_tiny_config
from featurematching_tpu.config import tiny_test_config as jax_tiny_test_config
from featurematching_tpu.data import teacher as jax_teacher
from featurematching_tpu_torch.config import ModelConfig, config_from_dict, loftr_tiny_config
from featurematching_tpu_torch.data import teacher
from featurematching_tpu_torch.models.matcher import Matcher
from featurematching_tpu_torch.utils.weights import to_jax_tree

KPT_ATOL = 1e-4  # px
THR = 1e-4
MIN_MATCHES = 4


def _random_stats(tree, rng):
    if "mean" in tree:
        n = tree["mean"].shape
        return {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in tree.items()}


def _pair(seed, h=60, w=90):
    """A uint8 grayscale pair: smooth noise, the second shifted 8 px."""
    rng = np.random.default_rng(seed)
    base = rng.random((h // 4 + 1, w // 4 + 1))
    img = np.kron(base, np.ones((4, 4)))[:h, :w]
    return (img * 255).astype(np.uint8), (np.roll(img, 8, axis=1) * 255).astype(np.uint8)


def _key_set(k0, k1):
    return np.concatenate([k0, k1], axis=1)[np.lexsort((k1[:, 1], k1[:, 0], k0[:, 1], k0[:, 0]))]


@pytest.fixture(scope="module", params=["tiny_test", "loftr_tiny"])
def ckpt_run(request, tmp_path_factory):
    """(JAX keypoints, port keypoints, checkpoint path, model config) of one
    native checkpoint on one pair."""
    jcfg = {"tiny_test": jax_tiny_test_config, "loftr_tiny": jax_loftr_tiny_config}[
        request.param]().model
    cfg = config_from_dict(ModelConfig, dataclasses.asdict(jcfg))
    model = Matcher(cfg, device="cpu", seed=11)
    params = to_jax_tree(model)
    stats = _random_stats(to_jax_tree(model, batch_stats=True), np.random.default_rng(12))
    path = str(tmp_path_factory.mktemp("teacher") / f"{request.param}.npz")
    jax_teacher.save_teacher_ckpt(path, jcfg, params, stats)
    img0, img1 = _pair(13)
    ref = jax_teacher.make_teacher_fn(ckpt=path, thr=THR, platform="cpu")(img0, img1)
    got = teacher.make_teacher_fn(ckpt=path, thr=THR, device="cpu")(img0, img1)
    return ref, got, path, cfg


def test_teacher_matches_jax_on_a_jax_checkpoint(ckpt_run):
    """The same keypoints, fine-refined (tiny_test) or the coarse centres
    (loftr_tiny, coarse-only), none in the pad."""
    (r0, r1), (g0, g1), _, cfg = ckpt_run
    assert g0.dtype == np.float32 and g0.shape == g1.shape and g0.shape[1] == 2
    assert len(r0) >= MIN_MATCHES and len(g0) == len(r0)
    np.testing.assert_allclose(_key_set(g0, g1), _key_set(np.asarray(r0), np.asarray(r1)),
                               rtol=0, atol=KPT_ATOL)
    assert (g0[:, 0] < 90).all() and (g0[:, 1] < 60).all()
    assert (g1[:, 0] < 90).all() and (g1[:, 1] < 60).all()
    if cfg.coarse_only:
        assert not (g0 % 8).any()


def test_port_checkpoint_loads_in_jax(ckpt_run, tmp_path):
    """A checkpoint the port writes loads into the JAX package's
    `load_teacher_ckpt` (config, weights and statistics) and back into the
    port's."""
    _, _, path, cfg = ckpt_run
    _, params, stats = teacher.load_teacher_ckpt(path)
    out = str(tmp_path / "port.npz")
    teacher.save_teacher_ckpt(out, cfg, params, stats)
    jcfg, jparams, jstats = jax_teacher.load_teacher_ckpt(out)
    assert config_from_dict(ModelConfig, dataclasses.asdict(jcfg)) == cfg
    flat = jax.tree_util.tree_leaves_with_path
    got = {jax.tree_util.keystr(k): v for k, v in flat(jparams)}
    want = {jax.tree_util.keystr(k): v for k, v in flat(params)}
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    assert jax.tree_util.tree_structure(jstats) == jax.tree_util.tree_structure(stats)
    cfg2, params2, _ = teacher.load_teacher_ckpt(out)
    assert cfg2 == cfg
    np.testing.assert_array_equal(params2["coarse_transformer"]["layer_0"]["merge"]["kernel"],
                                  params["coarse_transformer"]["layer_0"]["merge"]["kernel"])


def test_pad_to_multiple_matches_jax():
    img = np.arange(60 * 90, dtype=np.float32).reshape(60, 90)
    np.testing.assert_array_equal(teacher._pad_to_multiple(img, 8),
                                  jax_teacher._pad_to_multiple(img, 8))
    assert teacher._pad_to_multiple(img[:56, :88], 8).shape == (56, 88)


def test_teacher_without_checkpoint():
    """The default teacher is the LoFTR-tiny profile forced coarse-only,
    seeded, on float [0, 1] input as on uint8; another profile is forced
    coarse-only too; the official checkpoint is not read yet."""
    img0, img1 = _pair(14, 48, 64)
    fn = teacher.make_teacher_fn(thr=THR, device="cpu", seed=3)
    k0, k1 = fn(img0, img1)
    f0, f1 = fn(img0 / 255.0, img1 / 255.0)
    assert len(k0) > 0 and not (k0 % 8).any()
    np.testing.assert_array_equal(k0, f0)
    np.testing.assert_array_equal(k1, f1)
    cfg = loftr_tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, coarse_only=False))
    assert len(teacher.make_teacher_fn(cfg=cfg, thr=THR, device="cpu", seed=3)(img0, img1)[0])
    with pytest.raises(NotImplementedError, match="official"):
        teacher.make_teacher_fn(ckpt="outdoor_ds.ckpt", device="cpu")
    with torch.no_grad():
        assert Matcher(cfg.model, device="cpu").uses_positional_encoding()
