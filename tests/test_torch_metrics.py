"""The port's pose-evaluation slice against the JAX package's, on the CPU:
the synthetic two-plane batch, the loader, the per-batch metric chain
(epipolar errors and RANSAC pose errors on the same sampling noise), the
host aggregation, and `apps/evaluate` end to end at a small size.

Tolerances: the batch and the loader's indices bit for bit; epipolar errors
within 1e-5 relative with inf in the same places (plus 5e-9 where E itself
is formed by each side, below); R_errs within 0.05 degrees; the aggregates
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import featurematching_tpu.data.loader as jloader
from featurematching_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from featurematching_tpu.geometry import epipolar as jep
from featurematching_tpu.utils import metrics as jmetrics
from featurematching_tpu_torch.apps import evaluate
from featurematching_tpu_torch.data import loader as tloader
from featurematching_tpu_torch.data.synthetic import synthetic_batch
from featurematching_tpu_torch.geometry import epipolar as tep
from featurematching_tpu_torch.utils import metrics as tmetrics


@pytest.mark.parametrize("n_planes", [1, 2])
def test_synthetic_batch_is_the_jax_batch(n_planes):
    kw = dict(batch_size=2, image_size=(48, 64), channels=3, num_gt=64, n_planes=n_planes)
    ref = jax_synthetic_batch(np.random.default_rng(4), **kw)
    got = synthetic_batch(np.random.default_rng(4), **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32), "i": np.int32(i)}


@pytest.mark.parametrize("shuffle,rank,count", [(False, 0, 1), (True, 0, 1), (True, 1, 3)])
def test_loader_epochs_match_jax(shuffle, rank, count):
    kw = dict(batch_size=3, shuffle=shuffle, seed=5, drop_last=False, num_threads=2,
              process_index=rank, process_count=count)
    ref = jloader.BatchLoader(_Range(17), **kw)
    got = tloader.BatchLoader(_Range(17), **kw)
    for epoch in (0, 1):
        np.testing.assert_array_equal(got.epoch_indices(epoch), ref.epoch_indices(epoch))
    assert len(got) == len(ref)
    for a, b in zip(got.epoch(1), ref.epoch(1)):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_loader_defaults_to_one_process():
    got = tloader.BatchLoader(_Range(5), 2)
    assert (got.process_index, got.process_count) == (0, 1)


def test_split_sampling_and_stack_match_jax():
    items = [f"scene{i}" for i in range(11)]
    assert tloader.train_val_split(items, seed=3) == jloader.train_val_split(items, seed=3)
    for repl in (True, False):
        np.testing.assert_array_equal(
            tloader.scene_balanced_indices([4, 0, 7], 5, replacement=repl, repeat=2, seed=1),
            jloader.scene_balanced_indices([4, 0, 7], 5, replacement=repl, repeat=2, seed=1))
    samples = [_Range(4)[i] for i in range(4)]
    a, b = tloader._stack(samples), jloader._stack(samples)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    cat = tloader.ConcatDataset([_Range(3), _Range(4)])
    assert len(cat) == 7 and int(cat[5]["i"]) == 2


# --- the metric chain ----------------------------------------------------------

B, N_SLOTS, N_HYP = 2, 320, 96


@pytest.fixture(scope="module")
def chain_inputs():
    """The two-plane batch's GT correspondences in a top-K-shaped list: 0.3 px
    noise, a fifth outliers, the rest padding (mask False)."""
    rng = np.random.default_rng(0)
    batch = jax_synthetic_batch(rng, batch_size=B, image_size=(240, 320), num_gt=256,
                                n_planes=2)
    kp0 = np.zeros((B, N_SLOTS, 3), np.float32)
    kp1 = np.zeros((B, N_SLOTS, 3), np.float32)
    mask = np.zeros((B, N_SLOTS), bool)
    for b in range(B):
        g0 = batch["gt_kp0"][b][batch["gt_mask"][b]][:200]
        g1 = batch["gt_kp1"][b][batch["gt_mask"][b]][:200]
        n_in, n_out = len(g0), len(g0) // 4
        kp0[b, :n_in, :2] = g0 + rng.normal(0, 0.3, g0.shape)
        kp1[b, :n_in, :2] = g1 + rng.normal(0, 0.3, g1.shape)
        kp0[b, n_in:n_in + n_out, :2] = rng.uniform(0, (320, 240), (n_out, 2))
        kp1[b, n_in:n_in + n_out, :2] = rng.uniform(0, (320, 240), (n_out, 2))
        kp0[b, n_in + n_out:, :2] = 7.0  # padding: finite, never sampled
        mask[b, :n_in + n_out] = True
    return kp0, kp1, mask, batch["T_0to1"], batch["K0"], batch["K1"]


@pytest.fixture(scope="module")
def chains(chain_inputs):
    key = jax.random.PRNGKey(3)
    j_in = [jnp.asarray(a) for a in chain_inputs]
    j_epi = jmetrics.compute_symmetrical_epipolar_errors(*j_in)
    j_pose = jmetrics.compute_pose_errors(*j_in, key, num_hypotheses=N_HYP)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (N_HYP, N_SLOTS)))
                      for k in jax.random.split(key, B)])
    t_in = [torch.tensor(a) for a in chain_inputs]
    t_epi, t_pose = evaluate.batch_errors(*t_in, torch.tensor(noise))
    return (np.asarray(j_epi), {k: np.asarray(v) for k, v in j_pose.items()},
            t_epi.numpy(), {k: v.numpy() for k, v in t_pose.items()})


def test_epipolar_errors_match_jax(chains, chain_inputs):
    j_epi, _, t_epi, _ = chains
    mask = chain_inputs[2]
    np.testing.assert_array_equal(np.isinf(t_epi), np.isinf(j_epi))
    np.testing.assert_array_equal(np.isinf(t_epi), ~mask)
    # JAX's CPU matmul forms E = [t]_x R by fused multiply-adds, torch by
    # products and sums: E differs by one float32 rounding (7.5e-9 of
    # entries about 0.1), which moves an error d = r^2 (1/a + 1/b) (r about
    # 3e-4, 1/a + 1/b about 200 here) by up to about 2.4e-9
    np.testing.assert_allclose(t_epi[mask], j_epi[mask], rtol=1e-5, atol=5e-9)


def test_epipolar_errors_on_jax_essential_matrices(chain_inputs):
    """From the same E (JAX's), the errors agree to 1e-5 relative."""
    kp0, kp1, mask, T, K0, K1 = chain_inputs
    E = np.asarray(jep.essential_from_pose(jnp.asarray(T)))
    ref = jep.symmetric_epipolar_distance(*(jnp.asarray(a) for a in (
        kp0[..., :2], kp1[..., :2], E, K0, K1)))
    got = tep.symmetric_epipolar_distance(*(torch.tensor(a) for a in (
        kp0[..., :2], kp1[..., :2], E, K0, K1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=0)


def test_pose_errors_match_jax(chains):
    _, j_pose, _, t_pose = chains
    np.testing.assert_array_equal(t_pose["pose_valid"], j_pose["pose_valid"])
    assert t_pose["pose_valid"].all()
    np.testing.assert_allclose(t_pose["R_errs"], j_pose["R_errs"], rtol=0, atol=0.05)
    assert (t_pose["R_errs"] < 1.0).all()
    assert (np.abs(t_pose["num_inliers"].astype(int) - j_pose["num_inliers"]) <= 2).all()


def test_compute_pose_errors_from_its_generator(chain_inputs):
    t_in = [torch.tensor(a) for a in chain_inputs]
    a = tmetrics.compute_pose_errors(*t_in, torch.Generator().manual_seed(1), num_hypotheses=64)
    b = tmetrics.compute_pose_errors(*t_in, torch.Generator().manual_seed(1), num_hypotheses=64)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["pose_valid"].all() and (a["R_errs"] < 1.0).all()


def test_pose_errors_are_inf_without_enough_matches(chain_inputs):
    kp0, kp1, mask, T, K0, K1 = (torch.tensor(a) for a in chain_inputs)
    few = torch.zeros_like(mask)
    few[:, :4] = True
    out = tmetrics.compute_pose_errors(kp0, kp1, few, T, K0, K1,
                                       torch.Generator().manual_seed(0), num_hypotheses=32)
    assert not out["pose_valid"].any()
    assert torch.isinf(out["R_errs"]).all() and torch.isinf(out["t_errs"]).all()


def test_pose_errors_from_head_match_jax(rng):
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, :3, 3] = rng.standard_normal((3, 3))
    P = T.copy()
    P[:, :3, 3] += rng.standard_normal((3, 3)).astype(np.float32) * 0.1
    ref = jmetrics.compute_pose_errors_from_head(jnp.asarray(T), jnp.asarray(P))
    got = tmetrics.compute_pose_errors_from_head(torch.tensor(T), torch.tensor(P))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5)


def test_aggregate_metrics_equal_jax(chains, rng):
    j_epi, j_pose, _, _ = chains
    errs = rng.exponential(8.0, 12)
    errs[[2, 7]] = np.inf
    agg = {
        "identifiers": [0, 1, 2, 3, 1, 4, 5, 6, 7, 8, 9, 10],
        "R_errs": errs.tolist(), "t_errs": (errs[::-1] * 0.5).tolist(),
        "epi_errs": [j_epi[i % 2][np.isfinite(j_epi[i % 2])] * (i + 1) for i in range(12)],
    }
    assert tmetrics.aggregate_metrics(agg) == jmetrics.aggregate_metrics(agg)
    for thr in (5e-4, 1e-3):
        assert tmetrics.epidist_prec(agg["epi_errs"], (thr,)) == jmetrics.epidist_prec(
            agg["epi_errs"], (thr,))
    assert tmetrics.error_auc(errs) == jmetrics.error_auc(errs)


# --- the app -----------------------------------------------------------------

def test_evaluate_dataset_on_the_cpu():
    ds = evaluate.SyntheticPairs(4, 64, 64, gray=False, n_planes=2)
    out = evaluate.evaluate_dataset(ds, batch_size=2, limit=4, num_hypotheses=32, device="cpu")
    assert set(out) == {"auc@5", "auc@10", "auc@20", "prec@5e-04"}
    assert all(np.isfinite(v) for v in out.values())


def test_evaluate_main_prints_the_metrics(capsys, tmp_path):
    dest = tmp_path / "m.json"
    assert evaluate.main(["synthetic", "--limit", "2", "--batch", "2", "--size", "64", "64",
                          "--device", "cpu", "--out", str(dest)]) == 0
    assert '"auc@5"' in capsys.readouterr().out and '"prec@5e-04"' in dest.read_text()


@pytest.mark.parametrize("kind", ["scared", "endoslam", "unity"])
def test_unported_readers_raise(kind):
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        evaluate.main([kind, "/nonexistent", "--device", "cpu"])


@pytest.mark.parametrize("kw,item", [({"ckpt": "ckpts/x"}, "item 5"),
                                     ({"model_shard": 2}, "item 6")])
def test_unported_options_raise(kw, item):
    ds = evaluate.SyntheticPairs(2, 64, 64, gray=False)
    with pytest.raises(NotImplementedError, match=item):
        evaluate.evaluate_dataset(ds, device="cpu", **kw)


def test_import_check_covers_the_new_modules():
    import test_torch_imports

    names = {str(p.relative_to(test_torch_imports.ROOT / "featurematching_tpu_torch"))
             for p in test_torch_imports.FILES[:-1]}
    assert {"geometry/se3.py", "geometry/epipolar.py", "geometry/five_point.py",
            "geometry/ransac.py", "geometry/__init__.py", "utils/metrics.py",
            "data/loader.py", "apps/evaluate.py"} <= names
