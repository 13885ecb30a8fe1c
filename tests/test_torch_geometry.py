"""The port's geometry (`featurematching_tpu_torch/geometry/`) against the JAX
package's, on the CPU: the same inputs, made from a seed with numpy.

Tolerances: se3 and epipolar within 1e-5 (absolute plus relative, float32
both); the root finder's sorted roots within 2e-3 (the JAX package's own
tolerance for it); the 5-point solver fed the JAX solver's null basis slot
for slot within 1e-4 on samples away from its gates, and as a set within
1e-3 with its own basis; the pose steps within 1e-4 to 1e-3; RANSAC on the
JAX function's own Gumbel noise within 0.05 degrees of its pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurematching_tpu.geometry import epipolar as jep
from featurematching_tpu.geometry import five_point as jfp
from featurematching_tpu.geometry import ransac as jra
from featurematching_tpu.geometry import se3 as jse3
from featurematching_tpu_torch.geometry import epipolar as tep
from featurematching_tpu_torch.geometry import five_point as tfp
from featurematching_tpu_torch.geometry import ransac as tra
from featurematching_tpu_torch.geometry import se3 as tse3
from test_five_point import _problem
from test_geometry import make_two_view_scene, random_rotation


def _f32(x):
    return np.asarray(x, np.float32)


def _both(fn_name, module_j, module_t, *args):
    """fn(*args) through the JAX and the port's function, as numpy."""
    got = getattr(module_t, fn_name)(*(torch.tensor(a) for a in args))
    ref = getattr(module_j, fn_name)(*(jnp.asarray(a) for a in args))
    if isinstance(ref, tuple):
        return [np.asarray(r) for r in ref], [g.numpy() for g in got]
    return [np.asarray(ref)], [got.numpy()]


def _rotations(rng, n):
    return _f32(np.stack([random_rotation(rng) for _ in range(n)]))


def _poses(rng, n):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = _rotations(rng, n)
    T[:, :3, 3] = rng.standard_normal((n, 3))
    return _f32(T)


SE3_CASES = {
    "axis_angle_to_matrix": lambda rng: (_f32(rng.standard_normal((16, 3))),),
    "matrix_to_euler_zyx": lambda rng: (_rotations(rng, 16),),
    "euler_zyx_to_matrix": lambda rng: (_f32(rng.uniform(-3, 3, (16, 3))),),
    "quat_to_matrix": lambda rng: (_f32(rng.standard_normal((16, 4))),),
    "matrix_to_quat": lambda rng: (_rotations(rng, 32),),
    "transform_from_params": lambda rng: (_f32(rng.standard_normal((8, 3))),
                                          _f32(rng.standard_normal((8, 3)))),
    "invert_se3": lambda rng: (_poses(rng, 8),),
    "relative_pose_error": lambda rng: (_poses(rng, 16), _rotations(rng, 16),
                                        _f32(rng.standard_normal((16, 3)))),
    "angular_translation_error": lambda rng: (_poses(rng, 16),
                                              _f32(rng.standard_normal((16, 3)))),
    "so3_exp": lambda rng: (_f32(np.concatenate([rng.standard_normal((16, 3)),
                                                 rng.standard_normal((4, 3)) * 1e-3])),),
    "so3_log": lambda rng: (_rotations(rng, 16),),
    "se3_exp": lambda rng: (_f32(rng.standard_normal((16, 6)) * 0.5),),
    "se3_log": lambda rng: (_poses(rng, 16),),
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_against_jax(name, rng):
    ref, got = _both(name, jse3, tse3, *SE3_CASES[name](rng))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_se3_exports_of_the_package():
    import featurematching_tpu.geometry as jg
    import featurematching_tpu_torch.geometry as tg

    names = {n for n in dir(jg) if not n.startswith("_")
             and callable(getattr(jg, n))} - {"triangulate_linear"}
    assert names <= set(dir(tg)), names - set(dir(tg))


def _points(rng, n=64):
    return _f32(rng.uniform(-0.6, 0.6, (4, n, 2))), _f32(rng.uniform(-0.6, 0.6, (4, n, 2)))


def _intrinsics(n=4):
    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
    return _f32(np.broadcast_to(K, (n, 3, 3)))


EPI_CASES = {
    "cross_product_matrix": lambda rng: (_f32(rng.standard_normal((8, 3))),),
    "essential_from_pose": lambda rng: (_poses(rng, 8),),
    "normalize_keypoints": lambda rng: (_f32(rng.uniform(0, 640, (4, 32, 2))), _intrinsics()),
    "symmetric_epipolar_distance": lambda rng: (*_points(rng), _poses(rng, 4)[:, :3, :3]),
    "sampson_distance": lambda rng: (*_points(rng), _poses(rng, 4)[:, :3, :3]),
    "epipolar_errors_batch": lambda rng: (_f32(rng.uniform(0, 640, (4, 32, 2))),
                                          _f32(rng.uniform(0, 640, (4, 32, 2))),
                                          _poses(rng, 4), _intrinsics(), _intrinsics()),
}


@pytest.mark.parametrize("name", sorted(EPI_CASES))
def test_epipolar_against_jax(name, rng):
    ref, got = _both(name, jep, tep, *EPI_CASES[name](rng))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_symmetric_epipolar_distance_with_intrinsics(rng):
    p0, p1 = _f32(rng.uniform(0, 640, (2, 4, 32, 2)))
    E, K = _poses(rng, 4)[:, :3, :3], _intrinsics()
    ref = jep.symmetric_epipolar_distance(*(jnp.asarray(a) for a in (p0, p1, E, K, K)))
    got = tep.symmetric_epipolar_distance(*(torch.tensor(a) for a in (p0, p1, E, K, K)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- the 5-point solver ------------------------------------------------------

@pytest.mark.parametrize("roots", [
    [-25.0, -3.0, -1.5, -0.2, 0.1, 0.4, 2.0, 7.0, 30.0, 55.0],
    [-4.0, -2.5, -1.0, -0.5, 0.25, 0.75, 1.5, 3.0, 4.5, 9.0],
])
def test_durand_kerner_against_jax(roots):
    c = np.poly(np.asarray(roots))[::-1].astype(np.float32)  # ascending
    rj, okj = jfp._durand_kerner(jnp.asarray(c)[None])
    rt, okt = tfp._durand_kerner(torch.tensor(c)[None])
    assert bool(okj[0]) and bool(okt[0])
    np.testing.assert_allclose(np.sort(rt[0].real.numpy()), np.sort(np.asarray(rj[0]).real),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.sort(rt[0].real.numpy()), np.sort(roots), rtol=2e-3, atol=2e-3)


def test_durand_kerner_random_polynomials():
    c = np.random.default_rng(1).standard_normal((16, 11)).astype(np.float32)
    rj, _ = jfp._durand_kerner(jnp.asarray(c))
    rt, _ = tfp._durand_kerner(torch.tensor(c))
    for a, b in zip(np.asarray(rj), rt.numpy()):  # as sets: each JAX root has a port root
        err = np.abs(a[:, None] - b[None]).min(1) / (1 + np.abs(a))
        assert err.max() < 2e-3, err


def _jax_basis(A):
    _, _, Vt = jnp.linalg.svd(jnp.asarray(A), full_matrices=True)
    return np.asarray(Vt[5:9])


def _well_conditioned(basis) -> bool:
    """A sample away from the solver's gates, judged in float64 from the
    basis: the Gauss-Jordan block's condition below 1e4, every root of the
    degree-10 polynomial within 10 of 0, real or with an imaginary part above
    0.1 (1 + |r|) (the real-root gate is 2e-2 (1 + |r|)), and apart from every
    other root by 0.1 (1 + |r|)."""
    Ep = np.moveaxis(basis.reshape(4, 3, 3), 0, -1).astype(np.float64)
    M = tfp._constraint_matrix(torch.tensor(Ep)).numpy()
    M = M / np.linalg.norm(M, axis=-1, keepdims=True)
    if np.linalg.cond(M[:, :10]) > 1e4:
        return False
    R = torch.tensor(np.linalg.solve(M[:, :10], M[:, 10:]))

    def row(hi, lo):
        z = torch.zeros(1, dtype=R.dtype)
        return [torch.cat([a, z]) - torch.cat([z, b]) for a, b in zip(
            (hi[0:3].flip(-1), hi[3:6].flip(-1), hi[6:10].flip(-1)),
            (lo[0:3].flip(-1), lo[3:6].flip(-1), lo[6:10].flip(-1)))]

    n = tfp._det_B(*row(R[4], R[5]), *row(R[6], R[7]), *row(R[8], R[9])).numpy()
    r = np.roots(n[::-1])
    scale = 1 + np.abs(r)
    im = np.abs(r.imag) / scale
    gaps = (np.abs(r[:, None] - r[None]) + np.eye(len(r)) * 1e9).min(1) / scale
    return bool((np.abs(r) < 10).all() and not ((im > 1e-6) & (im < 0.1)).any()
                and (gaps > 0.1).all())


def _samples(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p0, p1, _, _, E_true = _problem(rng, 5)
        A = np.asarray(jfp._epipolar_rows(jnp.asarray(p0), jnp.asarray(p1)))
        out.append((p0, p1, A, _jax_basis(A), E_true))
    return out


@pytest.fixture(scope="module")
def well_samples():
    got = [s for s in _samples(40) if _well_conditioned(s[3])]
    assert len(got) >= 8, f"only {len(got)} of 40 samples well conditioned"
    return got


def test_candidates_from_jax_basis_slot_for_slot(well_samples):
    A = np.stack([s[2] for s in well_samples])
    basis = np.stack([s[3] for s in well_samples])
    p0 = np.stack([s[0] for s in well_samples])
    p1 = np.stack([s[1] for s in well_samples])
    Ej, vj = jfp.five_point_candidates(jnp.asarray(p0), jnp.asarray(p1))
    Et, vt = tfp.candidates_from_basis(torch.tensor(A), torch.tensor(basis))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), rtol=0, atol=1e-4)


def test_five_point_candidates_as_sets(well_samples):
    p0 = np.stack([s[0] for s in well_samples])
    p1 = np.stack([s[1] for s in well_samples])
    Ej, vj = map(np.asarray, jfp.five_point_candidates(jnp.asarray(p0), jnp.asarray(p1)))
    Et, vt = tfp.five_point_candidates(torch.tensor(p0), torch.tensor(p1))
    Et, vt = Et.numpy(), vt.numpy()
    for k, s in enumerate(well_samples):
        ours = Et[k][vt[k]]
        for e in Ej[k][vj[k]]:
            err = min(min(np.abs(e - f).max(), np.abs(e + f).max()) for f in ours)
            assert err < 1e-3, (k, err)
        # the true E is among the port's candidates
        hit = min(min(np.linalg.norm(f - s[4]), np.linalg.norm(f + s[4])) for f in ours)
        assert hit < 2e-2


def test_null_basis_spans_the_null_space(rng):
    p0 = _f32(rng.standard_normal((6, 5, 2)) * 0.3)
    p1 = _f32(rng.standard_normal((6, 5, 2)) * 0.3)
    A = tfp._epipolar_rows(torch.tensor(p0), torch.tensor(p1))
    basis = tfp.null_basis(A)
    np.testing.assert_allclose((basis @ basis.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(4), (6, 4, 4)), atol=1e-5)
    assert float((A @ basis.transpose(-1, -2)).abs().max()) < 1e-5


def test_degenerate_sample_gives_no_nan():
    p = torch.ones((1, 5, 2)) * 0.1
    E, valid = tfp.five_point_candidates(p, p)
    assert torch.isfinite(E).all() and valid.dtype == torch.bool
    bad = p.clone()
    bad[0, 2, 0] = float("nan")
    E, valid = tfp.five_point_candidates(bad, p)
    assert torch.isfinite(E).all() and not valid.any()


# --- the pose steps ------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    T, x0, x1 = make_two_view_scene(rng, 100, 1e-4)
    w = _f32(rng.uniform(size=100) > 0.2)
    return T, _f32(x0), _f32(x1), w


def test_eight_point_up_to_sign(scene):
    _, p0, p1, w = scene
    Ej = np.asarray(jra._eight_point(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(w)))
    Et = tra._eight_point(torch.tensor(p0), torch.tensor(p1), torch.tensor(w)).numpy()
    assert min(np.abs(Ej - Et).max(), np.abs(Ej + Et).max()) < 1e-3
    s = np.linalg.svd(Et, compute_uv=False)
    np.testing.assert_allclose(s, [s[0], s[0], 0.0], atol=1e-5)


def test_eight_point_batched_equals_one_at_a_time(scene):
    _, p0, p1, w = scene
    ws = np.stack([w, np.ones_like(w), w[::-1].copy()])
    batched = tra._eight_point(torch.tensor(p0), torch.tensor(p1), torch.tensor(ws))
    for k in range(3):
        one = tra._eight_point(torch.tensor(p0), torch.tensor(p1), torch.tensor(ws[k]))
        np.testing.assert_allclose(batched[k].numpy(), one.numpy(), atol=1e-6)


def _noisy_essential(T, rng, noise):
    E = np.asarray(jep.essential_from_pose(jnp.asarray(T, jnp.float32)))
    return _f32(E / np.linalg.norm(E) + rng.standard_normal((3, 3)) * noise)


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_recover_pose_from_essential(scene, noise):
    T, p0, p1, w = scene
    E = _noisy_essential(T, np.random.default_rng(1), noise)
    Rj, tj, vj = jra.recover_pose_from_essential(*(jnp.asarray(a) for a in (E, p0, p1, w)))
    Rt, tt, vt = tra.recover_pose_from_essential(*(torch.tensor(a) for a in (E, p0, p1, w)))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    # the same four votes, R1 and R2 possibly swapped
    assert sorted(vt.numpy().tolist()) == sorted(np.asarray(vj).tolist())


def test_decompose_essential_gives_jax_candidates(scene):
    T = scene[0]
    E = _noisy_essential(T, np.random.default_rng(2), 1e-4)
    R1j, R2j, tj = map(np.asarray, jra.decompose_essential(jnp.asarray(E)))
    R1t, R2t, tt = (x.numpy() for x in tra.decompose_essential(torch.tensor(E)))
    for R in (R1t, R2t):
        assert min(np.abs(R - R1j).max(), np.abs(R - R2j).max()) < 1e-4
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(R) - 1) < 1e-5
    assert min(np.abs(tt - tj).max(), np.abs(tt + tj).max()) < 1e-4


def test_refine_pose_sampson(scene):
    T, p0, p1, w = scene
    E = _noisy_essential(T, np.random.default_rng(3), 3e-3)
    R0, t0, _ = jra.recover_pose_from_essential(*(jnp.asarray(a) for a in (E, p0, p1, w)))
    Rj, tj = jra.refine_pose_sampson(R0, t0, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(w))
    Rt, tt = tra.refine_pose_sampson(torch.tensor(np.asarray(R0)), torch.tensor(np.asarray(t0)),
                                     torch.tensor(p0), torch.tensor(p1), torch.tensor(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)


# --- RANSAC ------------------------------------------------------------------

H_RANSAC = 128
PAD = 64


def _ransac_pair(seed):
    """tests/test_geometry.py's RANSAC scene: 200 inliers with 1e-4 noise,
    50 outliers, and 64 padded rows far away."""
    rng = np.random.default_rng(seed)
    T, x0, x1 = make_two_view_scene(rng, 200, 1e-4)
    pts0 = np.concatenate([x0, rng.standard_normal((50, 2)) * 0.5, np.full((PAD, 2), 1e3)])
    pts1 = np.concatenate([x1, rng.standard_normal((50, 2)) * 0.5, np.full((PAD, 2), -1e3)])
    mask = np.concatenate([np.ones(250, bool), np.zeros(PAD, bool)])
    return T, _f32(pts0), _f32(pts1), mask


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))


@pytest.fixture(scope="module")
def ransac_runs():
    """Three pairs, JAX one at a time on its keys, the port batched on the
    noise JAX drew from those keys."""
    seeds = (0, 1, 2)
    pairs = [_ransac_pair(s) for s in seeds]
    N = len(pairs[0][3])
    jax_res, noise = [], []
    for s, (_, p0, p1, m) in zip(seeds, pairs):
        key = jax.random.PRNGKey(s)
        jax_res.append(jra.estimate_essential_ransac(
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(m), key,
            thresh=3e-3, num_hypotheses=H_RANSAC))
        noise.append(np.asarray(jax.random.gumbel(key, (H_RANSAC, N))))
    stack = [torch.tensor(np.stack([p[i] for p in pairs])) for i in (1, 2, 3)]
    port = tra.essential_ransac_core(*stack, torch.tensor(np.stack(noise)), thresh=3e-3)
    return pairs, jax_res, port


@pytest.mark.parametrize("k", [0, 1, 2])
def test_ransac_core_against_jax_on_its_noise(ransac_runs, k):
    pairs, jax_res, port = ransac_runs
    T = pairs[k][0]
    rj = jax_res[k]
    Rj, Rt = np.asarray(rj.R), port.R[k].numpy()
    assert _rot_deg(Rj, Rt) < 0.05
    t_gt = T[:3, 3] / np.linalg.norm(T[:3, 3])
    for R, t in ((Rj, np.asarray(rj.t)), (Rt, port.t[k].numpy())):
        assert _rot_deg(R, T[:3, :3]) < 1.0
        assert abs(float(np.dot(t, t_gt))) > 0.99
    assert abs(int(rj.num_inliers) - int(port.num_inliers[k])) <= 2
    assert bool(port.valid[k]) and bool(rj.valid)
    assert not port.inliers[k, -PAD:].any()


def test_ransac_eight_point_solver_against_jax():
    T, p0, p1, m = _ransac_pair(0)
    key = jax.random.PRNGKey(0)
    rj = jra.estimate_essential_ransac(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(m), key,
                                       thresh=3e-3, num_hypotheses=64, solver="8pt")
    noise = torch.tensor(np.asarray(jax.random.gumbel(key, (64, len(m)))))[None]
    rt = tra.essential_ransac_core(torch.tensor(p0)[None], torch.tensor(p1)[None],
                                   torch.tensor(m)[None], noise, thresh=3e-3, solver="8pt")
    assert _rot_deg(np.asarray(rj.R), rt.R[0].numpy()) < 0.05
    assert _rot_deg(rt.R[0].numpy(), T[:3, :3]) < 1.0
    assert abs(int(rj.num_inliers) - int(rt.num_inliers[0])) <= 2


def test_ransac_batched_equals_one_at_a_time(ransac_runs):
    pairs, _, port = ransac_runs
    N = len(pairs[0][3])
    noise = tra.gumbel_noise(torch.Generator().manual_seed(5), (1, H_RANSAC, N))
    _, p0, p1, m = pairs[1]
    one = tra.essential_ransac_core(torch.tensor(p0)[None], torch.tensor(p1)[None],
                                    torch.tensor(m)[None], noise, thresh=3e-3)
    two = tra.essential_ransac_core(torch.tensor(np.stack([p0, p0])),
                                    torch.tensor(np.stack([p1, p1])),
                                    torch.tensor(np.stack([m, m])),
                                    torch.cat([noise, noise]), thresh=torch.tensor([3e-3, 3e-3]))
    for k in range(2):
        np.testing.assert_allclose(two.R[k].numpy(), one.R[0].numpy(), atol=1e-6)
        assert int(two.num_inliers[k]) == int(one.num_inliers[0])


def test_estimate_essential_ransac_draws_from_its_generator():
    _, p0, p1, m = _ransac_pair(0)
    args = (torch.tensor(p0), torch.tensor(p1), torch.tensor(m))
    a = tra.estimate_essential_ransac(*args, torch.Generator().manual_seed(7), thresh=3e-3,
                                      num_hypotheses=64)
    b = tra.estimate_essential_ransac(*args, torch.Generator().manual_seed(7), thresh=3e-3,
                                      num_hypotheses=64)
    assert a.R.shape == (3, 3) and a.inliers.shape == m.shape and bool(a.valid)
    assert torch.equal(a.R, b.R) and torch.equal(a.inliers, b.inliers)


@pytest.mark.parametrize("case", ["fewer_than_five", "all_same_point", "non_finite_rows"])
def test_ransac_degenerate_inputs(case):
    _, p0, p1, m = _ransac_pair(0)
    p0, p1, m = torch.tensor(p0), torch.tensor(p1), torch.tensor(m)
    if case == "fewer_than_five":
        m = torch.zeros_like(m)
        m[:3] = True
    elif case == "all_same_point":
        p0 = torch.full_like(p0, 0.1)
        p1 = p0.clone()
    else:
        p0[:20] = float("nan")
    res = tra.estimate_essential_ransac(p0, p1, m, torch.Generator().manual_seed(0),
                                        thresh=3e-3, num_hypotheses=64)
    for x in (res.E, res.R, res.t):
        assert torch.isfinite(x).all()
    if case == "fewer_than_five":
        assert not bool(res.valid)
    if case == "non_finite_rows":
        assert not res.inliers[:20].any() and bool(res.valid)
