"""The port's training step and its modules against the JAX package.

At float32 on the CPU, with inputs made by numpy from a seed: supervision
(with the first-occurrence dedup), each loss, the learning-rate schedules
and three optimizer updates against optax, the Matcher's drop-path
semantics, and one whole `train_step` and `eval_step` against JAX
`make_train_step` / `make_eval_step` on a small Swin configuration (embed 16,
depths 1/1/1 and 1/1/1, heads 1/2/4, window 4, 64x64, batch 2,
`fused_block='on'` — the Pallas kernel in interpret mode on the JAX side,
its plain twin on the port's — both `fused_train` switches 'off', drop-path
0), on the same `Matcher.init` weights carried across by `load_jax_params`;
and the port's gradients with `coarse.fused_train='on'` (K9's plain twin),
and with both switches 'on' (K9's and K10's twins), against the same JAX
gradients; and `config_from_dict`'s refusal of JAX fields that would build
another model (and its conversion of `coarse_only`, which the port holds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from featurematching_tpu.config import OptimizerConfig as JaxOptimizerConfig
from featurematching_tpu.config import default_config as jax_default_config
from featurematching_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from featurematching_tpu.losses.loss import compute_coarse_loss as jax_coarse_loss
from featurematching_tpu.losses.loss import compute_fine_loss as jax_fine_loss
from featurematching_tpu.matching.fine import gather_fine_windows as jax_gather_fine_windows
from featurematching_tpu.matching.supervision import (
    compute_supervision_coarse as jax_supervision_coarse,
)
from featurematching_tpu.matching.supervision import (
    compute_supervision_fine as jax_supervision_fine,
)
from featurematching_tpu.train.optimizer import build_lr_schedule as jax_lr_schedule
from featurematching_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from featurematching_tpu.train.step import _forward_with_loss as jax_forward_with_loss
from featurematching_tpu.train.step import create_train_state as jax_create_train_state
from featurematching_tpu.train.step import make_eval_step, make_train_step
from featurematching_tpu_torch.config import Config, LossConfig, OptimizerConfig, config_from_dict
from featurematching_tpu_torch.data.synthetic import synthetic_batch
from featurematching_tpu_torch.losses.loss import compute_coarse_loss, compute_fine_loss
from featurematching_tpu_torch.matching.fine import gather_fine_windows
from featurematching_tpu_torch.matching.supervision import (
    compute_supervision_coarse,
    compute_supervision_fine,
)
from featurematching_tpu_torch.models.backbone_swin import drop_path_rates
from featurematching_tpu_torch.models.matcher import Matcher
from featurematching_tpu_torch.train.optimizer import build_lr_schedule, build_optimizer
from featurematching_tpu_torch.train.step import (
    create_train_state,
    eval_step,
    forward_with_loss,
    train_step,
)
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree

GRAD_RTOL = 3e-4  # ROADMAP's per-leaf gradient tolerance at f32
# the JAX model fields of the config tests' cases that the port holds
HELD = {"coarse_only"}


def _t(a):
    return torch.tensor(np.asarray(a))


def _small_jax_config():
    cfg = jax_default_config()
    m = cfg.model
    model = dataclasses.replace(
        m, compute_dtype="float32",
        swin=dataclasses.replace(m.swin, embed_dim=16, depths=(1, 1, 1), depths_up=(1, 1, 1),
                                 num_heads=(1, 2, 4), window_size=4, fused_block="on",
                                 drop_path_rate=0.0),
        coarse=dataclasses.replace(m.coarse, fused_train="off", layer_names=("self", "cross")),
        fine=dataclasses.replace(m.fine, fused_train="off"),
        match_coarse=dataclasses.replace(m.match_coarse, max_matches=32, max_gt_matches=32),
    )
    opt = dataclasses.replace(cfg.trainer.optimizer, warmup_steps=0)
    return dataclasses.replace(cfg, model=model,
                               trainer=dataclasses.replace(cfg.trainer, batch_size=2, optimizer=opt))


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_step_matches(state, setup):
    """One `train_step` of the port's `state` on `setup["batch"]` against
    the JAX step's metrics and updated parameters (`setup["metrics"]`,
    `["grads"]`, `["new_params"]`), by the tolerance
    `test_metrics_and_updated_parameters` states."""
    lr = build_lr_schedule(state.cfg.trainer.optimizer, 2, 1000)(0)
    state, metrics = train_step(state, setup["batch"])
    for k in ("loss", "loss_c", "loss_f", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(setup["metrics"][k]),
                                   rtol=GRAD_RTOL, err_msg=k)
    got = _leaves(to_jax_tree(state.model))
    grads = _leaves(setup["grads"])
    for k, r in _leaves(setup["new_params"]).items():
        g, eps = np.abs(grads[k]).astype(np.float64), 1e-8
        carried = np.minimum(lr * eps * GRAD_RTOL * g.max() / (g + eps) ** 2, 2 * lr)
        tol = GRAD_RTOL * np.abs(r).max() + carried
        assert (np.abs(got[k] - r) <= tol * 1.001).all(), k


@pytest.fixture(scope="module")
def step_setup():
    jc = _small_jax_config()
    batch = jax_synthetic_batch(np.random.default_rng(0), batch_size=2, image_size=(64, 64),
                                num_gt=32)
    jb = jax.tree.map(jnp.asarray, batch)
    tx = jax_build_optimizer(jc.trainer.optimizer, 2, jc.trainer.steps_per_epoch)
    model, state = jax_create_train_state(jc, tx, jax.random.PRNGKey(0), jb)

    def loss_fn(params):
        losses, _, _ = jax_forward_with_loss(model, jc, params, state.batch_stats, jb, None, True)
        return losses.loss

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    new_state, metrics = jax.jit(make_train_step(model, jc))(state, jb, jax.random.PRNGKey(1))
    out, losses = jax.jit(make_eval_step(model, jc))(new_state, jb)
    return dict(cfg=jc, batch=batch, params=state.params, grads=grads, new_params=new_state.params,
                metrics=metrics, eval_out=out, eval_losses=losses)


def _port_state(setup, coarse_fused_train=None, fine_fused_train=None):
    pc = config_from_dict(Config, dataclasses.asdict(setup["cfg"]))
    m = pc.model
    if coarse_fused_train is not None:
        m = dataclasses.replace(m, coarse=dataclasses.replace(m.coarse,
                                                              fused_train=coarse_fused_train))
    if fine_fused_train is not None:
        m = dataclasses.replace(m, fine=dataclasses.replace(m.fine, fused_train=fine_fused_train))
    pc = dataclasses.replace(pc, model=m)
    state = create_train_state(pc, device="cpu", seed=0, global_batch_size=2)
    load_jax_params(state.model, setup["params"])
    return state


class TestTrainStep:
    def test_synthetic_batch_is_the_same(self, step_setup):
        got = synthetic_batch(np.random.default_rng(0), batch_size=2, image_size=(64, 64), num_gt=32)
        for k, v in step_setup["batch"].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    def test_loss_and_every_gradient_leaf(self, step_setup):
        state = _port_state(step_setup)
        losses, _ = forward_with_loss(state.model, state.cfg, step_setup["batch"], train=True)
        losses.loss.backward()
        got = to_jax_tree(state.model, grads=True)
        ref = _leaves(step_setup["grads"])
        assert set(_leaves(got)) == set(ref)
        for k, r in ref.items():
            g = _leaves(got)[k]
            assert np.abs(g - r).max() <= GRAD_RTOL * np.abs(r).max() + 1e-9, k

    def test_loss_and_every_gradient_leaf_with_coarse_fused_train_on(self, step_setup,
                                                                      monkeypatch):
        """The port's step through K9 (its plain twin on the CPU) against the
        JAX gradients of the per-op stack: the same math at f32."""
        import featurematching_tpu_torch.ops.coarse_transformer_train as ctt

        calls = []
        twin = ctt.coarse_layer_backward_reference
        monkeypatch.setattr(ctt, "coarse_layer_backward_reference",
                            lambda *a: calls.append(1) or twin(*a))
        state = _port_state(step_setup, coarse_fused_train="on")
        losses, _ = forward_with_loss(state.model, state.cfg, step_setup["batch"], train=True)
        losses.loss.backward()
        assert len(calls) == 3  # a self call and a cross layer's two calls
        got = _leaves(to_jax_tree(state.model, grads=True))
        ref = _leaves(step_setup["grads"])
        assert set(got) == set(ref)
        for k, r in ref.items():
            assert np.abs(got[k] - r).max() <= GRAD_RTOL * np.abs(r).max() + 1e-9, k

    def test_loss_and_every_gradient_leaf_with_both_fused_train_on(self, step_setup,
                                                                    monkeypatch):
        """The port's step through K9 and K10 (their plain twins on the CPU)
        against the JAX gradients of the per-op stacks: the same math at f32."""
        import featurematching_tpu_torch.ops.coarse_transformer_train as ctt
        import featurematching_tpu_torch.ops.fine_transformer_train as ftt

        calls = {"k9": 0, "k10": 0}
        for mod, name, key in ((ctt, "coarse_layer_backward_reference", "k9"),
                               (ftt, "fine_layer_backward_reference", "k10")):
            twin = getattr(mod, name)

            def spy(*a, twin=twin, key=key):
                calls[key] += 1
                return twin(*a)

            monkeypatch.setattr(mod, name, spy)
        state = _port_state(step_setup, coarse_fused_train="on", fine_fused_train="on")
        losses, _ = forward_with_loss(state.model, state.cfg, step_setup["batch"], train=True)
        losses.loss.backward()
        assert calls == {"k9": 3, "k10": 3}
        got = _leaves(to_jax_tree(state.model, grads=True))
        ref = _leaves(step_setup["grads"])
        assert set(got) == set(ref)
        for k, r in ref.items():
            assert np.abs(got[k] - r).max() <= GRAD_RTOL * np.abs(r).max() + 1e-9, k

    def test_metrics_and_updated_parameters(self, step_setup):
        """loss, loss_c, loss_f and grad_norm within 3e-4. The updated
        parameters within 3e-4 of each leaf's max plus the gradient
        tolerance carried through Adam's first step, lr g / (|g| + eps):
        an entry's gradient may differ by 3e-4 of its leaf's max, which moves
        the step by up to lr eps 3e-4 max|g| / (|g| + eps)^2, at most 2 lr.
        (Where |g| is near eps this is the whole step: the key part of every
        qkv bias has an exact gradient of 0, softmax rows being
        shift-invariant, and holds rounding noise on both sides.)"""
        assert_step_matches(_port_state(step_setup), step_setup)

    def test_eval_step(self, step_setup):
        state = _port_state(step_setup)
        load_jax_params(state.model, step_setup["new_params"])
        out, losses = eval_step(state, step_setup["batch"])
        ref, ref_losses = step_setup["eval_out"], step_setup["eval_losses"]
        np.testing.assert_allclose(out.feat_c0.numpy(), np.asarray(ref.feat_c0), atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(out.coarse.mask.numpy(), np.asarray(ref.coarse.mask))
        m = out.coarse.mask.numpy()
        np.testing.assert_array_equal(out.coarse.i_ids.numpy()[m], np.asarray(ref.coarse.i_ids)[m])
        np.testing.assert_allclose(out.fine.mkpts0_f.numpy()[m], np.asarray(ref.fine.mkpts0_f)[m],
                                   atol=1e-3, rtol=1e-4)
        for k in ("loss", "loss_c", "loss_f"):
            np.testing.assert_allclose(float(getattr(losses, k)), float(getattr(ref_losses, k)),
                                       rtol=GRAD_RTOL, err_msg=k)

    def test_uint8_images(self, step_setup):
        """8-bit images divide by 255 on the device, as the JAX step does."""
        state = _port_state(step_setup)
        b = dict(step_setup["batch"])
        u8 = {k: np.round(b[k] * 255).astype(np.uint8) for k in ("image0", "image1")}
        ref, _ = forward_with_loss(state.model, state.cfg,
                                   dict(b, **{k: v.astype(np.float32) / 255 for k, v in u8.items()}),
                                   train=False)
        got, _ = forward_with_loss(state.model, state.cfg, dict(b, **u8), train=False)
        assert float(got.loss.detach()) == float(ref.loss.detach())

    def test_loss_falls_on_a_fixed_batch(self, step_setup):
        """Four AdamW steps at lr 2e-3 (canonical_lr 0.064 at batch 2)."""
        state = _port_state(step_setup)
        ocfg = dataclasses.replace(state.cfg.trainer.optimizer, canonical_lr=0.064)
        state.optimizer = build_optimizer(state.model.parameters(), ocfg, 2, 1000)
        first = None
        for _ in range(4):
            state, metrics = train_step(state, step_setup["batch"])
            first = float(metrics["loss"]) if first is None else first
        assert float(metrics["loss"]) < first


class TestSupervision:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_coarse_and_fine_against_jax(self, seed):
        """Duplicates in both images' cells, padding and out-of-grid rows."""
        rng = np.random.default_rng(seed)
        B, G, grid = 2, 40, (6, 8)
        kp0 = rng.uniform(-4, 68, (B, G, 2)).astype(np.float32)
        kp1 = rng.uniform(-4, 52, (B, G, 2)).astype(np.float32)
        kp0[:, 10:20] = kp0[:, :10] + 1.0  # same image-0 cells again
        kp1[:, 25:30] = kp1[:, 30:35]  # same image-1 cells, later rows
        mask = rng.random((B, G)) < 0.8
        ref = jax_supervision_coarse(*map(jnp.asarray, (kp0, kp1, mask)), grid, grid, 8)
        got = compute_supervision_coarse(_t(kp0), _t(kp1), _t(mask), grid, grid, 8, dense=True)
        for name in ("conf_matrix_gt", "spv_i_ids", "spv_j_ids", "spv_mask", "fine_mtx_0",
                     "fine_mtx_1"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)
        assert compute_supervision_coarse(_t(kp0), _t(kp1), _t(mask), grid, grid, 8).conf_matrix_gt is None
        ids = rng.integers(0, 48, (B, 16))
        r0, r1 = jax_supervision_fine(ref.fine_mtx_0, ref.fine_mtx_1, jnp.asarray(ids), jnp.asarray(ids))
        g0, g1 = compute_supervision_fine(got.fine_mtx_0, got.fine_mtx_1, _t(ids), _t(ids))
        np.testing.assert_array_equal(g0.numpy(), np.asarray(r0))
        np.testing.assert_array_equal(g1.numpy(), np.asarray(r1))


class TestEntryPoints:
    def test_config_from_the_jax_config(self):
        assert config_from_dict(Config, dataclasses.asdict(jax_default_config())) == Config()

    @pytest.mark.parametrize("part,field,value", [
        (None, "coarse_only", True), (None, "positional_encoding", True),
        ("swin", "qkv_bias", False), ("fine", "concat_coarse_feat", False),
        (None, "no_such_field", 1),
    ])
    def test_config_refuses_fields_it_does_not_hold(self, part, field, value):
        """A JAX field the port does not hold converts only at its JAX
        default: another value would build another model. A field it neither
        holds nor ignores (`IGNORED_JAX_FIELDS`) raises at any value; one it
        holds (`HELD`) converts to the port's own field."""
        d = dataclasses.asdict(jax_default_config())
        (d["model"] if part is None else d["model"][part])[field] = value
        if field in HELD:
            got = config_from_dict(Config, d).model
            assert getattr(got if part is None else getattr(got, part), field) == value
            return
        path = "model." + (f"{part}." if part else "") + field
        with pytest.raises(ValueError, match=path.replace(".", r"\.")):
            config_from_dict(Config, d)

    @pytest.mark.parametrize("part,field,value", [
        (None, "coarse_only", True), ("swin", "qkv_bias", False),
        ("fine", "concat_coarse_feat", False),
    ])
    def test_sub_config_refuses_at_its_place_in_config(self, part, field, value):
        """A sub-config converted alone finds its dotted path in Config from
        the type hints: the error names the field as a whole Config would; a
        field the port holds (`HELD`) converts to its own."""
        from featurematching_tpu_torch.config import FineMatchConfig, ModelConfig, SwinConfig

        m = jax_default_config().model
        jax_part = m if part is None else getattr(m, part)
        cls = {None: ModelConfig, "swin": SwinConfig, "fine": FineMatchConfig}[part]
        d = dataclasses.asdict(dataclasses.replace(jax_part, **{field: value}))
        if field in HELD:
            assert getattr(config_from_dict(cls, d), field) == value
        else:
            path = "model." + (f"{part}." if part else "") + field
            with pytest.raises(ValueError, match=path.replace(".", r"\.")):
                config_from_dict(cls, d)
        assert config_from_dict(cls, dataclasses.asdict(jax_part)) == cls()

    def test_config_allows_fields_that_do_not_change_the_math(self):
        """The allow-list (pose and data settings) converts; fused_attention,
        which selects the per-op block's attention kernel, converts to the
        port's own field."""
        from featurematching_tpu.config import tpu_optimized_config

        from featurematching_tpu_torch.config import IGNORED_JAX_FIELDS

        jc = jax_default_config()
        m = jc.model
        jc = dataclasses.replace(jc, model=dataclasses.replace(
            m, swin=dataclasses.replace(m.swin, fused_attention="off"),
            pose=dataclasses.replace(m.pose, nhead=4),
            loss=dataclasses.replace(m.loss, fine_correct_thr=3.0)))
        port = config_from_dict(Config, dataclasses.asdict(jc))
        assert port == dataclasses.replace(Config(), model=dataclasses.replace(
            Config().model, swin=dataclasses.replace(Config().model.swin, fused_attention="off")))
        assert "model.swin.fused_attention" not in IGNORED_JAX_FIELDS  # the port holds it
        port = config_from_dict(Config, dataclasses.asdict(tpu_optimized_config()))
        assert (port.model.coarse.nhead, port.model.fine.nhead) == (4, 1)

    def test_tpu_optimized_config_is_the_jax_packages(self):
        """The port's copy of the head-dim-64 profile converts from and equals
        the JAX package's."""
        from featurematching_tpu.config import tpu_optimized_config as jax_tpu_optimized_config

        from featurematching_tpu_torch.config import tpu_optimized_config

        assert config_from_dict(Config, dataclasses.asdict(jax_tpu_optimized_config())) == (
            tpu_optimized_config())

    def test_default_device_is_cuda_and_raises_without_it(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_train_state(Config())

    @pytest.mark.parametrize("part,field,value,match", [
        ("pose", "flag", "old", "pose heads"),
    ])
    def test_forms_not_ported_raise(self, part, field, value, match):
        """The pose heads are not ported."""
        cfg = config_from_dict(Config, dataclasses.asdict(_small_jax_config())).model
        cfg = dataclasses.replace(cfg, **{part: dataclasses.replace(getattr(cfg, part),
                                                                     **{field: value})})
        with pytest.raises(NotImplementedError, match=match):
            Matcher(cfg, device="cpu")

    @pytest.mark.parametrize("value", ["off", "auto"])
    def test_per_op_swin_block_runs_on_the_cpu(self, monkeypatch, value):
        """swin.fused_block 'off', and 'auto' on the CPU, build the Matcher
        and run every block in the per-op form, with no K8 call."""
        import featurematching_tpu_torch.models.backbone_swin as bs

        cfg = config_from_dict(Config, dataclasses.asdict(_small_jax_config())).model
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, fused_block=value))
        model = Matcher(cfg, device="cpu")
        per_op, k8 = [], []
        block = bs.SwinUNet._block_per_op
        monkeypatch.setattr(bs.SwinUNet, "_block_per_op",
                            lambda *a, **k: per_op.append(1) or block(*a, **k))
        monkeypatch.setattr(bs, "swin_block_train", lambda *a: k8.append(1))
        img = torch.rand(1, 64, 64, 3)
        with torch.no_grad():
            out = model(img, img)
        assert (len(per_op), len(k8)) == (6, 0)
        assert torch.isfinite(out.feat_c0).all()


    @pytest.mark.parametrize("value,k9", [("on", True), ("auto", False), ("off", False)])
    def test_coarse_fused_train_selects_k9(self, monkeypatch, value, k9):
        """'on' takes K9's path (its plain twin on the CPU) and runs no eager
        coarse EncoderLayer; 'auto' and 'off' run the per-op stack here."""
        import featurematching_tpu_torch.ops.coarse_transformer_train as ctt

        cfg = config_from_dict(Config, dataclasses.asdict(_small_jax_config())).model
        cfg = dataclasses.replace(cfg, coarse=dataclasses.replace(cfg.coarse, fused_train=value))
        model = Matcher(cfg, device="cpu")
        twin, eager = [], []
        ref = ctt.coarse_layer_backward_reference
        monkeypatch.setattr(ctt, "coarse_layer_backward_reference",
                            lambda *a: twin.append(1) or ref(*a))
        for layer in model.coarse_transformer.children():
            layer.register_forward_hook(lambda *_: eager.append(1))
        f = torch.rand(1, 64, cfg.coarse.d_model, requires_grad=True)
        a, b = model.coarse_transformer(f, f * 0.5)
        (a.sum() + b.sum()).backward()
        assert model.coarse_transformer.use_fused_train == k9
        assert (len(twin), len(eager)) == ((3, 0) if k9 else (0, 3))

    @pytest.mark.parametrize("value,k10", [("on", True), ("auto", False), ("off", False)])
    def test_fine_fused_train_selects_k10(self, monkeypatch, value, k10):
        """'on' takes K10's path (its plain twin on the CPU) and runs no eager
        fine EncoderLayer; 'auto' and 'off' run the per-op stack here."""
        import featurematching_tpu_torch.ops.fine_transformer_train as ftt

        cfg = config_from_dict(Config, dataclasses.asdict(_small_jax_config())).model
        cfg = dataclasses.replace(cfg, fine=dataclasses.replace(cfg.fine, fused_train=value))
        model = Matcher(cfg, device="cpu")
        twin, eager = [], []
        ref = ftt.fine_layer_backward_reference
        monkeypatch.setattr(ftt, "fine_layer_backward_reference",
                            lambda *a: twin.append(1) or ref(*a))
        for layer in model.fine_transformer.children():
            layer.register_forward_hook(lambda *_: eager.append(1))
        f = torch.rand(3, 49, cfg.fine.d_model, requires_grad=True)
        a, b = model.fine_transformer(f, f * 0.5)
        (a.sum() + b.sum()).backward()
        assert model.fine_transformer.use_fused_train == k10
        assert (len(twin), len(eager)) == ((3, 0) if k10 else (0, 3))


class TestFineGather:
    def test_gradient_reaches_the_fine_map(self, rng):
        """Autograd of the window gather (taps outside the map read zeros,
        windows overlap) equals the JAX package's custom VJP."""
        B, hc, wc, C = 2, 6, 8, 4
        feat = rng.standard_normal((B, hc * 4, wc * 4, C)).astype(np.float32)
        ids = np.array([[0, 7, 40, 47, 21, 22], [5, 42, 0, 13, 30, 30]], np.int32)
        g = rng.standard_normal((B, 6, 49, C)).astype(np.float32)
        _, vjp = jax.vjp(lambda f: jax_gather_fine_windows(f, jnp.asarray(ids), (hc, wc), 7, 4),
                         jnp.asarray(feat))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
        t = _t(feat).requires_grad_()
        gather_fine_windows(t, _t(ids).long(), (hc, wc), 7, 4).backward(_t(g))
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-6, atol=1e-6)


class TestLosses:
    @pytest.mark.parametrize("coarse_type,sparse", [("focal", True), ("focal", False),
                                                    ("cross_entropy", False)])
    def test_coarse_loss(self, rng, coarse_type, sparse):
        conf = rng.random((2, 12, 10)).astype(np.float32) * 0.2
        conf_gt = (rng.random((2, 12, 10)) < 0.1).astype(np.float32)
        jcfg = dataclasses.replace(jax_default_config().model.loss, coarse_type=coarse_type,
                                   sparse_spvs=sparse, neg_weight=0.7)
        cfg = config_from_dict(LossConfig, dataclasses.asdict(jcfg))
        ref = jax_coarse_loss(jnp.asarray(conf), jnp.asarray(conf_gt), jcfg)
        np.testing.assert_allclose(float(compute_coarse_loss(_t(conf), _t(conf_gt), cfg)),
                                   float(ref), rtol=1e-6)

    def test_fine_loss_and_its_gradient(self, rng):
        B, G = 2, 16
        mk0 = rng.uniform(0, 60, (B, G, 3)).astype(np.float32)
        mk1 = rng.uniform(0, 60, (B, G, 3)).astype(np.float32)
        gt0 = rng.uniform(0, 60, (B, G, 2)).astype(np.float32)
        gt1 = rng.uniform(0, 60, (B, G, 2)).astype(np.float32)
        gt0[:, :3, 0] = 0.0  # rows without GT
        mask = rng.random((B, G)) < 0.7
        args = (gt0, gt1, mask)
        ref, ref_g = jax.value_and_grad(jax_fine_loss, argnums=(0, 1))(
            jnp.asarray(mk0), jnp.asarray(mk1), *map(jnp.asarray, args))
        a, b = _t(mk0).requires_grad_(), _t(mk1).requires_grad_()
        got = compute_fine_loss(a, b, *map(_t, args))
        got.backward()
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref_g[0]), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(ref_g[1]), rtol=1e-5, atol=1e-9)


class TestOptimizer:
    @pytest.mark.parametrize("kw", [
        dict(scheduler="multistep", warmup_type="linear", warmup_ratio=0.1, warmup_steps=5),
        dict(scheduler="cosine", warmup_type="constant", warmup_ratio=0.5, warmup_steps=3),
        dict(scheduler="exponential", warmup_steps=0),
    ])
    def test_lr_schedule(self, kw):
        jcfg = dataclasses.replace(JaxOptimizerConfig(), mslr_milestones=(1, 2), cosa_tmax=2, **kw)
        ref = jax_lr_schedule(jcfg, 8, 10)
        got = build_lr_schedule(config_from_dict(OptimizerConfig, dataclasses.asdict(jcfg)), 8, 10)
        for step in range(0, 30):
            # the JAX schedule computes in f32, the port's in f64
            np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-5, err_msg=str(step))

    @pytest.mark.parametrize("name,clip", [("adamw", 0.5), ("adam", 0.5), ("adamw", 0.0)])
    def test_three_updates_against_optax(self, rng, name, clip):
        """The clip (scaled only where the norm reaches max_norm) and the
        moments; the first gradient is below the clip, the others above."""
        jcfg = dataclasses.replace(JaxOptimizerConfig(), name=name, gradient_clipping=clip,
                                   warmup_steps=2, warmup_ratio=0.1, adam_decay=0.01)
        params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal(5).astype(np.float32)}
        grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
                 for s in (0.05, 1.0, 3.0)]
        tx = jax_build_optimizer(jcfg, 16, 10)
        jp, st = jax.tree.map(jnp.asarray, params), None
        st = tx.init(jp)
        tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
        opt = build_optimizer(tp.values(), config_from_dict(OptimizerConfig, dataclasses.asdict(jcfg)),
                              16, 10)
        for g in grads:
            upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
            jp = optax.apply_updates(jp, upd)
            for k, p in tp.items():
                p.grad = _t(g[k])
            norm = opt.step()
            np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
            for k, p in tp.items():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                           atol=1e-7, err_msg=k)


class TestDropPath:
    def test_rates_follow_the_jax_slices(self):
        enc, dec = drop_path_rates((2, 2, 6), (1, 1, 1), 0.2)
        dpr = np.linspace(0, 0.2, 10)
        assert enc == [[dpr[0], dpr[1]], [dpr[2], dpr[3]], list(dpr[4:10])]
        assert dec == [[dpr[2]], [dpr[1]], [dpr[0]]]
        assert drop_path_rates((2, 2, 6), (2, 2, 2), 0.2)[1] == [[dpr[4], dpr[5]], [dpr[2], dpr[3]],
                                                                 [dpr[0], dpr[1]]]

    def test_scales_per_image_from_the_models_generator(self, monkeypatch):
        """Each block's two scales are drawn per image (0 or 1/keep), the
        same for every window of that image, from the Matcher's generator:
        a second model with the same seed draws the same masks."""
        cfg = config_from_dict(Config, dataclasses.asdict(_small_jax_config()))
        model_cfg = dataclasses.replace(
            cfg.model, swin=dataclasses.replace(cfg.model.swin, drop_path_rate=0.5))
        seen = []

        def spy(x, mask, s1, s2, params, heads):
            seen.append((x.shape[0], s1, s2))
            return x

        import featurematching_tpu_torch.models.backbone_swin as bs
        monkeypatch.setattr(bs, "swin_block_train", spy)
        imgs = torch.rand(6, 64, 64, 3)
        runs = []
        for _ in range(2):
            seen.clear()
            m = Matcher(model_cfg, device="cpu", seed=5)
            m.backbone(imgs, train=True, generator=m.generator)
            runs.append(list(seen))
        for (_, s1, s2), (_, r1, r2) in zip(*runs):
            assert (s1 is None and r1 is None) or (torch.equal(s1, r1) and torch.equal(s2, r2))
        nwin, s1, s2 = runs[0][2]  # enc2: rate 0.5, keep 0.5, 6 images x 1 window
        assert nwin == 6 * 1
        for s in (s1, s2):
            assert set(s.tolist()) <= {0.0, 2.0}
        nwin, s1, s2 = runs[0][1]  # enc1: rate 0.25, 4 windows an image
        per_image = s1.reshape(6, 4)
        assert (per_image == per_image[:, :1]).all()
        assert set(s1.tolist()) <= {0.0, float(np.float32(1) / np.float32(0.75))}
        assert runs[0][0][1] is None  # enc0: rate 0, no scales
        m = Matcher(model_cfg, device="cpu", seed=5)
        seen.clear()
        m.backbone(imgs, train=False)
        assert all(s1 is None for _, s1, _ in seen)
