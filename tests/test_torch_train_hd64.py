"""The port's training step at a shallow tpu_optimized_config() against the
JAX package's.

tpu_optimized_config() trains at head dim 64 throughout (Swin heads 1/2/4
over widths 64/128/256, coarse 256 with 4 heads, fine 64 with one head). At
float32 on the CPU, with a batch made by numpy from a seed and the same
`Matcher.init` weights carried across by `load_jax_params`: the loss and
every gradient leaf of the port's step, with `swin.fused_block`,
`coarse.fused_train` and `fine.fused_train` 'on' (K8's, K9's and K10's plain
twins at head dim 64), against JAX autodiff of its per-op model (embed 64,
depths 1/1/1 and 1/1/1, window 4, two coarse layers, 64x64, batch 1,
drop-path 0), within 3e-4 of each leaf's max.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from featurematching_tpu.config import tpu_optimized_config as jax_tpu_optimized_config
from featurematching_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from featurematching_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from featurematching_tpu.train.step import _forward_with_loss as jax_forward_with_loss
from featurematching_tpu.train.step import create_train_state as jax_create_train_state
from featurematching_tpu_torch.config import Config, config_from_dict
from featurematching_tpu_torch.train.step import create_train_state, forward_with_loss
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree

GRAD_RTOL = 3e-4  # ROADMAP's per-leaf gradient tolerance at f32


def _jax_config():
    cfg = jax_tpu_optimized_config()
    m = cfg.model
    model = dataclasses.replace(
        m, compute_dtype="float32",
        swin=dataclasses.replace(m.swin, embed_dim=64, depths=(1, 1, 1), depths_up=(1, 1, 1),
                                 window_size=4, fused_block="off", drop_path_rate=0.0),
        coarse=dataclasses.replace(m.coarse, fused_train="off", layer_names=("self", "cross")),
        fine=dataclasses.replace(m.fine, fused_train="off"),
        match_coarse=dataclasses.replace(m.match_coarse, max_matches=32, max_gt_matches=32),
    )
    opt = dataclasses.replace(cfg.trainer.optimizer, warmup_steps=0)
    return dataclasses.replace(cfg, model=model,
                               trainer=dataclasses.replace(cfg.trainer, batch_size=1, optimizer=opt))


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_step():
    jc = _jax_config()
    heads = (jc.model.swin.num_heads, jc.model.coarse.nhead, jc.model.fine.nhead)
    assert heads == ((1, 2, 4), 4, 1)
    batch = jax_synthetic_batch(np.random.default_rng(0), batch_size=1, image_size=(64, 64),
                                num_gt=32)
    jb = jax.tree.map(jnp.asarray, batch)
    tx = jax_build_optimizer(jc.trainer.optimizer, 1, jc.trainer.steps_per_epoch)
    model, state = jax_create_train_state(jc, tx, jax.random.PRNGKey(0), jb)

    def loss_fn(params):
        losses, _, _ = jax_forward_with_loss(model, jc, params, state.batch_stats, jb, None, True)
        return losses.loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    return dict(cfg=jc, batch=batch, params=state.params, loss=float(loss), grads=grads)


def test_step_at_head_dim_64_matches_jax(jax_step, monkeypatch):
    """The port's loss and every gradient leaf through K8's, K9's and K10's
    plain twins at head dim 64 against the JAX step's: the same math at
    f32."""
    import featurematching_tpu_torch.ops.coarse_transformer_train as ctt
    import featurematching_tpu_torch.ops.fine_transformer_train as ftt
    import featurematching_tpu_torch.ops.swin_block_train as sbt

    calls = {"k8": [], "k9": [], "k10": []}
    for mod, name, key in ((sbt, "swin_block_train_reference", "k8"),
                           (ctt, "coarse_layer_backward_reference", "k9"),
                           (ftt, "fine_layer_backward_reference", "k10")):
        twin = getattr(mod, name)

        def spy(*a, twin=twin, key=key):
            calls[key].append(a[-1])  # the heads
            return twin(*a)

        monkeypatch.setattr(mod, name, spy)
    pc = config_from_dict(Config, dataclasses.asdict(jax_step["cfg"]))
    m = pc.model
    m = dataclasses.replace(m, swin=dataclasses.replace(m.swin, fused_block="on"),
                            coarse=dataclasses.replace(m.coarse, fused_train="on"),
                            fine=dataclasses.replace(m.fine, fused_train="on"))
    state = create_train_state(dataclasses.replace(pc, model=m), device="cpu", seed=0,
                               global_batch_size=1)
    load_jax_params(state.model, jax_step["params"])
    losses, _ = forward_with_loss(state.model, state.cfg, jax_step["batch"], train=True)
    losses.loss.backward()
    # 6 Swin blocks (1, 2 and 4 heads of 64), a self and a cross layer's two
    # K9 calls (4 heads), and K10's likewise (one head)
    assert sorted(calls["k8"]) == [1, 1, 2, 2, 4, 4]
    assert calls["k9"] == [4, 4, 4] and calls["k10"] == [1, 1, 1]
    np.testing.assert_allclose(float(losses.loss.detach()), jax_step["loss"], rtol=GRAD_RTOL)
    got = _leaves(to_jax_tree(state.model, grads=True))
    ref = _leaves(jax_step["grads"])
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert np.abs(got[k] - r).max() <= GRAD_RTOL * np.abs(r).max() + 1e-9, k
