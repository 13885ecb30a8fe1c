"""The port's training and evaluation steps under dense supervision against
the JAX package's.

Dense supervision is the conf-matrix loss: `loss.sparse_spvs=False` with the
focal loss, or `coarse_type='cross_entropy'`. There the Matcher forms the
conf matrix at the JAX rounding points and takes its matches from it, as the
JAX Matcher does, and runs no K1. At float32 on the CPU, on the small Swin
configuration of `tests/test_torch_train.py` (the Pallas Swin block in
interpret mode on the JAX side, its plain twin on the port's) and the same
`Matcher.init` weights carried across by `load_jax_params`: the loss and
every gradient leaf within 3e-4 of the leaf's max, one `train_step`'s
metrics and updated parameters against `make_train_step`, and `eval_step`
against `make_eval_step` with thr lowered on both sides (match sets equal
over the masked slots, at least 8 valid, the conf matrix within 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_train import GRAD_RTOL, _leaves, _small_jax_config, assert_step_matches

from featurematching_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from featurematching_tpu.models.matcher import Matcher as JaxMatcher
from featurematching_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from featurematching_tpu.train.step import _forward_with_loss as jax_forward_with_loss
from featurematching_tpu.train.step import create_train_state as jax_create_train_state
from featurematching_tpu.train.step import make_eval_step, make_train_step
from featurematching_tpu_torch.config import Config, config_from_dict
from featurematching_tpu_torch.matching import coarse as port_coarse
from featurematching_tpu_torch.train.step import create_train_state, eval_step, forward_with_loss
from featurematching_tpu_torch.utils.weights import load_jax_params, to_jax_tree

CONF_ATOL = 1e-5
# evaluation at a threshold random weights pass and no border (on the 8x8
# grid border_rm 2 leaves 16 cells, where random weights find about one match)
EVAL_MATCH = dict(thr=1e-6, border_rm=0)


def _dense_config(jc, coarse_type):
    m = jc.model
    loss = dataclasses.replace(m.loss, sparse_spvs=False, coarse_type=coarse_type)
    return dataclasses.replace(jc, model=dataclasses.replace(m, loss=loss))


def _eval_config(jc):
    m = jc.model
    return dataclasses.replace(jc, model=dataclasses.replace(
        m, match_coarse=dataclasses.replace(m.match_coarse, **EVAL_MATCH)))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX train state of the small configuration: its weights and
    optimizer state do not depend on the loss, so both loss kinds share it."""
    jc = _small_jax_config()
    batch = jax_synthetic_batch(np.random.default_rng(0), batch_size=2, image_size=(64, 64),
                                num_gt=32)
    jb = jax.tree.map(jnp.asarray, batch)
    tx = jax_build_optimizer(jc.trainer.optimizer, 2, jc.trainer.steps_per_epoch)
    _, state = jax_create_train_state(jc, tx, jax.random.PRNGKey(0), jb)
    return jc, batch, jb, state


@pytest.fixture(scope="module", params=["focal", "cross_entropy"])
def dense_setup(request, jax_init):
    """The JAX gradients, one `make_train_step` step and (focal) a
    `make_eval_step` after it, in one jit a loss kind."""
    jc, batch, jb, state = jax_init
    jc = _dense_config(jc, request.param)
    ec = _eval_config(jc)
    model = JaxMatcher(jc.model)
    train = make_train_step(model, jc)
    evaluate = make_eval_step(JaxMatcher(ec.model), ec)

    @jax.jit
    def run(state, jb):
        def loss_fn(params):
            losses, _, _ = jax_forward_with_loss(model, jc, params, state.batch_stats, jb, None,
                                                 True)
            return losses.loss

        grads = jax.grad(loss_fn)(state.params)
        new_state, metrics = train(state, jb, jax.random.PRNGKey(1))
        if request.param == "cross_entropy":  # test_dense_eval_step takes the focal setup
            return grads, new_state.params, metrics, None, None
        out, losses = evaluate(new_state, jb)
        return grads, new_state.params, metrics, out, losses

    grads, new_params, metrics, out, losses = run(state, jb)
    return dict(cfg=jc, eval_cfg=ec, batch=batch, params=state.params, grads=grads,
                new_params=new_params, metrics=metrics, eval_out=out, eval_losses=losses)


def _port_state(setup, cfg):
    state = create_train_state(config_from_dict(Config, dataclasses.asdict(cfg)), device="cpu",
                               seed=0, global_batch_size=2)
    load_jax_params(state.model, setup["params"])
    return state


@pytest.fixture
def no_k1(monkeypatch):
    """K1 (its plain twin on the CPU) raises where the step would call it."""
    def refuse(*_, **__):
        raise AssertionError("the dense path launched dual_softmax_match_stats")

    monkeypatch.setattr(port_coarse, "dual_softmax_match_stats", refuse)


def test_dense_loss_and_every_gradient_leaf(dense_setup, no_k1):
    state = _port_state(dense_setup, dense_setup["cfg"])
    losses, out = forward_with_loss(state.model, state.cfg, dense_setup["batch"], train=True)
    assert out.conf_matrix is not None
    losses.loss.backward()
    np.testing.assert_allclose(float(losses.loss.detach()), float(dense_setup["metrics"]["loss"]),
                               rtol=GRAD_RTOL)
    got = _leaves(to_jax_tree(state.model, grads=True))
    ref = _leaves(dense_setup["grads"])
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert np.abs(got[k] - r).max() <= GRAD_RTOL * np.abs(r).max() + 1e-9, k


def test_dense_step_metrics_and_updated_parameters(dense_setup, no_k1):
    """loss, loss_c, loss_f and grad_norm within 3e-4; the updated
    parameters within the tolerance `test_torch_train.py`'s
    `test_metrics_and_updated_parameters` derives (3e-4 of each leaf's max
    plus the gradient tolerance carried through Adam's first step)."""
    assert_step_matches(_port_state(dense_setup, dense_setup["cfg"]), dense_setup)


@pytest.mark.parametrize("dense_setup", ["focal"], indirect=True)
def test_dense_eval_step(dense_setup, no_k1):
    """Matches from the conf matrix, as `make_eval_step`'s: the same match
    sets over the masked slots (at least 8 of the batch's slots valid), the
    conf matrix within 1e-5 and the losses within 3e-4."""
    state = _port_state(dense_setup, dense_setup["eval_cfg"])
    load_jax_params(state.model, dense_setup["new_params"])
    out, losses = eval_step(state, dense_setup["batch"])
    ref, ref_losses = dense_setup["eval_out"], dense_setup["eval_losses"]
    np.testing.assert_allclose(out.conf_matrix.numpy(), np.asarray(ref.conf_matrix), rtol=0,
                               atol=CONF_ATOL)
    m = out.coarse.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(ref.coarse.mask))
    assert m.sum() >= 8
    for name in ("i_ids", "j_ids"):
        np.testing.assert_array_equal(getattr(out.coarse, name).numpy()[m],
                                      np.asarray(getattr(ref.coarse, name))[m], err_msg=name)
    np.testing.assert_allclose(out.coarse.mconf.numpy()[m], np.asarray(ref.coarse.mconf)[m],
                               rtol=0, atol=CONF_ATOL)
    np.testing.assert_allclose(out.fine.mkpts0_f.numpy()[m], np.asarray(ref.fine.mkpts0_f)[m],
                               atol=1e-3, rtol=1e-4)
    for k in ("loss", "loss_c", "loss_f"):
        np.testing.assert_allclose(float(getattr(losses, k)), float(getattr(ref_losses, k)),
                                   rtol=GRAD_RTOL, err_msg=k)
