"""Train-state checkpoints between the packages: a file the port writes
(``dffx_torch.checkpoint.save``) loads through ``dffx.checkpoint.load`` with a
template of ``dffx.train.create_train_state``, leaf for leaf; a file ``dffx``
writes after a step resumes in the port (``restore``) with the same
parameters, BN statistics, Adam moments and step; and a step after a round
trip in the port equals the step without it.  DFFNet at b1 2x32x32, fp32 on
the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dffx import checkpoint as jckpt
from dffx.models import init_params as jinit, network_specs
from dffx.train import LossConfig as JLossConfig
from dffx.train import create_train_state as jcreate, make_train_step as jmake
from dffx_torch import checkpoint as ckpt
from dffx_torch.checkpoint import jax_layout, load_jax_params
from dffx_torch.models import Network, init_params
from dffx_torch.train import LossConfig, create_train_state, make_train_step

LR = 1e-3


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    b, n, h, w = 1, 2, 32, 32
    return {"fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
            "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32),
            "focus_dists": np.linspace(0.1, 1.5, n, dtype=np.float32)[None],
            "mask": rng.random((b, h, w)) > 0.2}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_state(seed):
    return create_train_state(load_jax_params(Network(), init_params(seed)), LR)


def _stepped(batch, steps=1):
    state, step = _port_state(0), make_train_step(LR, LossConfig())
    for _ in range(steps):
        state, _ = step(state, _tb(batch))
    return state


def _moments(state):
    named = dict(state.model.named_parameters())
    return {slot: jax_layout(state.model, {k: state.optimizer.state[p][slot]
                                           for k, p in named.items()})
            for slot in ("exp_avg", "exp_avg_sq")}


def _template(seed=1):
    s = jcreate(jinit(network_specs(), seed=seed), LR)
    return {"step": s.step, "params": s.params, "opt_state": s.opt_state}


def test_a_port_checkpoint_loads_in_dffx_leaf_for_leaf(tmp_path, batch):
    state = _stepped(batch, steps=2)
    path = str(tmp_path / "models" / "2.ckpt")
    ckpt.save(path, state)
    template = _template()
    blob = jckpt.load(path, template=template)
    got = jax.tree_util.tree_flatten_with_path(blob)[0]
    want = jax.tree_util.tree_flatten_with_path(template)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert len(got) == 782  # step, 384 params, count, 198 + 198 moments
    for (path_, g), (_, w) in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (jax.tree_util.keystr(path_), g.dtype)
    assert int(blob["step"]) == 2
    adam = blob["opt_state"].inner_state[0]
    assert int(adam.count) == 2
    params = jax_layout(state.model, state.model.state_dict())
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(blob["params"][k]), v, err_msg=k)
    moments = _moments(state)
    for k, v in moments["exp_avg"].items():
        np.testing.assert_array_equal(np.asarray(adam.mu[k]), v, err_msg=k)
        np.testing.assert_array_equal(np.asarray(adam.nu[k]), moments["exp_avg_sq"][k], err_msg=k)
    # and dffx steps on from it
    jstate = type(jcreate(template["params"], LR))(
        step=jnp.asarray(blob["step"]), params=dict(blob["params"]),
        opt_state=jax.tree_util.tree_map(jnp.asarray, blob["opt_state"]))
    new, logs = jmake(LR, JLossConfig(), donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    assert int(new.step) == 3 and np.isfinite(float(logs["loss"]))


def test_a_dffx_checkpoint_resumes_in_the_port(tmp_path, batch):
    jstate = jcreate(jinit(network_specs(), seed=0), LR)
    jstate, _ = jmake(LR, JLossConfig(), donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    path = str(tmp_path / "1.ckpt")
    jckpt.save(path, {"step": jstate.step, "params": jstate.params,
                      "opt_state": jstate.opt_state})
    state = ckpt.restore(path, _port_state(1))
    assert state.step == 1
    params = jax_layout(state.model, state.model.state_dict())
    for k, v in jstate.params.items():
        np.testing.assert_array_equal(params[k], np.asarray(v).astype(params[k].dtype),
                                      err_msg=k)
    assert state.model.state_dict()["DFF_net.deconv_3.1.num_batches_tracked"].dtype == torch.int64
    adam = jstate.opt_state.inner_state[0]
    moments = _moments(state)
    trainable = [k for k, v in adam.mu.items() if hasattr(v, "shape")]  # else optax.MaskedNode
    assert set(moments["exp_avg"]) == set(trainable) and len(trainable) == 198
    for k in trainable:
        np.testing.assert_array_equal(moments["exp_avg"][k], np.asarray(adam.mu[k]), err_msg=k)
        np.testing.assert_array_equal(moments["exp_avg_sq"][k], np.asarray(adam.nu[k]), err_msg=k)
    assert {int(s["step"]) for s in state.optimizer.state.values()} == {int(adam.count)} == {1}


@pytest.mark.parametrize("background", [False, True], ids=["save", "save_async"])
def test_a_step_after_a_round_trip_equals_the_step_without(tmp_path, batch, background):
    state = _stepped(batch)
    path = str(tmp_path / "m" / "1.ckpt")
    if background:
        ckpt.save_async(path, state).wait()
    else:
        ckpt.save(path, state)
    assert [p.name for p in (tmp_path / "m").iterdir()] == ["1.ckpt"]  # no tmp file left
    resumed = ckpt.restore(path, _port_state(3))
    step = make_train_step(LR, LossConfig())
    state, logs = step(state, _tb(batch))
    resumed, rlogs = step(resumed, _tb(batch))
    assert resumed.step == state.step == 2
    assert float(rlogs["loss"]) == float(logs["loss"])
    a, b = state.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_restore_refuses_a_file_without_a_train_state(tmp_path):
    path = str(tmp_path / "params.ckpt")
    jckpt.save(path, jinit(network_specs(), seed=0))
    with pytest.raises(ValueError, match="holds no train state"):
        ckpt.restore(path, _port_state(0))


def test_save_refuses_parameters_at_different_adam_steps(tmp_path, batch):
    state = _stepped(batch)
    first = next(state.model.parameters())
    state.optimizer.state[first]["step"] += 1
    with pytest.raises(ValueError, match="different numbers of Adam steps"):
        ckpt.save(str(tmp_path / "x.ckpt"), state)
