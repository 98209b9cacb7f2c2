"""dffx_torch's end-to-end train step against dffx's, fp32 on the CPU:
FlowNetwork + DFFNet gradients against ``jax.grad`` at b1 10x32x32
(``tests/test_train.py``'s E2E batch), the new running statistics, the
alignment head's gradient through the warp, and remat.

The gradient bound is ``tests/test_torch_train.py``'s (see its docstring):
each tensor ``max|dg| <= 0.25 max|g_jax| + 1e-7``, all together a relative L2
gap of 5 %.  Here the port's own gradient moves by up to 9.4 % of a tensor's
largest element (0.9 % L2) when ``fs`` is perturbed by one part in 10^7, and
the worst gap seen against ``jax.grad`` is 9.4 % (1.3 % L2).  The warp's
interpolation matrices are the same dense form in both packages
(``dffx_torch/ops/warp.py``); they differ only where a sample lands exactly on
an integer position, where ``dffx``'s ``maximum`` splits the gradient and
``clamp`` does not: such ties appear only in the first head's warp, whose
motion is the constant ``(fovs, 0, 0)``, so no weight's gradient sees them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dffx.models import e2e_network_specs, init_params as jinit
from dffx.train import LossConfig as JLossConfig
from dffx.train import create_train_state as jcreate, make_train_step as jmake
from dffx_torch.checkpoint import jax_layout, load_jax_params
from dffx_torch.models import E2ENetwork
from dffx_torch.train import LossConfig, create_train_state, make_train_step

LR = 1e-3
GRAD_RTOL, GRAD_ATOL, GRAD_L2 = 0.25, 1e-7, 0.05
HEAD = "optical_flow_aggregation.conv1.6.weight"


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    b, n, h, w = 1, 10, 32, 32  # N must be 10: the motion heads pool to 10 vectors
    return {
        "fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
        "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32),
        "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32), (b, 1)),
        "mask": np.ones((b, h, w), bool),
        "fovs": np.tile(np.linspace(1.0, 1.02, n, dtype=np.float32), (b, 1)),
    }


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v) for k, v in jinit(e2e_network_specs(), seed=0).items()}


@pytest.fixture(scope="module")
def jax_step(params, batch):
    step = jmake(LR, JLossConfig(), e2e=True, donate=False, debug_grads=True)
    state, logs = step(jcreate({k: jnp.asarray(v) for k, v in params.items()}, LR),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v) for k, v in state.params.items()}, logs


def port_step(params, batch, *, remat=False):
    state = create_train_state(load_jax_params(E2ENetwork(), params), LR)
    step = make_train_step(LR, LossConfig(), e2e=True, remat=remat)
    state, logs = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = jax_layout(state.model, {k: p.grad for k, p in state.model.named_parameters()})
    return state, logs, grads


@pytest.fixture(scope="module")
def plain(params, batch):
    return port_step(params, batch)


def test_e2e_loss_matches_dffx(plain, jax_step):
    _, logs, _ = plain
    _, jlogs = jax_step
    for k in ("loss", "mid_loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-5, err_msg=k)


def test_e2e_gradients_match_jax_grad(plain, jax_step):
    """All 273 trainable tensors (DFFNet's 198 and FlowNetwork's 75)."""
    _, _, grads = plain
    _, jlogs = jax_step
    want = {k: np.asarray(v) for k, v in jlogs["grads"].items()}
    assert set(grads) == set(want) and len(grads) == 273
    for k, w in want.items():
        gap, scale = np.abs(grads[k] - w).max(), np.abs(w).max()
        assert gap <= GRAD_RTOL * scale + GRAD_ATOL, (k, gap, scale)
    num = sum(float(((grads[k] - w) ** 2).sum()) for k, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    assert num <= GRAD_L2 ** 2 * den, (num / den) ** 0.5


def test_alignment_head_gets_a_gradient_through_the_warp(plain, jax_step):
    """``conv1``'s last conv sits behind every warp: its gradient reaches it
    only through the interpolation matrices' dependence on the motion."""
    state, _, grads = plain
    _, jlogs = jax_step
    assert np.abs(grads[HEAD]).max() > 0
    assert np.abs(np.asarray(jlogs["grads"][HEAD])).max() > 0
    bias = grads[HEAD.replace("weight", "bias")]
    assert np.abs(bias).max() > 0


def test_e2e_new_running_stats_match_dffx(plain, jax_step):
    state, _, _ = plain
    new, _ = jax_step
    sd = state.model.state_dict()
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):  # 0 for the BNs built but never called
            assert int(v) == int(new[k]) == (0 if ".pre_conv." in k or ".redir3." in k else 1), k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_e2e_remat_matches_plain(params, batch, plain):
    """The pyramid levels and the warp + head blocks recompute in the
    backward: the same loss and gradients, each BN counted once."""
    state, logs, grads = plain
    rstate, rlogs, rgrads = port_step(params, batch, remat=True)
    assert float(rlogs["loss"]) == float(logs["loss"])
    for k in grads:
        np.testing.assert_allclose(rgrads[k], grads[k], rtol=0,
                                   atol=1e-6 * max(np.abs(grads[k]).max(), 1e-3), err_msg=k)
    sd, rsd = state.model.state_dict(), rstate.model.state_dict()
    for k in sd:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(rsd[k], sd[k]), k
