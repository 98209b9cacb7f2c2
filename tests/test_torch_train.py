"""dffx_torch's train step against dffx's, fp32 on the CPU: the loss
functions, train-mode BatchNorm, DFFNet's gradients and new running
statistics, remat, Adam and the recipes.

The same numpy parameters and batch (``tests/test_train.py``'s, b2 5x32x32)
go through ``dffx.train.make_train_step`` (``debug_grads`` hands back
``jax.grad`` of its ``loss_fn``) and ``dffx_torch.train.make_train_step``; the
JAX step is compiled once per module.

The gradient bound.  A ReLU network's gradient is discontinuous: a
pre-activation within rounding of 0 that rounds to the other side in the other
framework switches a whole path on or off, and train-mode BN spreads the
change over its channel.  At this size that moves a tensor's gradient by up to
10 % of its largest element: the port's own gradient moves by 9.4 % (max over
tensors of max|dg| / max|g|) and 0.9 % (relative L2 over all gradients) when
``fs`` is perturbed by one part in 10^7, and the worst gap seen against
``jax.grad`` is 7.8 % and 1.2 %.  The port's fp32 gradient agrees with its own
float64 gradient to 4e-5, and that with central differences in float64.  So
each tensor is held to ``max|dg| <= 0.25 max|g_jax| + 1e-7`` and all of them
together to a relative L2 gap of 5 %; a wrong layout, a missing path or a
wrong loss weight moves a gradient by its own size.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dffx.models import init_params as jinit, network_specs
from dffx.ops import batch_norm_train as jbn_train
from dffx.train import LossConfig as JLossConfig
from dffx.train import create_train_state as jcreate, make_train_step as jmake
from dffx.train import loop as jloop
from dffx.train.recipes import RECIPES as JRECIPES
from dffx_torch.checkpoint import jax_layout, load_jax_params
from dffx_torch.models import Network
from dffx_torch.models.layers import BatchNorm3d
from dffx_torch.ops.norm import batch_norm_train
from dffx_torch.train import (LossConfig, conf_masked_mse, create_train_state,
                              make_train_step, masked_mse, total_loss)
from dffx_torch.train.loop import nonfinite_count
from dffx_torch.train.recipes import RECIPES

LR = 1e-3
GRAD_RTOL, GRAD_ATOL, GRAD_L2 = 0.25, 1e-7, 0.05
#: modules the reference constructs and never calls: no gradient, no BN update
UNUSED = (".pre_conv.", ".redir3.")


def make_batch(b=2, n=5, h=32, w=32):
    """``tests/test_train.py``'s batch, as numpy."""
    rng = np.random.default_rng(0)
    return {
        "fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
        "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32),
        "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32), (b, 1)),
        "mask": rng.random((b, h, w)) > 0.2,
        "conf": rng.random((b, h, w)).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_step(params, batch, *, remat=False, cls=Network):
    """One port train step from ``params``: (state, logs, grads in dffx layout)."""
    state = create_train_state(load_jax_params(cls(), params), LR)
    state, logs = make_train_step(LR, LossConfig(), remat=remat)(state, _torch_batch(batch))
    grads = jax_layout(state.model, {k: p.grad for k, p in state.model.named_parameters()})
    return state, logs, grads


def assert_grads_close(got, want):
    """Every trainable tensor within the module's bound (see the docstring);
    returns the worst per-tensor ratio max|dg| / max|g_jax| and the L2 gap."""
    assert set(got) == set(want)
    worst = 0.0
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        gap, scale = np.abs(got[k] - w).max(), np.abs(w).max()
        assert gap <= GRAD_RTOL * scale + GRAD_ATOL, (k, gap, scale)
        worst = max(worst, gap / scale if scale else 0.0)
    num = sum(float(((got[k] - np.asarray(w)) ** 2).sum()) for k, w in want.items())
    den = sum(float((np.asarray(w) ** 2).sum()) for w in want.values())
    assert num <= GRAD_L2 ** 2 * den, (num / den) ** 0.5
    return worst, (num / den) ** 0.5


@pytest.fixture(scope="module")
def batch():
    return make_batch()


@pytest.fixture(scope="module")
def params():
    return {k: np.asarray(v) for k, v in jinit(network_specs(), seed=0).items()}


@pytest.fixture(scope="module")
def jax_step(params, batch):
    """dffx's step: (new params, logs with ``grads``)."""
    step = jmake(LR, JLossConfig(), donate=False, debug_grads=True)
    state, logs = step(jcreate({k: jnp.asarray(v) for k, v in params.items()}, LR),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v) for k, v in state.params.items()}, logs


@pytest.fixture(scope="module")
def plain(params, batch):
    return port_step(params, batch)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "plain": {},
    "norm_range": {"norm_range": (-2.5, 2.5)},
    "raw_mid": {"norm_range": (10.0, 100.0), "normalize_mid": False},
    "conf_weighted": {"norm_range": (1 / 3.91092, 1 / 0.10201), "conf_weighted": True},
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_total_loss_matches_dffx(case):
    rng = np.random.default_rng(3)
    outs = [rng.uniform(0.1, 1.5, (2, 16, 24)).astype(np.float32) for _ in range(4)]
    batch = {"depth": rng.uniform(0.1, 1.5, (2, 16, 24)).astype(np.float32),
             "mask": rng.random((2, 16, 24)) > 0.3,
             "conf": rng.random((2, 16, 24)).astype(np.float32)}
    total, logs = total_loss([torch.from_numpy(o) for o in outs], _torch_batch(batch),
                             LossConfig(**LOSS_CASES[case]))
    jtotal, jlogs = jloop.total_loss(tuple(jnp.asarray(o) for o in outs),
                                     {k: jnp.asarray(v) for k, v in batch.items()},
                                     JLossConfig(**LOSS_CASES[case]))
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)


def test_masked_mse_guards_match_dffx():
    """Mean over the mask (``MSELoss(est[mask], gt[mask])``), 0 for an empty
    mask (the 1.0 guard), and the confidence-weighted form (guard 1e-12)."""
    rng = np.random.default_rng(4)
    est, gt, conf = (rng.standard_normal((2, 8, 8)).astype(np.float32) for _ in range(3))
    for mask in (rng.random((2, 8, 8)) > 0.4, np.zeros((2, 8, 8), bool)):
        got = masked_mse(*map(torch.from_numpy, (est, gt, mask)))
        want = jloop.masked_mse(*map(jnp.asarray, (est, gt, mask)))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        got = conf_masked_mse(*map(torch.from_numpy, (est, gt, conf, mask)))
        want = jloop.conf_masked_mse(*map(jnp.asarray, (est, gt, conf, mask)))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(masked_mse(*map(torch.from_numpy, (est, gt, np.zeros((2, 8, 8), bool))))) == 0


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,offset", [((2, 5, 8, 8, 16), 0.0), ((2, 5, 4, 4, 32), 3.0),
                                          ((1, 3, 1, 1, 8), 0.5)])
def test_batch_norm_train_matches_dffx(shape, offset):
    """Output, new running statistics and the gradient through the batch
    statistics; the unbiased factor counts B*N*H*W values a channel.  Both
    packages take the variance in one pass, ``E[x^2] - mean^2`` in fp32,
    which loses the digits of ``mean^2 / var`` (100 at offset 3, std 0.3):
    the bound grows with it."""
    rng = np.random.default_rng(5)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 0.3 + offset).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    mean, var = (rng.standard_normal(c) * 0.1).astype(np.float32), (rng.random(c) + 0.5).astype(
        np.float32)
    wgt, bias = (rng.random(c) + 0.5).astype(np.float32), rng.standard_normal(c).astype(np.float32)

    def f(x, w, b):
        y, nm, nv = jbn_train(x, jnp.asarray(mean), jnp.asarray(var), w, b)
        return jnp.sum(y * ct), (y, nm, nv)

    (_, (y, nm, nv)), (gx, gw, gb) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(bias))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))).requires_grad_()
    wt, bt = torch.from_numpy(wgt).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    yt, nmt, nvt = batch_norm_train(xt, torch.from_numpy(mean), torch.from_numpy(var), wt, bt)
    (yt * torch.from_numpy(np.ascontiguousarray(ct.transpose(0, 4, 1, 2, 3)))).sum().backward()
    assert not nmt.requires_grad and not nvt.requires_grad
    back = (0, 2, 3, 4, 1)
    rel = 2e-6 * (1 + offset ** 2 / 0.3 ** 2)
    for got, want in ((yt.detach().numpy().transpose(back), y), (nmt.numpy(), nm),
                      (nvt.numpy(), nv), (xt.grad.numpy().transpose(back), gx),
                      (wt.grad.numpy(), gw), (bt.grad.numpy(), gb)):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_batch_norm_module_counts_each_batch_once():
    bn = BatchNorm3d(4).train()
    x = torch.randn(2, 4, 3, 5, 5) + 2.0
    bn(x)
    n = x.numel() // 4
    xf = x.transpose(0, 1).reshape(4, -1)
    torch.testing.assert_close(bn.running_mean, 0.1 * xf.mean(1))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * xf.var(1, unbiased=False) * n / (n - 1))
    assert int(bn.num_batches_tracked) == 1
    with pytest.raises(RuntimeError, match="eval mode only"):
        bn.fused_affine()
    bn.eval()
    before = bn.running_mean.clone()
    bn(x)
    assert torch.equal(bn.running_mean, before) and int(bn.num_batches_tracked) == 1


# ---------------------------------------------------------------------------
# DFFNet's step
# ---------------------------------------------------------------------------


def test_dffnet_loss_matches_dffx(plain, jax_step):
    _, logs, _ = plain
    _, jlogs = jax_step
    for k in ("loss", "mid_loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-5, err_msg=k)


def test_dffnet_gradients_match_jax_grad(plain, jax_step):
    """Every one of the 198 trainable tensors, against ``jax.grad`` of
    ``dffx``'s ``loss_fn`` (bound: the module docstring)."""
    _, _, grads = plain
    _, jlogs = jax_step
    assert len(grads) == 198
    assert_grads_close(grads, jlogs["grads"])
    for k in ("DFF_net.dres4.pre_conv.0.0.weight", "DFF_net.SPP_module.redir3.0.weight"):
        assert not grads[k].any()  # built but unused: zero, as jax.grad gives them


def test_dffnet_new_running_stats_match_dffx(plain, jax_step):
    state, _, _ = plain
    new, _ = jax_step
    sd = state.model.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert len(stats) == 3 * 62
    for k in stats:
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == int(new[k]) == (0 if any(u in k for u in UNUSED) else 1), k
        else:
            np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_dffnet_step_updates_like_optax_on_its_gradients(plain, jax_step, params):
    """The first Adam step moves each weight by lr * g / (|g| + eps): the
    update of the port equals optax's on the port's own gradients, within two
    fp32 ulps of a weight near 1."""
    state, _, grads = plain
    opt = optax.masked(optax.adam(LR, b1=0.9, b2=0.99, eps=1e-8),
                       {k: k in grads for k in params})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    full = {k: jnp.asarray(grads[k]) if k in grads else jnp.zeros_like(v) for k, v in jp.items()}
    updates, _ = opt.update(full, opt.init(jp), jp)
    new = optax.apply_updates(jp, updates)
    got = jax_layout(state.model, dict(state.model.named_parameters()))
    for k in grads:
        np.testing.assert_allclose(got[k], np.asarray(new[k]), rtol=0, atol=2.5e-7, err_msg=k)


def test_remat_matches_plain(params, batch, plain):
    """Checkpointed stages recompute in the backward: the same loss and
    gradients, and every BN's running statistics written once."""
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
        if k.endswith("num_batches_tracked"):
            assert int(rsd[k]) == (0 if any(u in k for u in UNUSED) else 1), k


def test_training_ignores_packed(params, batch, plain):
    """``packed`` is an eval graph: a packed model trains unpacked."""
    _, logs, grads = plain
    _, plogs, pgrads = port_step(params, batch, cls=lambda: Network(packed=True))
    assert float(plogs["loss"]) == float(logs["loss"])
    for k in grads:
        np.testing.assert_array_equal(pgrads[k], grads[k], err_msg=k)


def test_sanitize_counts_nonfinite_gradients(params, batch):
    state = create_train_state(load_jax_params(Network(), params), LR)
    bad = dict(_torch_batch(batch))
    bad["depth"] = bad["depth"].clone()
    bad["depth"][0, 0, 0] = float("nan")
    _, logs = make_train_step(LR, LossConfig(), sanitize=True)(state, bad)
    assert logs["nonfinite_grads"].dtype == torch.int32
    assert int(logs["nonfinite_grads"]) > 0
    assert int(nonfinite_count([torch.tensor([1.0, float("inf"), float("nan")]),
                                torch.tensor([3])])) == 2


# ---------------------------------------------------------------------------
# Adam and the recipes
# ---------------------------------------------------------------------------


def test_adam_matches_masked_optax_over_two_steps():
    """The same gradients for two steps: torch Adam over the parameters
    against ``optax.masked(optax.adam(lr, 0.9, 0.99, 1e-8))`` over a dict that
    also holds BN statistics, which it must leave alone."""
    rng = np.random.default_rng(6)
    shapes = {"a.weight": (8, 3, 1, 3, 3), "a.bias": (8,), "bn.weight": (8,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params["bn.running_mean"] = rng.standard_normal(8).astype(np.float32)
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    mask = {k: k in shapes for k in params}
    opt = optax.masked(optax.adam(LR, b1=0.9, b2=0.99, eps=1e-8), mask)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in shapes}
    topt = torch.optim.Adam(tp.values(), lr=LR, betas=(0.9, 0.99), eps=1e-8)
    for g in grads:
        full = {k: jnp.asarray(g[k]) if k in g else jnp.zeros_like(v) for k, v in jp.items()}
        updates, jstate = opt.update(full, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    np.testing.assert_array_equal(np.asarray(jp["bn.running_mean"]), params["bn.running_mean"])
    adam = jstate.inner_state[0]
    assert int(adam.count) == 2
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        st = topt.state[p]
        assert int(st["step"]) == 2
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu[k]), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]), rtol=1e-6,
                                   atol=1e-18)


@pytest.mark.parametrize("name", sorted(JRECIPES))
def test_recipe_equals_dffx(name):
    got, want = RECIPES[name], JRECIPES[name]
    assert set(RECIPES) == set(JRECIPES)
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    for f in fields:
        if f == "loss":
            assert dataclasses.asdict(got.loss) == dataclasses.asdict(want.loss)
        else:
            assert getattr(got, f) == getattr(want, f), f
