"""dffx_torch's DFFNet against dffx's: parameters, blocks and the whole eval
forward, fp32 on the CPU, plus the port's own serving utilities.

The same numpy parameters and inputs go through ``dffx`` (JAX, NDHWC) and the
port (torch, NCDHW inside, the JAX layout at ``Network.forward``).  Blocks are
held at atol 2e-5; whole-network heads at 1e-4, because conv summation orders
differ over the whole net and the heads are distances of a few units (the JAX
package holds itself to 2e-4 against torch, test_model_parity.py)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from dffx import checkpoint as jckpt
from dffx.models import Ctx, dffnet_apply, init_params as jinit, network_specs
from dffx.models import dffnet as jdff
from dffx.models import layers as jlayers
from dffx_torch.checkpoint import load_jax_params, load_torch_checkpoint
from dffx_torch.eval import TimedForward, load_params_auto
from dffx_torch.models import Network, init_params
from dffx_torch.ops import kernels as tk

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "forward_v1.npz")


def _t(x_ndhwc):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_ndhwc).transpose(0, 4, 1, 2, 3)))


def _np(y):
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


@pytest.fixture(scope="module")
def params():
    """dffx init (seed 3) with every BN given non-trivial running statistics."""
    rng = np.random.default_rng(1)
    p = {k: np.asarray(v) for k, v in jinit(network_specs(), seed=3).items()}
    for k, v in p.items():
        if k.endswith((".bias", ".running_mean")) and v.ndim == 1:
            p[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        elif k.endswith((".weight", ".running_var")) and v.ndim == 1:
            p[k] = (rng.random(v.shape) + 0.5).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def net(params):
    return load_jax_params(Network(), params).eval()


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def test_init_params_bit_equal_to_dffx():
    for seed in (0, 7):
        got, ref = init_params(seed), jinit(network_specs(), seed=seed)
        assert set(got) == set(ref)
        for k in ref:
            r = np.asarray(ref[k])
            assert got[k].dtype == (np.int64 if k.endswith("num_batches_tracked") else np.float32)
            np.testing.assert_array_equal(got[k], r.astype(got[k].dtype), err_msg=k)
    assert len(init_params(0)) == 384


def test_load_jax_params_equals_torch_state_dict_route(params):
    a = load_jax_params(Network(), params).state_dict()
    b = Network()
    b.load_state_dict({k: torch.from_numpy(np.array(v, order="C"))
                       for k, v in jckpt.to_torch_state_dict(params, network_specs()).items()})
    b = b.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    assert a["DFF_net.FM_measure.Focus_extraction.0.1.num_batches_tracked"].dtype == torch.int64


def test_load_jax_params_rejects_key_mismatch(params):
    bad = dict(params)
    bad.pop("DFF_net.dres4.pre_conv.0.0.weight")
    bad["DFF_net.extra.weight"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="1 missing.*1 extra"):
        load_jax_params(Network(), bad)


def _jp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def test_fm_module_matches(net, params, rng):
    x = rng.uniform(-1, 1, (1, 2, 32, 64, 3)).astype(np.float32)
    ref = jlayers.fm_module_apply(_jp(params), "DFF_net.FM_measure", jnp.asarray(x), Ctx())
    with torch.no_grad():
        got = net.DFF_net.FM_measure(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("pfx,c", [("FM_conv1.1", 16), ("FM_conv2.1", 32)])
def test_srd_matches(net, params, rng, pfx, c):
    x = rng.uniform(-1, 1, (1, 3, 16, 32, c)).astype(np.float32)
    ref = jlayers.srd_apply(_jp(params), f"DFF_net.{pfx}", jnp.asarray(x), Ctx())
    with torch.no_grad():
        got = net.DFF_net.get_submodule(pfx)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("pfx,c", [("FM_conv1.0", 8), ("FM_conv2.0", 16)])
def test_efd_matches(net, params, rng, pfx, c):
    x = rng.uniform(-1, 1, (1, 3, 32, 32, c)).astype(np.float32)
    ref = jlayers.efd_apply(_jp(params), f"DFF_net.{pfx}", jnp.asarray(x), Ctx())
    with torch.no_grad():
        got = net.DFF_net.get_submodule(pfx)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("skips", [False, True])
def test_hourglass_matches(net, params, rng, skips):
    c, n, h, w = 16, 3, 16, 32
    x = rng.uniform(-1, 1, (1, n, h, w, 2 * c)).astype(np.float32)
    pre = post = None
    if skips:
        pre = rng.uniform(-1, 1, (1, n, h // 2, w // 2, 2 * c)).astype(np.float32)
        post = rng.uniform(-1, 1, (1, n, h // 2, w // 2, 2 * c)).astype(np.float32)
    jpre, jpost = (None if a is None else jnp.asarray(a) for a in (pre, post))
    ref_out, ref_pre = jdff.hourglass_apply(_jp(params), "DFF_net.dres3", jnp.asarray(x),
                                            jpre, jpost, Ctx())
    tpre, tpost = (None if a is None else _t(a) for a in (pre, post))
    with torch.no_grad():
        out, pre_1 = net.DFF_net.dres3(_t(x), tpre, tpost)
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), atol=2e-5)
    np.testing.assert_allclose(_np(pre_1), np.asarray(ref_pre), atol=2e-5)


def test_hourglassup_matches(net, params, rng):
    x = rng.uniform(-1, 1, (1, 2, 16, 32, 32)).astype(np.float32)
    ref = jdff.hourglassup_apply(_jp(params), "DFF_net.SPP_module", jnp.asarray(x), Ctx())
    with torch.no_grad():
        got = net.DFF_net.SPP_module(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_network_forward_matches_dffnet_apply(interpret_pallas, net, params, rng, use_pallas):
    fs = rng.uniform(-1, 1, (1, 5, 64, 128, 3)).astype(np.float32)
    fd = np.linspace(0.1, 1.5, 5, dtype=np.float32)[None]
    ref = dffnet_apply(_jp(params), jnp.asarray(fs), jnp.asarray(fd), Ctx(use_pallas=use_pallas))
    tk.reset_launches()
    with torch.no_grad():
        got = net(torch.from_numpy(fs), torch.from_numpy(fd))
    assert tk.launches == dict.fromkeys(tk.launches, 0)  # CPU: the twins ran
    for g, r, name in zip(got, ref, ["mid", "pred1", "pred2", "pred3"]):
        assert tuple(g.shape) == (1, 64, 128), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=name)


def golden_inputs():
    """Inputs and seed exactly as tests/test_golden_regression.py builds them."""
    rng = np.random.default_rng(42)
    fs = rng.uniform(-1, 1, (1, 10, 64, 96, 3)).astype(np.float32)
    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    return fs, fd


def test_forward_matches_stored_goldens():
    fs, fd = golden_inputs()
    net = load_params_auto(7, device="cpu")
    with torch.no_grad():
        mid, _, _, pred3 = net(torch.from_numpy(fs), torch.from_numpy(fd))
    ref = np.load(GOLDEN)
    np.testing.assert_allclose(mid.numpy(), ref["mid"], atol=1e-4)
    np.testing.assert_allclose(pred3.numpy(), ref["pred3"], atol=1e-4)


def test_forward_rejects_train_mode_and_bad_shapes():
    net = Network()  # constructed in train mode
    fs, fd = torch.zeros(1, 2, 32, 32, 3), torch.ones(1, 2)
    with pytest.raises(RuntimeError, match="eval-only"):
        net(fs, fd)
    net.eval()
    with pytest.raises(ValueError, match="multiples of 32"):
        net(torch.zeros(1, 2, 32, 40, 3), fd)
    with pytest.raises(ValueError, match=r"\(B, N, H, W, 3\)"):
        net(torch.zeros(1, 3, 2, 32, 32), fd)


def test_load_params_auto_from_pth_and_seed(tmp_path, params):
    net = load_jax_params(Network(), params)
    path = tmp_path / "check_point.pth"
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()}, path)
    assert set(load_torch_checkpoint(str(path))) == set(net.state_dict())
    loaded = load_params_auto(str(path), device="cpu")
    assert not loaded.training
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        load_params_auto(str(tmp_path / "missing.pth"), device="cpu")


def test_timed_forward_counts_samples(rng):
    net = load_params_auto(0, device="cpu")
    tf = TimedForward(net)
    fs = rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    fd = np.tile(np.linspace(0.1, 1.0, 3, dtype=np.float32), (2, 1))
    outs = tf(fs, fd)
    assert tf.count == 2 and tf.total > 0 and tf.avg_time == tf.total / 2
    with torch.no_grad():
        ref = net(torch.from_numpy(fs), torch.from_numpy(fd))
    for g, r in zip(outs, ref):
        assert torch.equal(g, r)
