"""dffx_torch's FlowNetwork and end-to-end network against dffx's: parameters,
the warp, blocks, heads and the whole eval forward, fp32 on the CPU.

The same numpy parameters and inputs go through ``dffx`` (JAX, NDHWC) and the
port (torch, NCDHW inside, the JAX layout at the public forwards).  Ops and
blocks are held at atol 1e-5 to 2e-5; the forwards at 1e-4 on the four depth
heads and 2e-5 on ``warped`` and ``motion`` (conv summation orders differ, and
the heads are distances of a few units).  The JAX forwards are module-scoped:
one E2E forward at 1 x 10 x 64 x 96 takes seconds on the CPU."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from dffx import checkpoint as jckpt
from dffx.models import Ctx, e2e_apply, e2e_network_specs, init_params as jinit
from dffx.models import alignnet as jalign
from dffx.ops import adaptive_avg_pool_focus as jpool, affine_warp_stack as jwarp
from dffx_torch.checkpoint import load_jax_params, load_torch_checkpoint
from dffx_torch.eval import TimedForward, load_params_auto
from dffx_torch.models import E2ENetwork, e2e_init_params
from dffx_torch.ops import kernels as tk
from dffx_torch.ops.pool import adaptive_avg_pool_focus
from dffx_torch.ops.warp import affine_warp_stack

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "forward_v1.npz")
OFA = "optical_flow_aggregation"
B, N, H, W = 1, 10, 64, 96


def _t(x_ndhwc):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_ndhwc).transpose(0, 4, 1, 2, 3)))


def _np(y):
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


@pytest.fixture(scope="module")
def params():
    """dffx E2E init (seed 3) with every BN given non-trivial statistics."""
    rng = np.random.default_rng(1)
    p = {k: np.asarray(v) for k, v in jinit(e2e_network_specs(), seed=3).items()}
    bn = {k.rpartition(".")[0] for k in p if k.endswith(".running_mean")}
    for k, v in p.items():
        owner, _, leaf = k.rpartition(".")
        if owner not in bn or leaf == "num_batches_tracked":
            continue
        if leaf in ("bias", "running_mean"):
            p[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        else:
            p[k] = (rng.random(v.shape) + 0.5).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def net(params):
    return load_jax_params(E2ENetwork(), params).eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    fs = rng.uniform(-1, 1, (B, N, H, W, 3)).astype(np.float32)
    fd = np.linspace(0.1, 1.5, N, dtype=np.float32)[None]
    fovs = (1.0 + np.linspace(0.0, 0.06, N) + rng.uniform(-0.01, 0.01, N)).astype(np.float32)[None]
    return fs, fd, fovs


@pytest.fixture(scope="module", params=[False, True], ids=["xla", "pallas"])
def jax_outputs(request, params, inputs):
    """dffx's FlowNetwork and E2E forwards, Pallas kernels in interpret mode."""
    fs, fd, fovs = (jnp.asarray(a) for a in inputs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ctx = Ctx(use_pallas=request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        warped, motion = jalign.flownet_apply(jp, fs, fovs, ctx)
        outs = e2e_apply(jp, fs, fd, fovs, ctx)
    return (np.asarray(warped), np.asarray(motion)), [np.asarray(o) for o in outs]


@pytest.mark.parametrize("seed", [0, 7])
def test_e2e_init_params_bit_equal_to_dffx(seed):
    got, ref = e2e_init_params(seed), jinit(e2e_network_specs(), seed=seed)
    assert set(got) == set(ref) and len(got) == 522
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].dtype == (np.int64 if k.endswith("num_batches_tracked") else np.float32)
        np.testing.assert_array_equal(got[k], r.astype(got[k].dtype), err_msg=k)


def test_load_jax_params_equals_torch_state_dict_route(params):
    a = load_jax_params(E2ENetwork(), params).state_dict()
    b = E2ENetwork()
    b.load_state_dict({k: torch.from_numpy(np.array(v, order="C")) for k, v in
                       jckpt.to_torch_state_dict(params, e2e_network_specs()).items()})
    b = b.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    bias = a[f"{OFA}.conv3.6.bias"]
    assert bias.shape == (3,) and torch.equal(bias, torch.tensor(params[f"{OFA}.conv3.6.bias"]))


@pytest.mark.parametrize("c,h,w", [(3, 24, 40), (8, 17, 33)])
def test_affine_warp_stack_matches(rng, c, h, w):
    x = rng.uniform(-1, 1, (2, 4, h, w, c)).astype(np.float32)
    fov = rng.uniform(0.9, 1.1, (2, 4)).astype(np.float32)
    beta, gamma = (rng.uniform(-3, 3, (2, 4)).astype(np.float32) for _ in range(2))
    ref_y, ref_flow = jwarp(*(jnp.asarray(a) for a in (x, fov, beta, gamma)))
    got_y, got_flow = affine_warp_stack(*(torch.from_numpy(a) for a in (x, fov, beta, gamma)))
    assert tuple(got_flow.shape) == (2, 4, h, w, 2)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(got_flow.numpy(), np.asarray(ref_flow), atol=1e-5)


@pytest.mark.parametrize("n", [10, 15])
def test_adaptive_avg_pool_focus_matches(rng, n):
    x = rng.uniform(-1, 1, (2, n, 6, 7, 3)).astype(np.float32)
    ref = jpool(jnp.asarray(x), 10)  # (B, 10, 1, 1, C)
    got = adaptive_avg_pool_focus(_t(x), 10)  # (B, C, 10, 1, 1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)
    torch.testing.assert_close(got, torch.nn.AdaptiveAvgPool3d((10, 1, 1))(_t(x)))


@pytest.mark.parametrize("pfx,cin,stride", [("OF_feature.0", 3, 1), ("OF_feature1.0", 8, 2)])
def test_resnet_block_of_matches(net, params, rng, pfx, cin, stride):
    x = rng.uniform(-1, 1, (1, 3, 20, 36, cin)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = jalign._rb_of_apply(jp, f"{OFA}.{pfx}", jnp.asarray(x), Ctx(), stride=stride)
    with torch.no_grad():
        got = net.optical_flow_aggregation.get_submodule(pfx)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("head,c", [("conv1", 64), ("conv3", 16)])
def test_motion_head_matches(net, params, rng, head, c):
    """conv1 runs on stock ops, conv3 through motion_head_conv_chain's twin."""
    x = rng.uniform(-1, 1, (1, N, 16, 40, c + 2)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = jalign._head_apply(jp, f"{OFA}.{head}", jnp.asarray(x), Ctx())
    with torch.no_grad():
        got = getattr(net.optical_flow_aggregation, head)(_t(x))
    assert tuple(got.shape) == (1, N, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_flownet_matches_flownet_apply(net, inputs, jax_outputs):
    fs, _, fovs = inputs
    (ref_warped, ref_motion), _ = jax_outputs
    tk.reset_launches()
    with torch.no_grad():
        warped, motion = net.optical_flow_aggregation(torch.from_numpy(fs),
                                                      torch.from_numpy(fovs))
    assert tk.launches == dict.fromkeys(tk.launches, 0)  # CPU: the twins ran
    assert motion.dtype == torch.float32 and tuple(motion.shape) == (B, N, 3)
    assert float(np.abs(ref_motion[..., 1:]).max()) > 1e-3  # the warps really move
    np.testing.assert_allclose(motion.numpy(), ref_motion, atol=2e-5)
    np.testing.assert_allclose(warped.numpy(), ref_warped, atol=2e-5)


def test_e2e_forward_matches_e2e_apply(net, inputs, jax_outputs):
    fs, fd, fovs = inputs
    _, ref = jax_outputs
    tk.reset_launches()
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (fs, fd, fovs)))
    assert tk.launches == dict.fromkeys(tk.launches, 0)
    for g, r, name in zip(got[:4], ref[:4], ["mid", "pred1", "pred2", "pred3"]):
        assert tuple(g.shape) == (B, H, W), name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4, err_msg=name)
    assert tuple(got[4].shape) == (B, N, H, W, 3)
    np.testing.assert_allclose(got[4].numpy(), ref[4], atol=2e-5, err_msg="warped")


def test_e2e_forward_matches_stored_goldens():
    """tests/test_golden_regression.py's E2E inputs and seed."""
    rng = np.random.default_rng(42)
    fs = rng.uniform(-1, 1, (1, 10, 64, 96, 3)).astype(np.float32)
    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    fovs = np.linspace(1.0, 1.02, 10, dtype=np.float32)[None]
    net = load_params_auto(7, device="cpu", e2e=True)
    with torch.no_grad():
        outs = net(*(torch.from_numpy(a) for a in (fs, fd, fovs)))
    ref = np.load(GOLDEN)
    np.testing.assert_allclose(outs[3].numpy(), ref["e2e_pred3"], atol=1e-4)
    np.testing.assert_allclose(outs[4].sum(dim=(2, 3)).numpy(), ref["e2e_warped_sum"],
                               atol=1e-3)


def test_e2e_rejects_train_mode_and_bad_shapes():
    net = E2ENetwork()  # constructed in train mode
    fs, fd, fovs = torch.zeros(1, N, 32, 32, 3), torch.ones(1, N), torch.ones(1, N)
    with pytest.raises(RuntimeError, match="eval-only"):
        net(fs, fd, fovs)
    net.eval()
    with pytest.raises(ValueError, match="N must be 10"):
        net(torch.zeros(1, 9, 32, 32, 3), torch.ones(1, 9), torch.ones(1, 9))
    with pytest.raises(ValueError, match="fovs"):
        net(fs, fd, torch.ones(1, 9))
    with pytest.raises(ValueError, match="multiples of 32"):
        net(torch.zeros(1, N, 32, 40, 3), fd, fovs)


def test_load_params_auto_e2e_from_pth_and_seed(tmp_path, params):
    net = load_jax_params(E2ENetwork(), params)
    path = tmp_path / "check_point.pth"
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()}, path)
    assert set(load_torch_checkpoint(str(path))) == set(net.state_dict())
    loaded = load_params_auto(str(path), device="cpu", e2e=True)
    assert isinstance(loaded, E2ENetwork) and not loaded.training
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert isinstance(load_params_auto(0, device="cpu", e2e=True), E2ENetwork)


def test_timed_forward_passes_fovs(rng):
    net = load_params_auto(0, device="cpu", e2e=True)
    tf = TimedForward(net)
    fs = rng.uniform(-1, 1, (1, N, 32, 32, 3)).astype(np.float32)
    fd = np.linspace(0.1, 1.0, N, dtype=np.float32)[None]
    fovs = np.linspace(1.0, 1.02, N, dtype=np.float32)[None]
    outs = tf(fs, fd, fovs)
    assert tf.count == 1 and tf.total > 0 and len(outs) == 5
    with torch.no_grad():
        ref = net(*(torch.from_numpy(a) for a in (fs, fd, fovs)))
    for g, r in zip(outs, ref):
        assert torch.equal(g, r)
