"""dffx_torch.ops against dffx.ops: the same numpy inputs through both, fp32
on the CPU.  The port works in (B, C, N, H, W), the JAX package in
(B, N, H, W, C); weights go across in their own layouts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dffx import ops as jops
from dffx_torch import ops as tops

ATOL = 2e-5


def _to_t(x_ndhwc):
    return torch.from_numpy(np.ascontiguousarray(x_ndhwc.transpose(0, 4, 1, 2, 3)))


def _to_np(y_t):
    return y_t.permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize(
    "cin,cout,k,stride,pad,dil",
    [
        (3, 8, (1, 9, 9), (1, 1, 1), (0, 8, 8), (1, 2, 2)),  # FM_module dilated conv
        (8, 16, (3, 3, 3), (1, 2, 2), (1, 1, 1), (1, 1, 1)),  # EFD strided branch
        (8, 8, (3, 1, 1), (1, 1, 1), (1, 0, 0), (1, 1, 1)),  # SRD focus attention
        (32, 32, (1, 1, 1), (1, 1, 1), (0, 0, 0), (1, 1, 1)),  # redir 1x1
    ],
)
def test_conv3d(rng, cin, cout, k, stride, pad, dil):
    x = rng.standard_normal((2, 5, 16, 20, cin), dtype=np.float32)
    w = rng.standard_normal((*k, cin, cout), dtype=np.float32) * 0.2
    ref = jops.conv3d(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=pad, dilation=dil)
    got = tops.conv3d(_to_t(x), torch.from_numpy(w.transpose(4, 3, 0, 1, 2)),
                      stride=stride, padding=pad, dilation=dil)
    np.testing.assert_allclose(_to_np(got), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("cin,cout,n,h,w", [(64, 32, 5, 7, 9), (16, 8, 3, 6, 10)])
def test_deconv3d(rng, cin, cout, n, h, w):
    x = rng.standard_normal((2, n, h, w, cin), dtype=np.float32)
    wt = rng.standard_normal((3, 3, 3, cin, cout), dtype=np.float32) * 0.1
    ref = jops.deconv3d(jnp.asarray(x), jnp.asarray(wt), stride=(1, 2, 2), padding=1,
                        output_padding=(0, 1, 1))
    got = tops.deconv3d(_to_t(x), torch.from_numpy(wt.transpose(3, 4, 0, 1, 2)))
    assert tuple(got.shape) == (2, cout, n, 2 * h, 2 * w)
    np.testing.assert_allclose(_to_np(got), np.asarray(ref), atol=ATOL)


def test_batch_norm_eval(rng):
    x = rng.standard_normal((2, 5, 8, 8, 16), dtype=np.float32)
    mean = rng.standard_normal(16).astype(np.float32)
    var = rng.random(16).astype(np.float32) + 0.5
    g = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    ref = jops.batch_norm(jnp.asarray(x), mean, var, g, b)
    got = tops.batch_norm(_to_t(x), *(torch.from_numpy(a) for a in (mean, var, g, b)))
    np.testing.assert_allclose(_to_np(got), np.asarray(ref), atol=ATOL)


def test_bn_fused_affine(rng):
    from dffx.ops.pallas_kernels import bn_fused_affine as jaff

    args = [rng.standard_normal(8).astype(np.float32) for _ in range(3)]
    args.append(rng.random(8).astype(np.float32) + 0.5)
    for got, ref in zip(tops.bn_fused_affine(*(torch.from_numpy(a) for a in args)),
                        jaff(*(jnp.asarray(a) for a in args))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("window", [(1, 2, 2), (1, 4, 4), (1, 8, 8)])
def test_pool3d(rng, op, window):
    x = rng.standard_normal((2, 5, 16, 24, 4), dtype=np.float32)
    ref = getattr(jops, f"{op}_pool3d")(jnp.asarray(x), window)
    got = getattr(tops, f"{op}_pool3d")(_to_t(x), window)
    np.testing.assert_allclose(_to_np(got), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("hw_in,hw_out", [((8, 12), (64, 96)), ((16, 16), (128, 128)),
                                          ((8, 8), (8, 8))])
def test_upsample_bilinear(rng, hw_in, hw_out):
    x = rng.standard_normal((2, 10, *hw_in), dtype=np.float32)
    ref = jops.upsample_bilinear(jnp.asarray(x), hw_out)
    got = tops.upsample_bilinear(torch.from_numpy(x), hw_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_softplus_argmax(rng):
    cost = rng.standard_normal((2, 10, 12, 12), dtype=np.float32) * 3
    fd = np.linspace(0.1, 2.0, 10, dtype=np.float32)[None].repeat(2, 0)
    ref = jops.softplus_argmax(jnp.asarray(cost), jnp.asarray(fd))
    got = tops.softplus_argmax(torch.from_numpy(cost), torch.from_numpy(fd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_softplus_argmax_bf16_computes_in_fp32(rng):
    cost = rng.standard_normal((1, 10, 8, 8), dtype=np.float32) * 3
    fd = np.linspace(0.1, 2.0, 10, dtype=np.float32)[None]
    c16 = torch.from_numpy(cost).bfloat16()
    got = tops.softplus_argmax(c16, torch.from_numpy(fd))
    assert got.dtype == torch.bfloat16
    ref = tops.softplus_argmax(c16.float(), torch.from_numpy(fd))
    np.testing.assert_array_equal(got.float().numpy(), ref.bfloat16().float().numpy())
