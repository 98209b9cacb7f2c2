"""The port's focus-measure kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain twin; the JAX side runs the Pallas
kernels in interpret mode, as tests/test_pallas.py does.  Shapes and
tolerances are test_pallas.py's (atol 2e-5 for the dilated conv, 1e-5 for
rb2d and the attention).  The CUDA kernels themselves are held to their
twins on the card by tests/test_torch_gpu.py."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from dffx.ops import batch_norm, conv3d
from dffx.ops import pallas_kernels as jpk
from dffx_torch.ops import kernels as tk

SHAPES = [(32, 128, 2), (64, 160, 3)]  # (h, w, n), test_pallas.py's


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(autouse=True)
def _fresh_counts():
    tk.reset_launches()


def _no_launches():
    """CPU tensors run the twins: no kernel was launched."""
    assert tk.launches == dict.fromkeys(tk.launches, 0)


def _t(x_ndhwc):
    """(B, N, H, W, C) numpy -> (B, C, N, H, W) torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_ndhwc).transpose(0, 4, 1, 2, 3)))


def _np(y):
    return y.permute(0, 2, 3, 4, 1).numpy()


def _w(w_dhwio):
    """dffx DHWIO kernel -> torch (Cout, Cin, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w_dhwio).transpose(4, 3, 0, 1, 2)))


def _bn(rng, c):
    """Non-trivial BN (shift != 0): (weight, bias, mean, var)."""
    return [rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            (rng.random(c) + 0.5).astype(np.float32)]


def _taff(bn):
    return tk.bn_fused_affine(*(torch.from_numpy(a) for a in bn))


def _fm_inputs(rng, b, n, h, w):
    x = rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32)
    wk = (rng.standard_normal((1, 9, 9, 3, 8)) * 0.1).astype(np.float32)
    return x, wk, _bn(rng, 8)


def _rb_inputs(rng, b, n, h, w, c):
    x = rng.uniform(-1, 1, (b, n, h, w, c)).astype(np.float32)
    w1 = (rng.standard_normal((1, 3, 3, c, c)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((1, 3, 3, c, c)) * 0.1).astype(np.float32)
    return x, w1, _bn(rng, c), w2, _bn(rng, c)


def _attn_inputs(rng, b, n, h, w, c):
    f = rng.uniform(-1, 1, (b, n, h, w, c)).astype(np.float32)
    wn = (rng.standard_normal((3, 1, 1, c, c)) * 0.1).astype(np.float32)
    wx = (rng.standard_normal((1, 1, 1, c, c)) * 0.1).astype(np.float32)
    return f, wn, wx


@pytest.mark.parametrize("h,w,n", SHAPES)
def test_fm_conv_bn_relu_matches_pallas(interpret_pallas, rng, h, w, n):
    x, wk, bn = _fm_inputs(rng, 1, n, h, w)
    ref = jpk.fm_conv_bn_relu(jnp.asarray(x), jnp.asarray(wk),
                              *jpk.bn_fused_affine(*map(jnp.asarray, bn)))
    got = tk.fm_conv_bn_relu(_t(x), _w(wk), *_taff(bn))
    assert tuple(got.shape) == (1, 8, n, h, w)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)
    _no_launches()


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("h,w,n", SHAPES)
def test_rb2d_residual_matches_pallas(interpret_pallas, rng, h, w, n, c):
    x, w1, bn1, w2, bn2 = _rb_inputs(rng, 1, n, h, w, c)
    ref = jpk.rb2d_residual(jnp.asarray(x), jnp.asarray(w1),
                            jpk.bn_fused_affine(*map(jnp.asarray, bn1)),
                            jnp.asarray(w2), jpk.bn_fused_affine(*map(jnp.asarray, bn2)))
    got = tk.rb2d_residual(_t(x), _w(w1), _taff(bn1), _w(w2), _taff(bn2))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
    _no_launches()


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("h,w,n", SHAPES)
def test_srd_attention_residual_matches_pallas(interpret_pallas, rng, h, w, n, c):
    f, wn, wx = _attn_inputs(rng, 1, n, h, w, c)
    ref = jpk.srd_attention_residual(jnp.asarray(f), jnp.asarray(wn), jnp.asarray(wx))
    got = tk.srd_attention_residual(_t(f), _w(wn), _w(wx))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
    _no_launches()


def test_ragged_shape_matches_xla_formula(rng):
    """40 x 72 with N = 1 and B = 2: a shape the TPU kernels' tile gates refuse,
    held against the JAX XLA formulas test_pallas.py builds its oracles from."""
    b, n, h, w = 2, 1, 40, 72
    x, wk, bn = _fm_inputs(rng, b, n, h, w)
    ref = jnp.maximum(batch_norm(conv3d(jnp.asarray(x), jnp.asarray(wk), padding=(0, 8, 8),
                                        dilation=(1, 2, 2)), bn[2], bn[3], bn[0], bn[1]), 0)
    got = tk.fm_conv_bn_relu(_t(x), _w(wk), *_taff(bn))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)

    x, w1, bn1, w2, bn2 = _rb_inputs(rng, b, n, h, w, 8)
    r = jnp.maximum(batch_norm(conv3d(jnp.asarray(x), jnp.asarray(w1), padding=(0, 1, 1)),
                               bn1[2], bn1[3], bn1[0], bn1[1]), 0)
    r = batch_norm(conv3d(r, jnp.asarray(w2), padding=(0, 1, 1)), bn2[2], bn2[3], bn2[0], bn2[1])
    ref = jnp.maximum(jnp.asarray(x) + r, 0)
    got = tk.rb2d_residual(_t(x), _w(w1), _taff(bn1), _w(w2), _taff(bn2))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)

    f, wn, wx = _attn_inputs(rng, b, n, h, w, 8)
    fj = jnp.asarray(f)
    ref = fj + jnp.maximum(conv3d(jnp.maximum(conv3d(fj, jnp.asarray(wn), padding=(1, 0, 0)), 0),
                                  jnp.asarray(wx)), 0)
    got = tk.srd_attention_residual(_t(f), _w(wn), _w(wx))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
    _no_launches()


def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    x = torch.zeros(1, 3, 2, 8, 8)
    w, sc, sh = torch.zeros(8, 3, 1, 9, 9), torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="channels"):
        tk.fm_conv_bn_relu(torch.zeros(1, 4, 2, 8, 8), w, sc, sh)
    with pytest.raises(ValueError, match="w"):
        tk.fm_conv_bn_relu(x, torch.zeros(8, 3, 9, 9), sc, sh)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.fm_conv_bn_relu(x.double(), w, sc, sh)
    with pytest.raises(ValueError, match="empty"):
        tk.fm_conv_bn_relu(torch.zeros(1, 3, 0, 8, 8), w, sc, sh)
    with pytest.raises(RuntimeError, match="device meta"):
        tk.fm_conv_bn_relu(x.to("meta"), w.to("meta"), sc.to("meta"), sh.to("meta"))
    aff = (torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="w2"):
        tk.rb2d_residual(torch.zeros(1, 8, 2, 8, 8), torch.zeros(8, 8, 1, 3, 3), aff,
                         torch.zeros(8, 8, 3, 3, 3), aff)
    with pytest.raises(ValueError, match="wn"):
        tk.srd_attention_residual(torch.zeros(1, 8, 2, 8, 8), torch.zeros(8, 8, 1, 1, 1),
                                  torch.zeros(8, 8, 1, 1, 1))
