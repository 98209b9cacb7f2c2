"""The port's FlowNetwork kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain twin; the JAX side runs the Pallas
kernels in interpret mode, as tests/test_pallas.py does, at its shapes and
tolerance (atol 3e-4: four chained convs of weights drawn at 0.2 scale, summed
in another order).  Every BN has a non-zero shift, so an intermediate left
non-zero outside the image would show.  The CUDA kernels themselves are held
to their twins on the card by tests/test_torch_gpu.py."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental import pallas as pl

from dffx.ops import batch_norm, conv3d
from dffx.ops import pallas_kernels as jpk
from dffx_torch.ops import kernels as tk

SHAPES_MH = [(32, 128, 2), (48, 300, 2), (40, 96, 3)]  # (h, w, n), test_pallas.py's
SHAPES_RB = [(32, 128, 2), (48, 260, 2), (40, 96, 3)]
CHAINS = [((3, 8), (8, 8)), ((16, 16),), ((3, 8), (8, 16))]


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(autouse=True)
def _fresh_counts():
    tk.reset_launches()
    yield
    assert tk.launches == dict.fromkeys(tk.launches, 0)  # CPU tensors ran the twins


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


def _jaff(bn):
    return jpk.bn_fused_affine(*map(jnp.asarray, bn))


def _taff(bn):
    return tk.bn_fused_affine(*(torch.from_numpy(a) for a in bn))


def _wt(rng, shape):
    return (rng.standard_normal(shape) * 0.2).astype(np.float32)


def _head_inputs(rng, b, n, h, w, cin=18, c=16):
    x = rng.uniform(-1, 1, (b, n, h, w, cin)).astype(np.float32)
    ws = [_wt(rng, (1, 3, 3, cin, c)), _wt(rng, (1, 3, 3, c, c)), _wt(rng, (1, 3, 3, c, c)),
          _wt(rng, (1, 3, 3, c, 3))]
    bns = [_bn(rng, c) for _ in range(3)]
    return x, ws, bns, rng.standard_normal(3).astype(np.float32)


def _torch_head(x, ws, bns, bias3):
    return tk.motion_head_conv_chain(
        _t(x), _w(ws[0]), _taff(bns[0]), _w(ws[1]), _taff(bns[1]), _w(ws[2]), _taff(bns[2]),
        _w(ws[3]), torch.from_numpy(bias3))


def _chain_inputs(rng, b, n, h, w, chans):
    x = rng.uniform(-1, 1, (b, n, h, w, chans[0][0])).astype(np.float32)
    blocks = [(_wt(rng, (1, 3, 3, ci, co)), _bn(rng, co), _wt(rng, (1, 3, 3, co, co)),
               _bn(rng, co), _wt(rng, (1, 1, 1, ci, co))) for ci, co in chans]
    return x, blocks


def _torch_chain(x, blocks):
    return tk.rb_of_chain(_t(x), [(_w(w1), _taff(b1), _w(w2), _taff(b2), _w(ws))
                                  for w1, b1, w2, b2, ws in blocks])


@pytest.mark.parametrize("h,w,n", SHAPES_MH)
def test_motion_head_conv_chain_matches_pallas(interpret_pallas, rng, h, w, n):
    x, ws, bns, bias3 = _head_inputs(rng, 1, n, h, w)
    ref = jpk.motion_head_conv_chain(
        jnp.asarray(x), jnp.asarray(ws[0]), _jaff(bns[0]), jnp.asarray(ws[1]), _jaff(bns[1]),
        jnp.asarray(ws[2]), _jaff(bns[2]), jnp.asarray(ws[3]), jnp.asarray(bias3))
    got = _torch_head(x, ws, bns, bias3)
    assert tuple(got.shape) == (1, 3, n, h, w)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=3e-4)


@pytest.mark.parametrize("chans", CHAINS, ids=["fe1_pair", "c16", "growth"])
@pytest.mark.parametrize("h,w,n", SHAPES_RB)
def test_rb_of_chain_matches_pallas(interpret_pallas, rng, monkeypatch, h, w, n, chans):
    if w > 128:
        monkeypatch.setenv("DFFX_RBOF_W_CAP", "128")  # the JAX side splits W, as test_pallas
    x, blocks = _chain_inputs(rng, 1, n, h, w, chans)
    ref = jpk.rb_of_chain(jnp.asarray(x), tuple(
        (jnp.asarray(w1), _jaff(b1), jnp.asarray(w2), _jaff(b2), jnp.asarray(ws))
        for w1, b1, w2, b2, ws in blocks))
    got = _torch_chain(x, blocks)
    assert tuple(got.shape) == (1, chans[-1][1], n, h, w)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=3e-4)


def _cbn(y, wk, bn, relu=True):
    g, b, mu, va = bn
    y = batch_norm(conv3d(y, jnp.asarray(wk), padding=(0, 1, 1)), mu, va, g, b)
    return jnp.maximum(y, 0) if relu else y


def test_ragged_shapes_match_xla_formula(rng):
    """2 x 3 x 7 x 5 (smaller than one tile) and 2 x 3 x 40 x 72, held against
    the XLA formulas test_pallas.py builds its oracles from."""
    for b, n, h, w in [(2, 3, 7, 5), (2, 3, 40, 72)]:
        x, ws, bns, bias3 = _head_inputs(rng, b, n, h, w)
        ref = jnp.asarray(x)
        for wk, bn in zip(ws[:3], bns):
            ref = _cbn(ref, wk, bn)
        ref = conv3d(ref, jnp.asarray(ws[3]), padding=(0, 1, 1)) + bias3
        np.testing.assert_allclose(_np(_torch_head(x, ws, bns, bias3)), np.asarray(ref),
                                   atol=3e-4)

        x, blocks = _chain_inputs(rng, b, n, h, w, CHAINS[0])
        ref = jnp.asarray(x)
        for w1, b1, w2, b2, wsc in blocks:
            ref = jnp.maximum(conv3d(ref, jnp.asarray(wsc)) + _cbn(_cbn(ref, w1, b1), w2, b2,
                                                                   relu=False), 0)
        np.testing.assert_allclose(_np(_torch_chain(x, blocks)), np.asarray(ref), atol=3e-4)


def _tf32(t):
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, the 13 low mantissa bits cleared."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _conv_tf32(x, w, pad, split):
    """conv3d with TF32 operands and an fp32 sum: plain (hi . hi) or 3xTF32
    (hi . hi, plus hi . lo + lo . hi summed apart, as csrc/rb_of.cu does)."""
    xh, wh = _tf32(x), _tf32(w)
    y = F.conv3d(xh, wh, padding=pad)
    if split:
        xl, wl = _tf32(x - xh), _tf32(w - wh)
        y = y + (F.conv3d(xl, wh, padding=pad) + F.conv3d(xh, wl, padding=pad))
    return y


@pytest.mark.parametrize("c", [16, 32])
def test_3xtf32_plan_holds_the_fp32_bound(c):
    """The tensor-core design's numerics, emulated on the CPU at a ragged shape
    with non-zero BN shifts and chip_smoke.py's weight scale (0.1): 3xTF32 is
    within the fp32 kernel bound (1e-4) of the twin, plain TF32 is not."""
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.uniform(-1, 1, (2, c, 3, 13, 21)).astype(np.float32))
    w1, w2 = (torch.from_numpy((g.standard_normal((c, c, 1, 3, 3)) * 0.1).astype(np.float32))
              for _ in range(2))
    ws = torch.from_numpy((g.standard_normal((c, c, 1, 1, 1)) * 0.1).astype(np.float32))
    (s1, b1), (s2, b2) = _taff(_bn(g, c)), _taff(_bn(g, c))
    ref = tk.rb_of_chain_ref(x, [(w1, (s1, b1), w2, (s2, b2), ws)])
    v = tk._view
    errs = {}
    for split in (False, True):
        mid = torch.relu(_conv_tf32(x, w1, (0, 1, 1), split) * v(s1) + v(b1))
        w2s = w2 * s2.view(-1, 1, 1, 1, 1)  # the kernel folds BN2's scale into w2
        y = torch.relu(_conv_tf32(x, ws, 0, split) + _conv_tf32(mid, w2s, (0, 1, 1), split)
                       + v(b2))
        errs[split] = (y - ref).abs().max().item()
    assert errs[True] <= 1e-4 < errs[False], errs


def _read_mma(section, co, ci, taps):
    """A conv as csrc/rb_of.cu reads its B fragments, back to (co, ci, taps)."""
    tap, kc, nb, lane, j = np.indices((taps, ci // 8, co // 8, 32, 2)).reshape(5, -1)
    w = np.full((co, ci, taps), np.nan, np.float32)
    w[nb * 8 + lane // 4, kc * 8 + 4 * j + lane % 4, tap] = section
    return w


def _read_fma(section, co, ci, taps):
    """A conv as csrc/chain.cuh reads it ([cin][tap][cout]), back to (co, ci, taps)."""
    c, tap, o = np.indices((ci, taps, co)).reshape(3, -1)
    w = np.full((co, ci, taps), np.nan, np.float32)
    w[o, c, tap] = section
    return w


@pytest.mark.parametrize("chans", [CHAINS[0], ((16, 16),), ((32, 32),)],
                         ids=["fe1_pair", "c16", "c32"])
def test_packed_weights_read_back_as_torch_weights(rng, chans):
    x, blocks = _chain_inputs(rng, 1, 2, 5, 7, chans)
    tblocks = [(_w(w1), _taff(b1), _w(w2), _taff(b2), _w(ws)) for w1, b1, w2, b2, ws in blocks]
    packed = tk.rb_of_chain_params(_t(x), tblocks).numpy()
    read = _read_fma if chans[0][0] % 8 else _read_mma
    off = 0
    for (ci, co), (w1, (s1, b1), w2, (s2, b2), ws) in zip(chans, tblocks):
        for t, taps, cin in ((w1, 9, ci), (s1, 0, 0), (b1, 0, 0), (w2, 9, co), (s2, 0, 0),
                             (b2, 0, 0), (ws, 1, ci)):
            n = t.numel()
            got = packed[off:off + n]
            if taps:
                got = read(got, co, cin, taps)
            np.testing.assert_array_equal(got, t.reshape(got.shape).numpy())
            off += n
    assert off == packed.size


def test_motion_head_weights_read_back_as_torch_weights(rng):
    x, ws, bns, bias3 = _head_inputs(rng, 1, 2, 5, 7)
    args = [_w(ws[0]), _taff(bns[0]), _w(ws[1]), _taff(bns[1]), _w(ws[2]), _taff(bns[2]),
            _w(ws[3]), torch.from_numpy(bias3)]
    packed = tk.motion_head_params(_t(x), *args).numpy()
    off = 0
    for t in (args[0], *args[1], args[2], *args[3], args[4], *args[5], args[6], args[7]):
        n = t.numel()
        got = packed[off:off + n]
        if t.dim() == 5:
            got = _read_fma(got, t.shape[0], t.shape[1], 9)
        np.testing.assert_array_equal(got, t.reshape(got.shape).numpy())
        off += n
    assert off == packed.size


def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    x, blocks = _chain_inputs(rng, 1, 2, 8, 8, CHAINS[0])
    tblocks = [(_w(w1), _taff(b1), _w(w2), _taff(b2), _w(ws)) for w1, b1, w2, b2, ws in blocks]
    with pytest.raises(ValueError, match="block 1 w1"):
        tk.rb_of_chain(_t(x), tblocks[:1] * 2)  # block 1 must take 8 channels
    with pytest.raises(ValueError, match="block 0 ws"):
        tk.rb_of_chain(_t(x), [tblocks[0][:4] + (torch.zeros(8, 3, 1, 3, 3),)])
    with pytest.raises(ValueError, match="at least one block"):
        tk.rb_of_chain(_t(x), [])
    with pytest.raises(RuntimeError, match="device meta"):
        tk.rb_of_chain(_t(x).to("meta"), tblocks)
    x, ws, bns, bias3 = _head_inputs(rng, 1, 2, 8, 8)
    args = [_w(ws[0]), _taff(bns[0]), _w(ws[1]), _taff(bns[1]), _w(ws[2]), _taff(bns[2]),
            _w(ws[3]), torch.from_numpy(bias3)]
    with pytest.raises(ValueError, match="w0"):
        tk.motion_head_conv_chain(_t(x)[:, :17], *args)
    with pytest.raises(ValueError, match="bias3"):
        tk.motion_head_conv_chain(_t(x), *args[:-1], torch.zeros(4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.motion_head_conv_chain(_t(x).double(), *args)
