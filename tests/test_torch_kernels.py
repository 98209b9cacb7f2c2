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


def _tf32_trunc(t):
    """An fp32 value's TF32 bits, its 13 low mantissa bits dropped: the hi part
    of csrc/mma.cuh's split, and what the tensor cores read of an fp32 operand."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _read_fragments(section, co, k):
    """B fragments [k // 8][co // 8][lane][2] (csrc/mma.cuh) back to (co, k)."""
    ks, nb, lane, j = np.indices((k // 8, co // 8, 32, 2)).reshape(4, -1)
    w = np.full((co, k), np.nan, np.float32)
    w[nb * 8 + lane // 4, ks * 8 + 4 * j + lane % 4] = section
    return w


def test_fm_conv_taps_cover_the_kernel_once():
    taps = tk.fm_conv_taps().numpy()
    assert taps.shape == (248,) and (taps[243:] == -1).all()
    assert sorted(taps[:243]) == list(range(243))


def test_fm_conv_weights_read_back_as_torch_weights(rng):
    x, wk, bn = _fm_inputs(rng, 1, 2, 5, 7)
    w, (scale, shift) = _w(wk), _taff(bn)
    packed = tk.fm_conv_params(_t(x), w, scale, shift).numpy()
    assert packed.size == 31 * 64 + 16
    got = _read_fragments(packed[:31 * 64], 8, 248)
    taps = tk.fm_conv_taps().numpy()
    np.testing.assert_array_equal(got[:, :243], w.reshape(8, 243).numpy()[:, taps[:243]])
    np.testing.assert_array_equal(got[:, 243:], 0)
    np.testing.assert_array_equal(packed[31 * 64:], torch.cat([scale, shift]).numpy())


def _fm_conv_offsets(sw, p):
    """Where csrc/fm_conv.cu finds k value (k-step s, k) of a pixel in its
    input tile (rows sw apart, channel planes p apart), relative to the
    pixel's own position in the tile; written as the kernel computes it."""
    off = np.zeros((31, 8), np.int64)
    k = np.arange(8)
    for c in range(3):
        for ky in range(9):
            off[c * 9 + ky] = c * p + 2 * ky * sw + 2 * k      # kx = k
        off[27 + c] = c * p + 16 + 2 * k * sw                  # kx = 8, ky = k
    off[30] = np.minimum(k, 2) * p + 16 * sw + 16              # (8, 8) of channel k < 3
    return off.reshape(-1)


def test_fm_conv_offsets_are_the_packed_taps():
    sw, p = 52, 1672
    taps = tk.fm_conv_taps().numpy()[:243]
    c, ky, kx = taps // 81, taps // 9 % 9, taps % 9
    np.testing.assert_array_equal(_fm_conv_offsets(sw, p)[:243], c * p + 2 * ky * sw + 2 * kx)


def test_fm_conv_3xtf32_plan_holds_the_fp32_bound(rng):
    """The K = 243 dilated conv as the kernel runs it, emulated on the CPU: A
    gathered from a zero-padded tile through the kernel's offsets, B from the
    packed buffer, hi parts cut to TF32's bits, low parts truncated by the
    tensor cores, hi.lo + lo.hi summed apart.  Within 1e-4 of the twin at a ragged
    shape; plain TF32 is 20 times further off."""
    h, wd = 13, 21
    x, wk, bn = _fm_inputs(rng, 1, 1, h, wd)
    w, (scale, shift) = _w(wk), _taff(bn)
    ref = tk.fm_conv_bn_relu_ref(_t(x), w, scale, shift)[0, :, 0]
    sw = wd + 16
    p = (h + 16) * sw
    tile = torch.zeros(3, h + 16, sw)
    tile[:, 8:8 + h, 8:8 + wd] = _t(x)[0, :, 0]
    pix = (torch.arange(h)[:, None] * sw + torch.arange(wd)[None]).reshape(-1, 1)
    off = torch.from_numpy(_fm_conv_offsets(sw, p))
    a = tile.reshape(-1)[pix + off[None]]                                   # (pixels, 248)
    packed = tk.fm_conv_params(_t(x), w, scale, shift)
    b = torch.from_numpy(_read_fragments(packed[:31 * 64].numpy(), 8, 248)).T  # (248, 8)
    ah, bh = _tf32_trunc(a), _tf32_trunc(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    errs = {}
    for split in (False, True):
        y = ah @ bh + ((al @ bh + ah @ bl) if split else 0)
        y = torch.relu(y * scale + shift).T.reshape(8, h, wd)
        errs[split] = (y - ref).abs().max().item()
    assert errs[True] <= 1e-4 and errs[False] > 20 * errs[True], errs


def _read_rb2d(packed, c):
    """rb2d_params' buffer as csrc/rb2d.cu reads it (w1, s1, b1, w2, s2, b2, the
    convs as B fragments [tap][cin // 8][cout // 8][lane][2]), back to (cout,
    cin, 1, 3, 3) convs and (scale, shift) pairs."""
    sizes = [9 * c * c, c, c] * 2
    assert sum(sizes) == packed.size and packed.size % 4 == 0
    w1, s1, b1, w2, s2, b2 = np.split(packed, np.cumsum(sizes)[:-1])
    conv = lambda sec: torch.from_numpy(
        _read_fragments(sec, c, 9 * c).reshape(c, 9, c).transpose(0, 2, 1).copy()
    ).reshape(c, c, 1, 3, 3)                                   # k = tap * C + cin
    return conv(w1), (s1, b1), conv(w2), (s2, b2)


@pytest.mark.parametrize("c", [8, 16, 32])
def test_rb2d_weights_read_back_as_torch_weights(rng, c):
    x, w1, bn1, w2, bn2 = _rb_inputs(rng, 1, 2, 5, 7, c)
    args = (_w(w1), _taff(bn1), _w(w2), _taff(bn2))
    g1, (s1, b1), g2, (s2, b2) = _read_rb2d(tk.rb2d_params(_t(x), *args).numpy(), c)
    for got, want in ((g1, args[0]), (g2, args[2])):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for got, want in ((s1, args[1][0]), (b1, args[1][1]), (s2, args[3][0]), (b2, args[3][1])):
        np.testing.assert_array_equal(got, want.numpy())


def _conv_tf32(x, w, split):
    """A valid (1,3,3) conv as csrc/mma.cuh's k-step computes it, with an fp32
    sum: hi parts cut to TF32's bits, low parts truncated by the tensor cores,
    hi.lo + lo.hi summed apart from hi.hi; without ``split``, plain TF32."""
    import torch.nn.functional as F

    xh, wh = _tf32_trunc(x), _tf32_trunc(w)
    y = F.conv3d(xh, wh)
    if split:
        y = y + (F.conv3d(_tf32_trunc(x - xh), wh) + F.conv3d(xh, _tf32_trunc(w - wh)))
    return y


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("b,n,h,w", [(2, 3, 7, 5), (1, 2, 40, 72), (1, 1, 1, 1)],
                         ids=["tiny", "ragged", "one_pixel"])
def test_rb2d_3xtf32_plan_holds_the_fp32_bound(b, n, h, w, c):
    """rb2d_residual as csrc/rb2d.cu runs it, emulated on the CPU from the
    packed buffer: a zero-filled input tile with the pair's 2-pixel halo,
    conv1's region 0 outside the image, BN2's scale folded into w2, conv2's
    accumulators started from the exact fp32 x.  With non-zero BN shifts and
    chip_smoke.py's weight scale (0.1), 3xTF32 is within 1e-4 of the twin,
    plain TF32 is not, and neither is a region left as relu(shift) outside the
    image."""
    import torch.nn.functional as F

    g = np.random.default_rng(13)
    x = torch.from_numpy(g.uniform(-1, 1, (b, c, n, h, w)).astype(np.float32))
    wt = lambda: torch.from_numpy((g.standard_normal((c, c, 1, 3, 3)) * 0.1).astype(np.float32))
    args = (wt(), _taff(_bn(g, c)), wt(), _taff(_bn(g, c)))
    ref = tk.rb2d_residual_ref(x, *args)
    w1, (s1, b1), w2, (s2, b2) = _read_rb2d(tk.rb2d_params(x, *args).numpy(), c)
    v = lambda a: tk._view(torch.from_numpy(a.copy()))
    inside = F.pad(torch.ones(h, w), (1, 1, 1, 1))
    errs = {}
    for split, masked in ((True, True), (False, True), (True, False)):
        mid = torch.relu(_conv_tf32(F.pad(x, (2, 2, 2, 2)), w1, split) * v(s1) + v(b1))
        if masked:
            mid = mid * inside
        w2s = w2 * torch.from_numpy(s2.copy()).view(-1, 1, 1, 1, 1)
        y = torch.relu(x + _conv_tf32(mid, w2s, split) + v(b2))
        errs[split, masked] = (y - ref).abs().max().item()
    assert errs[True, True] <= 1e-4 and errs[True, False] > 1e-2, errs
    if h * w > 1:  # one pixel: too few products for plain TF32 to miss by much
        assert errs[False, True] > 1e-4, errs


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


def test_param_cache_packs_once_until_a_source_changes():
    """A module's packed buffer is made once and again only when the device
    or a source tensor changes; a CPU tensor gets none (its twin takes the
    weights as they are)."""
    import types

    packs = []

    def pack(x, w, aff):
        packs.append(x.device)
        return torch.cat([w.reshape(-1), *aff])

    cache = tk.ParamCache(pack)
    on = lambda i: types.SimpleNamespace(device=torch.device("cuda", i))
    w, aff = torch.ones(2, 3), (torch.zeros(2), torch.ones(2))
    first = cache(on(0), w, aff)
    assert cache(on(0), w, aff) is first and len(packs) == 1
    w.mul_(2)                                   # written in place
    second = cache(on(0), w, aff)
    assert len(packs) == 2 and second[0] == 2
    assert cache(on(0), w, (aff[0], aff[1].clone())) is not second   # a tensor replaced
    assert len(packs) == 3
    cache(on(1), w, aff)                        # another card
    assert len(packs) == 4 and cache(on(1), w, aff) is cache(on(1), w, aff)
    cache.clear()
    cache(on(1), w, aff)
    assert len(packs) == 5
    assert cache(torch.zeros(1), w, aff) is None and len(packs) == 5


def test_fused_affine_is_kept_until_the_statistics_change():
    from dffx_torch.models.layers import BatchNorm3d

    bn = BatchNorm3d(4).eval()
    with torch.no_grad():
        bn.running_mean.add_(0.5)
        a, b = bn.fused_affine(), bn.fused_affine()
        assert a[0] is b[0] and a[1] is b[1]
        bn.running_var.mul_(2.0)
        c = bn.fused_affine()
        assert c[0] is not a[0]
        want = tk.bn_fused_affine(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        torch.testing.assert_close(c, want, rtol=0, atol=0)
    with torch.inference_mode():
        assert bn.fused_affine()[0] is c[0]
    d, e = bn.fused_affine(), bn.fused_affine()   # part of a graph: made anew
    assert d[0] is not e[0] and d[0].requires_grad


def test_wrapper_checks_the_packed_buffer_it_is_given():
    x = torch.zeros(1, 3, 2, 8, 8)
    plan = tk._fm_conv_plan(torch.zeros(8, 3, 1, 9, 9), torch.ones(8), torch.zeros(8))
    good = tk.fm_conv_params(x, *plan[0])
    assert good.numel() == 31 * 64 + 16
    assert tk._use_params(good, x, *plan) is good
    torch.testing.assert_close(tk._use_params(None, x, *plan), good, rtol=0, atol=0)
    for bad in (good[:-1], good.double(), good.to("meta"), torch.cat([good, good])[::2]):
        with pytest.raises(ValueError, match="params"):
            tk._use_params(bad, x, *plan)


def test_rb2d_params_are_packed_once_and_checked(rng):
    """FMModule keeps rb2d_residual's packed weights in a ParamCache(rb2d_params):
    one packing for any number of forwards; the wrapper refuses a buffer that
    is not that packing's size, type or device."""
    import types

    from dffx_torch.models.layers import FMModule

    assert FMModule()._rb_params._pack is tk.rb2d_params
    x, w1, bn1, w2, bn2 = _rb_inputs(rng, 1, 2, 5, 7, 8)
    args = (_w(w1), _taff(bn1), _w(w2), _taff(bn2))
    packs = []

    def pack(on_card, *a):
        packs.append(on_card.device)
        return tk.rb2d_params(_t(x), *a)

    cache = tk.ParamCache(pack)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    good = cache(on_card, *args)
    assert cache(on_card, *args) is good and len(packs) == 1
    assert good.numel() == 2 * (9 * 64 + 16)
    plan = tk._rb2d_plan(*args)
    assert tk._use_params(good, _t(x), *plan) is good
    torch.testing.assert_close(tk._use_params(None, _t(x), *plan), good, rtol=0, atol=0)
    for bad in (good[:-1], good.double(), good.to("meta"), torch.cat([good, good])[::2]):
        with pytest.raises(ValueError, match="params"):
            tk._use_params(bad, _t(x), *plan)
    assert cache(_t(x), *args) is None and len(packs) == 1  # a CPU tensor: the twin, no packing
