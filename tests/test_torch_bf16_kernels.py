"""The bf16 designs of fm_conv_bn_relu, rb2d_residual, rb_of_chain and
motion_head_conv_chain, on the CPU.

Each kernel's bf16 plan is emulated from the buffer its wrapper packs: the
weights as bf16 hi/lo pairs of B fragments (``kernels._bf16_fragments``), the
activation exact in bf16, the products summed in fp32, only the output
rounded to bf16.  The emulation is held to the fp32 twin on the same
bf16-rounded input within the kernels' bf16 bound (``headline.gate_bound``:
1e-4 + 2^-8 of the largest value, the bound the card's kernel gate and
``chip_smoke.py`` hold the kernels to).  The twins are held to ``dffx``'s
Pallas kernels in interpret mode on bf16 inputs.  The CUDA kernels themselves
are held to their twins on the card by tests/test_torch_gpu.py."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental import pallas as pl

from dffx.ops import pallas_kernels as jpk
from dffx_torch.headline import gate_bound
from dffx_torch.ops import kernels as tk

#: test_rb2d_3xtf32_plan_holds_the_fp32_bound's shapes (b, n, h, w)
PLAN_SHAPES = [(2, 3, 7, 5), (1, 2, 40, 72), (1, 1, 1, 1)]
PLAN_IDS = ["tiny", "ragged", "one_pixel"]


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _bf16(t):
    return t.bfloat16().float()


def _bn(g, c):
    """Folded eval BN with non-zero shifts: (scale, shift)."""
    a = [g.standard_normal(c), g.standard_normal(c), g.standard_normal(c) * 0.1, g.random(c) + 0.5]
    return tk.bn_fused_affine(*(torch.from_numpy(v.astype(np.float32)) for v in a))


def _wt(g, *shape):
    return torch.from_numpy((g.standard_normal(shape) * 0.1).astype(np.float32))


def _read_bf16_fragments(words, co):
    """``_bf16_fragments``' words back to (hi, lo), each (co, K'), K' the padded K."""
    w = words.contiguous().view(torch.int32).reshape(-1, co // 8, 8, 4, 4)  # s, nb, g, t, word
    half = lambda v, high: (v & -65536 if high else v << 16).view(torch.float32)
    parts = []
    for base in (0, 2):  # hi words, lo words
        # [s][nb][g][t][j][e]: k = 16 s + 8 j + 2 t + e
        v = torch.stack([torch.stack([half(w[..., base + j], e) for e in (0, 1)], -1)
                         for j in (0, 1)], -2)
        parts.append(v.permute(1, 2, 0, 4, 3, 5).reshape(co, -1))
    return parts


def _fm_inputs(g, b, n, h, w):
    x = torch.from_numpy(g.uniform(-1, 1, (b, 3, n, h, w)).astype(np.float32))
    return x, _wt(g, 8, 3, 1, 9, 9), *_bn(g, 8)


def _rb_inputs(g, b, n, h, w, c):
    x = torch.from_numpy(g.uniform(-1, 1, (b, c, n, h, w)).astype(np.float32))
    return x, _wt(g, c, c, 1, 3, 3), _bn(g, c), _wt(g, c, c, 1, 3, 3), _bn(g, c)


def _read_rb2d_bf16(packed, c):
    """``rb2d_params``' bf16 buffer back to ((w1_hi, w1_lo), s1, b1, (w2_hi,
    w2_lo), b2), the convs as (cout, cin, 1, 3, 3) (k = tap * C + cin)."""
    fw = tk.rb2d_bf16_words(c) // 2 - 3 * c // 2
    w1, s1, b1, w2, b2 = torch.split(packed, [fw, c, c, fw, c])
    conv = lambda v: _conv_w(v, c)
    return (tuple(map(conv, _read_bf16_fragments(w1, c))), s1, b1,
            tuple(map(conv, _read_bf16_fragments(w2, c))), b2)


def _fm_weights(w, scale, shift):
    packed = tk.fm_conv_params(torch.zeros(1, 3, 1, 1, 1, dtype=torch.bfloat16), w, scale, shift)
    assert packed.numel() == tk.FM_CONV_BF16_WORDS
    hi, lo = _read_bf16_fragments(packed[:17 * 128], 8)
    np.testing.assert_array_equal(packed[17 * 128:].numpy(), torch.cat([scale, shift]).numpy())
    return hi, lo


#: FlowNetwork's three rb_of_chain levels, as ``kernels._RB_OF_CHAINS``
RB_OF_CHAINS = {"fe1": ((3, 8), (8, 8)), "fe2": ((16, 16),), "fe3": ((32, 32),)}


def _chain_inputs(g, b, n, h, w, chans):
    x = torch.from_numpy(g.uniform(-1, 1, (b, chans[0][0], n, h, w)).astype(np.float32))
    return x, [(_wt(g, co, ci, 1, 3, 3), _bn(g, co), _wt(g, co, co, 1, 3, 3), _bn(g, co),
                _wt(g, co, ci, 1, 1, 1)) for ci, co in chans]


def _head_inputs(g, b, n, h, w):
    x = torch.from_numpy(g.uniform(-1, 1, (b, 18, n, h, w)).astype(np.float32))
    return (x, _wt(g, 16, 18, 1, 3, 3), _bn(g, 16), _wt(g, 16, 16, 1, 3, 3), _bn(g, 16),
            _wt(g, 16, 16, 1, 3, 3), _bn(g, 16), _wt(g, 3, 16, 1, 3, 3),
            torch.from_numpy(g.standard_normal(3).astype(np.float32)))


def _split_words(packed, sizes):
    assert sum(sizes) == packed.numel()
    return torch.split(packed, sizes)


def _read_rb_of_bf16(packed, chans):
    """``rb_of_chain_params``' bf16 buffer back to, per block, (w1, s1, b1, w2,
    b2, ws), each conv and shortcut as (hi, lo) ``(cout, K')`` in the
    kernel's K order."""
    sizes = []
    for cin, cout in chans:
        k = 4 if cin % 8 else cin
        sizes += [tk._frag_words(cout, 9 * k), cout, cout, tk._frag_words(cout, 9 * cout), cout,
                  tk._frag_words(cout, k)]
    parts = _split_words(packed, sizes)
    blocks = []
    for i, (_, cout) in enumerate(chans):
        w1, s1, b1, w2, b2, ws = parts[6 * i:6 * i + 6]
        blocks.append((_read_bf16_fragments(w1, cout), s1, b1, _read_bf16_fragments(w2, cout),
                       b2, _read_bf16_fragments(ws, cout)))
    return blocks


def _read_head_bf16(packed):
    """``motion_head_params``' bf16 buffer back to (w0, s0, b0, w1, s1, b1, w2,
    s2, b2, w3, bias3), each conv as (hi, lo) ``(cout, K')``, w3 with its
    padded output channels."""
    assert packed.numel() == tk.MOTION_HEAD_BF16_WORDS
    w0, s0, b0, w1, s1, b1, w2, s2, b2, w3, bias = _split_words(
        packed, [11 * 256, 16, 16, 9 * 256, 16, 16, 9 * 256, 16, 16, 9 * 128, 4])
    return (_read_bf16_fragments(w0, 16), s0, b0, _read_bf16_fragments(w1, 16), s1, b1,
            _read_bf16_fragments(w2, 16), s2, b2, _read_bf16_fragments(w3, 8), bias)


def _tap_major(w):
    """(Cout, Cin, 1, 3, 3) as (Cout, 9 Cin), k = tap * Cin + cin."""
    co, ci = w.shape[:2]
    return w.reshape(co, ci, 9).permute(0, 2, 1).reshape(co, -1)


def _narrow(w):
    """The pair's 3-channel weight (Cout, 3, 1, kh, kw) as (Cout, 4 kh kw),
    k = 4 tap + cin, cin 3 a zero: written here value by value."""
    co, ci = w.shape[:2]
    taps = w.shape[3] * w.shape[4]
    out = torch.zeros(co, 4 * taps)
    for tap in range(taps):
        for c in range(ci):
            out[:, 4 * tap + c] = w.reshape(co, ci, taps)[:, c, tap]
    return out


def _rb_of_want(blocks):
    """What each block's (w1, s1, b1, w2, b2, ws) should read back as."""
    want = []
    for w1, aff1, w2, aff2, ws in blocks:
        narrow = w1.shape[1] % 8 != 0
        w2s = w2 * aff2[0].view(-1, 1, 1, 1, 1)
        want.append(((_narrow(w1) if narrow else _tap_major(w1)), aff1[0], aff1[1],
                     _tap_major(w2s), aff2[1], (_narrow(ws) if narrow else ws.flatten(1))))
    return want


def _hi_lo_hold(hi, lo, w):
    """hi = bf16(w) exactly and hi + lo = w within 2^-16 of |w|, over w's K;
    the padding beyond it zero."""
    k = w.shape[1]
    np.testing.assert_array_equal(hi[:, :k].numpy(), _bf16(w).numpy())
    assert ((hi[:, :k] + lo[:, :k] - w).abs() <= 2.0 ** -16 * w.abs()).all()
    assert not hi[:, k:].any() and not lo[:, k:].any()


def _reads_back(got, want):
    """Each read-back entry against what it should be: a conv's (hi, lo) by
    ``_hi_lo_hold``, an affine bit for bit."""
    assert len(got) == len(want)
    for got_v, want_v in zip(got, want):
        if isinstance(got_v, (tuple, list)):
            _hi_lo_hold(*got_v, want_v)
        else:
            np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())


@pytest.mark.parametrize("kernel", ["fm_conv", "rb2d_c8", "rb2d_c16", "rb2d_c32", "motion_head",
                                    "rb_of_fe1", "rb_of_fe2", "rb_of_fe3"])
def test_bf16_buffers_read_back_as_hi_lo_pairs(kernel):
    """hi = w.to(bf16) exactly, and hi + lo = w within 2^-16 of |w|, in the
    kernel's K order (rb2d's and rb_of's w2 with BN2's scale folded in); the
    affines as they are."""
    g = np.random.default_rng(1)
    xb = torch.zeros(1, 1, 1, 1, 1, dtype=torch.bfloat16)
    if kernel == "motion_head":
        _, w0, aff0, w1, aff1, w2, aff2, w3, bias3 = _head_inputs(g, 1, 1, 1, 1)
        got = _read_head_bf16(tk.motion_head_params(xb, w0, aff0, w1, aff1, w2, aff2, w3, bias3))
        tail = torch.stack([w0[:, 16 + e].reshape(16, 9) for e in (0, 1)], -1).reshape(16, 18)
        want = [torch.cat([_tap_major(w0[:, :16]), tail], 1), *aff0, _tap_major(w1), *aff1,
                _tap_major(w2), *aff2, _tap_major(F.pad(w3, (0,) * 8 + (0, 5))),
                F.pad(bias3, (0, 1))]
        _reads_back(got, want)
        return
    if kernel.startswith("rb_of"):
        chans = RB_OF_CHAINS[kernel.split("_")[-1]]
        _, blocks = _chain_inputs(g, 1, 1, 1, 1, chans)
        packed = tk.rb_of_chain_params(xb, blocks)
        assert packed.numel() == tk.rb_of_bf16_words(chans)
        for got, want in zip(_read_rb_of_bf16(packed, chans), _rb_of_want(blocks)):
            _reads_back(got, want)
        return
    if kernel == "fm_conv":
        _, w, scale, shift = _fm_inputs(g, 1, 1, 1, 1)
        hi, lo = _fm_weights(w, scale, shift)
        taps = tk.fm_conv_bf16_taps()
        want = [torch.where(taps >= 0, w.reshape(8, 243)[:, taps.clamp(min=0)], 0)]
        got = [(hi, lo)]
    else:
        c = int(kernel.split("_c")[1])
        x, w1, aff1, w2, aff2 = _rb_inputs(g, 1, 1, 1, 1, c)
        (h1, l1), s1, b1, (h2, l2), b2 = _read_rb2d_bf16(
            tk.rb2d_params(x.bfloat16(), w1, aff1, w2, aff2), c)
        for got_v, want_v in ((s1, aff1[0]), (b1, aff1[1]), (b2, aff2[1])):
            np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())
        want = [w1, w2 * aff2[0].view(-1, 1, 1, 1, 1)]
        got = [(h1, l1), (h2, l2)]
    for (hi, lo), w in zip(got, want):
        hi, lo, w = (v.reshape(v.shape[0], -1) for v in (hi, lo, w))
        np.testing.assert_array_equal(hi.numpy(), _bf16(w).numpy())
        assert ((hi + lo - w).abs() <= 2.0 ** -16 * w.abs()).all()


def test_fm_conv_bf16_taps_cover_the_kernel_once():
    taps = tk.fm_conv_bf16_taps().numpy()
    assert taps.shape == (272,) and (taps < 0).sum() == 272 - 243
    assert sorted(taps[taps >= 0]) == list(range(243))


def _fm_bf16_offsets(sw, p):
    """Where csrc/fm_conv.cu's bf16 kernel finds k value (k-step, half j, slot
    t, element e) of a pixel, relative to the pixel's own position in an
    input tile with rows sw apart and channel planes p apart; written as the
    kernel computes it: pair word (c, Y, X) holds columns X and X + 2, a
    channel's pair row ky of m-tile j is its window row j + ky."""
    t, e = np.arange(4)[:, None], np.arange(2)[None, :]
    row = lambda c, ky: c * p + 2 * ky * sw + 4 * t + 2 * e          # R(c, ky): kx = 2t + e
    col8 = lambda c, ky0: c * p + 2 * (ky0 + t) * sw + 16 + 2 * e   # kx = 8 + e at ky0 + t
    halves = []
    for c in range(3):
        halves += [row(c, ky) for ky in range(9)] + [col8(c, 0)]
    halves += [col8(c, 4) for c in range(3)]
    halves += [np.minimum(t, 2) * p + 16 * sw + 16 + 2 * e]         # (t, 8, 8 + e)
    return np.concatenate([np.broadcast_to(h, (4, 2)).reshape(-1) for h in halves])


def test_fm_conv_bf16_offsets_are_the_packed_taps():
    """The pair-plane reads of each k value are the packed tap's input, and a
    zero weight's read (kx = 9, or channel 3 clamped to 2) stays inside the
    staged tile: column x + 18 of 56."""
    sw, p = 52, 1672
    off, taps = _fm_bf16_offsets(sw, p), tk.fm_conv_bf16_taps().numpy()
    real = taps >= 0
    c, ky, kx = taps[real] // 81, taps[real] // 9 % 9, taps[real] % 9
    np.testing.assert_array_equal(off[real], c * p + 2 * ky * sw + 2 * kx)
    assert (off[~real] % p % sw).max() <= 18 and (off[~real] // p).max() <= 2


def _fm_bf16_plan(x, hi, lo, scale, shift, split=True):
    """fm_conv_bn_relu's bf16 plan at batch and slice 0 (b = n = 1), before
    the output's rounding: the zero-padded tile (8 pixels of halo, 10 on the
    right for the kx = 9 reads), A gathered through the kernel's offsets,
    x.w_hi (+ x.w_lo) summed in fp32, BN and ReLU."""
    _, _, _, h, wd = x.shape
    sw = wd + 18
    p = (h + 16) * sw
    tile = torch.zeros(3, h + 16, sw)
    tile[:, 8:8 + h, 8:8 + wd] = x[0, :, 0]
    pix = (torch.arange(h)[:, None] * sw + torch.arange(wd)[None]).reshape(-1, 1)
    a = tile.reshape(-1)[pix + torch.from_numpy(_fm_bf16_offsets(sw, p))[None]]  # (pixels, 272)
    y = a @ hi.T + (a @ lo.T if split else 0)
    return torch.relu(y * scale + shift).T.reshape(1, 8, 1, h, wd)


def _plan_errors(plan, single, ref):
    """The plan's largest error against the fp32 twin on the same input, with
    its output rounded to bf16 and before that rounding, and one bf16 pass's
    before it."""
    return ((_bf16(plan) - ref).abs().max().item(), (plan - ref).abs().max().item(),
            (single - ref).abs().max().item())


#: what "fp32 inside" leaves before the output's rounding: the fp32 bound
FP32_INSIDE = 1e-4


@pytest.mark.parametrize("b,n,h,wd", PLAN_SHAPES, ids=PLAN_IDS)
def test_fm_conv_bf16_plan_holds_the_bf16_bound(b, n, h, wd):
    """bf16 x exact, the weights as hi + lo, fp32 sums, BN and ReLU on them:
    within 1e-4 of the fp32 twin on the bf16-rounded input before the output
    is rounded, and within the bf16 bound after.  One pass of bf16 weights (hi
    only) is more than 20 times further off before the rounding at the ragged
    shape (80 times here); after it, one pass still holds the bound relative to
    the largest value there (0.018 of 0.024).  The plan is per slice: one
    slice of each shape."""
    g = np.random.default_rng(13)
    x, w, scale, shift = _fm_inputs(g, 1, 1, h, wd)
    x = _bf16(x)
    hi, lo = _fm_weights(w, scale, shift)
    ref = tk.fm_conv_bn_relu_ref(x, w, scale, shift)
    rounded, inside, single = _plan_errors(_fm_bf16_plan(x, hi, lo, scale, shift),
                                           _fm_bf16_plan(x, hi, lo, scale, shift, split=False),
                                           ref)
    assert rounded <= gate_bound(torch.bfloat16, ref.abs().max().item()), rounded
    assert inside <= FP32_INSIDE, inside
    if (h, wd) == (40, 72):
        assert single > 20 * FP32_INSIDE, single


def _rb2d_bf16_plan(x, w1, s1, b1, w2, b2, split=True):
    """rb2d_residual's bf16 plan: conv1 = x.w1_hi + x.w1_lo over the pair's
    2-pixel halo, BN1, ReLU, the region 0 outside the image and split into
    bf16 hi + lo, conv2 = hi.w2_hi + hi.w2_lo + lo.w2_hi (BN2's scale in w2)
    started from the exact x, BN2's shift, ReLU; the output before its
    rounding.  Without ``split``, one bf16 pass: x.w1_hi, the region rounded
    to bf16, hi.w2_hi."""
    (h1, l1), (h2, l2) = w1, w2
    v = lambda a: tk._view(a)
    _, _, _, h, wd = x.shape
    xp = F.pad(x, (2, 2, 2, 2))
    conv1 = F.conv3d(xp, h1) + (F.conv3d(xp, l1) if split else 0)
    mid = torch.relu(conv1 * v(s1) + v(b1)) * F.pad(torch.ones(h, wd), (1, 1, 1, 1))
    mh = _bf16(mid)
    ml = _bf16(mid - mh)
    conv2 = F.conv3d(mh, h2) + ((F.conv3d(mh, l2) + F.conv3d(ml, h2)) if split else 0)
    return torch.relu(x + conv2 + v(b2))


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("b,n,h,wd", PLAN_SHAPES, ids=PLAN_IDS)
def test_rb2d_bf16_plan_holds_the_bf16_bound(b, n, h, wd, c):
    """rb2d_residual's bf16 plan from the packed buffer, with non-zero BN
    shifts and chip_smoke.py's weight scale (0.1): within 1e-4 of the fp32
    twin on the bf16-rounded input before the output is rounded, and within
    the bf16 bound after.  One bf16 pass is more than 20 times further off
    before the rounding at the ragged shape (130 to 330 times here); after
    it, the bound relative to the largest value does not always tell the two
    apart (at 40 x 72 one pass misses it at C = 8 only, by 4 %)."""
    g = np.random.default_rng(13)
    x, w1, aff1, w2, aff2 = _rb_inputs(g, b, n, h, wd, c)
    x = _bf16(x)
    packed = tk.rb2d_params(x.bfloat16(), w1, aff1, w2, aff2)
    assert packed.numel() == tk.rb2d_bf16_words(c)
    pw1, s1, b1, pw2, b2 = _read_rb2d_bf16(packed, c)
    ref = tk.rb2d_residual_ref(x, w1, aff1, w2, aff2)
    rounded, inside, single = _plan_errors(
        _rb2d_bf16_plan(x, pw1, s1, b1, pw2, b2),
        _rb2d_bf16_plan(x, pw1, s1, b1, pw2, b2, split=False), ref)
    assert rounded <= gate_bound(torch.bfloat16, ref.abs().max().item()), rounded
    assert inside <= FP32_INSIDE, inside
    if (h, wd) == (40, 72):
        assert single > 20 * FP32_INSIDE, single


def _ndhwc(t):
    return jnp.asarray(t.float().permute(0, 2, 3, 4, 1).numpy(), jnp.bfloat16)


def _ncdhw(y):
    return torch.from_numpy(np.array(y.astype(jnp.float32))).permute(0, 4, 1, 2, 3)


def _dhwio(w):
    return jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy())


#: the twins against dffx's Pallas kernels on the same bf16 input, both in bf16
#: (test_pallas.py's first shape, one slice for rb2d): both cast the weights to
#: bf16 and round their output to bf16, but the twin also rounds each conv's
#: output to bf16 before its BN and, in rb2d, conv1's region before conv2, so
#: the two sit up to an output ulp apart (measured: fm 0.0078 of 2.27, rb2d
#: 0.031 of 6.81); 2^-6 of the largest value is two ulps of it
PALLAS_BF16_RTOL = 2.0 ** -6


def test_fm_conv_bn_relu_bf16_matches_pallas(interpret_pallas):
    g = np.random.default_rng(0)
    x, w, scale, shift = _fm_inputs(g, 1, 2, 32, 128)
    x = x.bfloat16()
    ref = _ncdhw(jpk.fm_conv_bn_relu(_ndhwc(x), _dhwio(w), jnp.asarray(scale.numpy()),
                                     jnp.asarray(shift.numpy())))
    got = tk.fm_conv_bn_relu(x, w, scale, shift)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref).abs().max().item()
    assert err <= PALLAS_BF16_RTOL * ref.abs().max().item(), err
    assert tk.launches == dict.fromkeys(tk.launches, 0)


def test_rb2d_residual_bf16_matches_pallas(interpret_pallas):
    c = 8
    g = np.random.default_rng(0)
    x, w1, aff1, w2, aff2 = _rb_inputs(g, 1, 1, 32, 128, c)
    x = x.bfloat16()
    aff = lambda a: tuple(jnp.asarray(v.numpy()) for v in a)
    ref = _ncdhw(jpk.rb2d_residual(_ndhwc(x), _dhwio(w1), aff(aff1), _dhwio(w2), aff(aff2)))
    got = tk.rb2d_residual(x, w1, aff1, w2, aff2)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref).abs().max().item()
    assert err <= PALLAS_BF16_RTOL * ref.abs().max().item(), err
    assert tk.launches == dict.fromkeys(tk.launches, 0)


def _split(v):
    """An fp32 intermediate as the kernels write it once: bf16 hi and lo planes."""
    hi = _bf16(v)
    return hi, _bf16(v - hi)


def _conv_w(m, cin):
    """A read-back (cout, K') matrix of a (1,3,3) conv, k = tap * cin + c, as a
    conv3d weight."""
    co = m.shape[0]
    return m[:, :9 * cin].reshape(co, 9, cin).permute(0, 2, 1).reshape(co, cin, 1, 3, 3)


def _conv_hilo(v, w):
    """The kernels' conv of an fp32 intermediate v against split weights w =
    (hi, lo) as (cout, K'): hi.w_hi + hi.w_lo + lo.w_hi, pad 1."""
    vh, vl = _split(v)
    wh, wl = (_conv_w(m, v.shape[1]) for m in w)
    conv = lambda a, b: F.conv3d(a, b, padding=(0, 1, 1))
    return conv(vh, wh) + conv(vh, wl) + conv(vl, wh)


def _taps(xp, h, wd, tap):
    """The (c, h, w) window of a 1-padded (c, h + 2, w + 2) tile at tap 3 dy + dx."""
    dy, dx = divmod(tap, 3)
    return xp[:, dy:dy + h, dx:dx + wd]


def _gemm(a, w, cols):
    """a (pixels, cols) against split weights (hi, lo) over their first cols
    k values: x.w_hi + x.w_lo, x exact."""
    hi, lo = w
    return a @ hi[:, :cols].T + a @ lo[:, :cols].T


def _pixels(y, h, wd):
    """(pixels, c) back to (1, c, 1, h, w)."""
    return y.T.reshape(1, -1, 1, h, wd)


def _pair_bf16_plan(x, blocks):
    """rb_of_chain's bf16 pair (3 -> 8 -> 8) on one slice, from the read-back
    buffer, before the output's rounding.  Block 0's conv1 gathers A as the
    kernel does: k value 2q + e is element e of word q % 2 of the pixel at tap
    min(q / 2, 8), a pixel's words (c0, c1) and (c2, 0), over the k16, k16 and
    k8 steps (k < 40); its shortcut reads pairs t = 0..3 as word t % 2 of the
    centre (k < 8).  Every intermediate is 0 outside the image, split into hi
    and lo for the next conv."""
    (w1a, s1a, b1a, w2a, b2a, wsa), (w1b, s1b, b1b, w2b, b2b, wsb) = blocks
    _, _, _, h, wd = x.shape
    xp = F.pad(x[0, :, 0], (1, 1, 1, 1))
    words = torch.cat([xp, torch.zeros_like(xp[:1])])  # channel 3: a word's zero half
    a = torch.stack([_taps(words, h, wd, min(q // 2, 8))[2 * (q % 2) + e].reshape(-1)
                     for q in range(20) for e in (0, 1)], 1)
    mid = _pixels(torch.relu(_gemm(a, w1a, 40) * s1a + b1a), h, wd)
    centre = words[[0, 1, 2, 3, 0, 1, 2, 3], 1:1 + h, 1:1 + wd].reshape(8, -1).T
    out0 = torch.relu(_pixels(_gemm(centre, wsa, 8), h, wd) + _conv_hilo(mid, w2a)
                      + tk._view(b2a))
    mid = torch.relu(_conv_hilo(out0, w1b) * tk._view(s1b) + tk._view(b1b))
    oh, ol = _split(out0)
    hi, lo = (m[:, :8].reshape(8, 8, 1, 1, 1) for m in wsb)
    short = F.conv3d(oh, hi) + F.conv3d(oh, lo) + F.conv3d(ol, hi)
    return torch.relu(short + _conv_hilo(mid, w2b) + tk._view(b2b))


def _block_bf16_plan(x, block):
    """rb_of_chain's bf16 C -> C block (fe2, fe3) on one slice: conv1 = x.w1_hi
    + x.w1_lo, BN1, ReLU, split; the projection x.ws_hi + x.ws_lo and conv2
    (BN2's scale in w2) of hi and lo, + BN2's shift, ReLU."""
    w1, s1, b1, w2, b2, ws = block
    c = x.shape[1]
    hi, lo = (_conv_w(m, c) for m in w1)
    conv1 = F.conv3d(x, hi, padding=(0, 1, 1)) + F.conv3d(x, lo, padding=(0, 1, 1))
    mid = torch.relu(conv1 * tk._view(s1) + tk._view(b1))
    short = sum(F.conv3d(x, m[:, :c].reshape(c, c, 1, 1, 1)) for m in ws)
    return torch.relu(short + _conv_hilo(mid, w2) + tk._view(b2))


def _head_bf16_plan(x, read):
    """motion_head_conv_chain's bf16 plan on one slice, before the output's
    rounding: conv0 gathers A as the kernel does, k = 16 tap + c for channels
    0..15 (nine k16 steps), then the tail's pair q (a k16 and a k8 step, q <
    12) as channels 16 and 17 at tap min(q, 8), x.w_hi + x.w_lo; BN0 and
    ReLU; conv1..conv3 of split intermediates, hi.w_hi + hi.w_lo + lo.w_hi;
    bias3 on channels 0..2."""
    w0, s0, b0, w1, s1, b1, w2, s2, b2, w3, bias = read
    _, _, _, h, wd = x.shape
    xp = F.pad(x[0, :, 0], (1, 1, 1, 1))
    main = [_taps(xp, h, wd, tap)[:16].reshape(16, -1) for tap in range(9)]
    tail = [_taps(xp, h, wd, min(q, 8))[16:].reshape(2, -1) for q in range(12)]
    a = torch.cat(main + tail).T
    y = _pixels(torch.relu(_gemm(a, w0, 168) * s0 + b0), h, wd)
    for w, sc, sh in ((w1, s1, b1), (w2, s2, b2)):
        y = torch.relu(_conv_hilo(y, w) * tk._view(sc) + tk._view(sh))
    return _conv_hilo(y, w3)[:, :3] + tk._view(bias[:3])


def _bf16_plan_errors(plan, ref):
    """The plan's largest error against the fp32 twin, with its output rounded
    to bf16 and before that rounding."""
    return (_bf16(plan) - ref).abs().max().item(), (plan - ref).abs().max().item()


@pytest.mark.parametrize("level", sorted(RB_OF_CHAINS))
@pytest.mark.parametrize("b,n,h,wd", PLAN_SHAPES, ids=PLAN_IDS)
def test_rb_of_chain_bf16_plan_holds_the_bf16_bound(b, n, h, wd, level):
    """rb_of_chain's bf16 plans from the packed buffer, with non-zero BN shifts
    and chip_smoke.py's weight scale (0.1): within 1e-4 of the fp32 twin on the
    bf16-rounded input before the output is rounded, and within the bf16 bound
    after.  One slice of each shape (the plans are per slice)."""
    chans = RB_OF_CHAINS[level]
    g = np.random.default_rng(17)
    x, blocks = _chain_inputs(g, 1, 1, h, wd, chans)
    x = _bf16(x)
    read = _read_rb_of_bf16(tk.rb_of_chain_params(x.bfloat16(), blocks), chans)
    plan = _pair_bf16_plan(x, read) if level == "fe1" else _block_bf16_plan(x, read[0])
    ref = tk.rb_of_chain_ref(x, blocks)
    rounded, inside = _bf16_plan_errors(plan, ref)
    assert rounded <= gate_bound(torch.bfloat16, ref.abs().max().item()), rounded
    assert inside <= FP32_INSIDE, inside


@pytest.mark.parametrize("b,n,h,wd", PLAN_SHAPES, ids=PLAN_IDS)
def test_motion_head_bf16_plan_holds_the_bf16_bound(b, n, h, wd):
    """motion_head_conv_chain's bf16 plan from the packed buffer, as
    test_rb_of_chain_bf16_plan_holds_the_bf16_bound holds rb_of_chain's."""
    g = np.random.default_rng(19)
    x, *args = _head_inputs(g, 1, 1, h, wd)
    x = _bf16(x)
    plan = _head_bf16_plan(x, _read_head_bf16(tk.motion_head_params(x.bfloat16(), *args)))
    ref = tk.motion_head_conv_chain_ref(x, *args)
    rounded, inside = _bf16_plan_errors(plan, ref)
    assert rounded <= gate_bound(torch.bfloat16, ref.abs().max().item()), rounded
    assert inside <= FP32_INSIDE, inside


#: the FlowNetwork twins against dffx's Pallas kernels on the same bf16 input:
#: both cast the weights to bf16 and round the output to bf16, but the twin
#: also rounds every intermediate to bf16 (three in the pair and in the motion
#: head, one in a C -> C block) where the Pallas kernel keeps fp32 scratch, so
#: a chain sits a few output ulps apart (measured at these shapes: head 0.0156
#: of 2.44, fe1 0.0273 of 1.38, fe2 0.0625 of 9.5, fe3 0.125 of 19.25); 2^-5
#: of the largest value is four ulps of it
PALLAS_CHAIN_BF16_RTOL = 2.0 ** -5


def _jaff(a):
    return tuple(jnp.asarray(v.numpy()) for v in a)


def test_motion_head_conv_chain_bf16_matches_pallas(interpret_pallas):
    g = np.random.default_rng(0)
    x, w0, aff0, w1, aff1, w2, aff2, w3, bias3 = _head_inputs(g, 1, 2, 32, 128)
    x = x.bfloat16()
    ref = _ncdhw(jpk.motion_head_conv_chain(
        _ndhwc(x), _dhwio(w0), _jaff(aff0), _dhwio(w1), _jaff(aff1), _dhwio(w2), _jaff(aff2),
        _dhwio(w3), jnp.asarray(bias3.numpy())))
    got = tk.motion_head_conv_chain(x, w0, aff0, w1, aff1, w2, aff2, w3, bias3)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref).abs().max().item()
    assert err <= PALLAS_CHAIN_BF16_RTOL * ref.abs().max().item(), err
    assert tk.launches == dict.fromkeys(tk.launches, 0)


@pytest.mark.parametrize("level", sorted(RB_OF_CHAINS))
def test_rb_of_chain_bf16_matches_pallas(interpret_pallas, level):
    chans = RB_OF_CHAINS[level]
    g = np.random.default_rng(0)
    x, blocks = _chain_inputs(g, 1, 1, 32, 128, chans)
    x = x.bfloat16()
    ref = _ncdhw(jpk.rb_of_chain(_ndhwc(x), tuple(
        (_dhwio(w1), _jaff(aff1), _dhwio(w2), _jaff(aff2), _dhwio(ws))
        for w1, aff1, w2, aff2, ws in blocks)))
    got = tk.rb_of_chain(x, blocks)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref).abs().max().item()
    assert err <= PALLAS_CHAIN_BF16_RTOL * ref.abs().max().item(), err
    assert tk.launches == dict.fromkeys(tk.launches, 0)
