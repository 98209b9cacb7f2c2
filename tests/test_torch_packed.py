"""dffx_torch's packed (space-to-depth) evaluation: ``dffx_torch/models/
packed.py`` against the port's own unpacked modules and against
``dffx/models/packed.py``, fp32 on the CPU, inputs from a numpy seed.

Packing is a reparameterisation of the same convolutions, so each transform is
held to the unpacked op at atol 1e-5 (``tests/test_packed.py``'s bound for the
JAX package) and the whole packed forward to the unpacked one at 5e-5.  The
scattered weights themselves must equal the JAX package's bit for bit after
the layout permute: both gather the same taps through the same index maps and
multiply by the same 0/1 mask.  Against ``dffx`` under ``Ctx(use_packed=True)``
the whole networks are held at 1e-4, as the unpacked parity tests are."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dffx.models import Ctx, dffnet_apply, e2e_apply, e2e_network_specs, network_specs
from dffx.models import init_params as jinit
from dffx.models import packed as jpacked
from dffx_torch.checkpoint import load_jax_params
from dffx_torch.eval import load_params_auto
from dffx_torch.models import E2ENetwork, Network
from dffx_torch.models import packed as tp
from dffx_torch.ops import conv3d, deconv3d
from dffx_torch.ops.conv import layout_of

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "forward_v1.npz")
HEADS = ["mid", "pred1", "pred2", "pred3"]


def _t(x_ndhwc):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_ndhwc).transpose(0, 4, 1, 2, 3)))


def _np(y):
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


def _conv_w(w_dhwio):
    """DHWIO numpy -> torch conv layout (Cout, Cin, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(w_dhwio.transpose(4, 3, 0, 1, 2)))


def _deconv_w(w_dhwio):
    """DHWIO numpy -> torch deconv layout (Cin, Cout, kd, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(w_dhwio.transpose(3, 4, 0, 1, 2)))


def _dhwio(w_conv):
    """A packed weight of the port (a conv weight) -> DHWIO numpy."""
    return w_conv.permute(2, 3, 4, 1, 0).numpy()


def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.2).astype(np.float32)


def _with_bn_stats(p, seed=1):
    """Every BN of a dffx param dict given non-trivial statistics and affine."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in p.items()}
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
def params():
    return _with_bn_stats(jinit(network_specs(), seed=3))


@pytest.fixture(scope="module")
def e2e_params():
    return _with_bn_stats(jinit(e2e_network_specs(), seed=3))


def _jp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# tests/test_packed.py restated for the port
# ---------------------------------------------------------------------------


def test_pack_roundtrip(rng):
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 8, 12)).astype(np.float32))
    xp = tp.pack(x)
    assert tuple(xp.shape) == (2, 20, 3, 4, 6)
    assert torch.equal(tp.unpack(xp), x)
    # channel = phase * C + c with phase = (y % 2) * 2 + (x % 2)
    assert torch.equal(xp[:, 3 * 5 + 2], x[:, 2, :, 1::2, 1::2])
    assert torch.equal(xp[:, 1 * 5 + 4], x[:, 4, :, 0::2, 1::2])


def test_pack_is_not_pixel_unshuffle(rng):
    """``F.pixel_unshuffle`` orders channels c * 4 + phase; every index map
    assumes phase * C + c."""
    x = torch.from_numpy(rng.standard_normal((1, 3, 2, 4, 6)).astype(np.float32))
    shuffled = torch.nn.functional.pixel_unshuffle(x.transpose(1, 2), 2).transpose(1, 2)
    assert shuffled.shape == tp.pack(x).shape and not torch.equal(shuffled, tp.pack(x))
    reordered = shuffled.reshape(1, 3, 4, 2, 2, 3).transpose(1, 2).reshape(1, 12, 2, 2, 3)
    assert torch.equal(reordered, tp.pack(x))


def test_pack_conv_s1_exact(rng):
    x = torch.from_numpy(rng.standard_normal((1, 6, 3, 16, 24)).astype(np.float32))
    w = _conv_w(_w(rng, 3, 3, 3, 6, 5))
    ref = conv3d(x, w, padding=1)
    got = tp.unpack(conv3d(tp.pack(x), tp.pack_conv_s1(w), padding=1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_pack_conv_s1_grouped_concat(rng):
    a = torch.from_numpy(rng.standard_normal((1, 4, 2, 16, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 3, 2, 16, 16)).astype(np.float32))
    w = _conv_w(_w(rng, 3, 3, 3, 7, 5))
    ref = conv3d(torch.cat([a, b], 1), w, padding=1)
    cat_packed = torch.cat([tp.pack(a), tp.pack(b)], 1)
    got = tp.unpack(conv3d(cat_packed, tp.pack_conv_s1(w, in_groups=[4, 3]), padding=1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    # packed concat is not packed of concat: the ungrouped weight has every
    # shape right and every number wrong
    wrong = tp.unpack(conv3d(cat_packed, tp.pack_conv_s1(w), padding=1))
    assert wrong.shape == ref.shape and (wrong - ref).abs().max() > 0.1
    with pytest.raises(ValueError, match="in_groups"):
        tp.pack_conv_s1(w, in_groups=[4, 4])


def test_pack_conv_s2_exact(rng):
    x = torch.from_numpy(rng.standard_normal((1, 6, 3, 16, 24)).astype(np.float32))
    w = _conv_w(_w(rng, 3, 3, 3, 6, 5))
    ref = conv3d(x, w, stride=(1, 2, 2), padding=1)
    got = conv3d(torch.nn.functional.pad(tp.pack(x), tp._PAD_S2), tp.pack_conv_s2(w))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_pack_deconv_exact(rng):
    x = torch.from_numpy(rng.standard_normal((1, 6, 3, 8, 12)).astype(np.float32))
    w = _deconv_w(_w(rng, 3, 3, 3, 6, 5))
    ref = deconv3d(x, w)
    got = tp.unpack(conv3d(torch.nn.functional.pad(x, tp._PAD_DECONV), tp.pack_deconv(w)))
    assert tuple(got.shape) == (1, 5, 3, 16, 24)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_pack_conv_1x1_exact(rng):
    """classif3 has one output channel: its packed weight is (4, 4 * 8)."""
    x = torch.from_numpy(rng.standard_normal((1, 8, 3, 8, 12)).astype(np.float32))
    w = _conv_w(_w(rng, 1, 1, 1, 8, 1))
    wp = tp.pack_conv_1x1(w)
    assert tuple(wp.shape) == (4, 32, 1, 1, 1)
    got = tp.unpack(conv3d(tp.pack(x), wp))
    np.testing.assert_allclose(got.numpy(), conv3d(x, w).numpy(), atol=1e-5)


def test_full_model_packed_matches_plain(rng, params):
    """The port's packed forward against its unpacked one, atol 5e-5, every head
    (the packed EFDs feed all four)."""
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 5, 64, 96, 3)).astype(np.float32))
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 5, dtype=np.float32)[None])
    plain = load_jax_params(Network(packed=False), params).eval()
    packed = load_jax_params(Network(packed=True), params).eval()
    assert list(plain.state_dict()) == list(packed.state_dict())
    with torch.no_grad():
        ref, got = plain(fs, fd), packed(fs, fd)
    for g, r, name in zip(got, ref, HEADS):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=5e-5, err_msg=name)


# ---------------------------------------------------------------------------
# against dffx.models.packed
# ---------------------------------------------------------------------------


def test_pack_and_unpack_equal_dffx(rng):
    x = rng.standard_normal((2, 3, 8, 12, 5)).astype(np.float32)  # (B, N, H, W, C)
    ref = np.asarray(jpacked.pack(jnp.asarray(x)))
    got = tp.pack(_t(x))
    np.testing.assert_array_equal(_np(got), ref)
    np.testing.assert_array_equal(_np(tp.unpack(got)), np.asarray(jpacked.unpack(jnp.asarray(ref))))


@pytest.mark.parametrize("name,shape,groups", [
    ("s1", (3, 3, 3, 6, 5), None),
    ("s1", (3, 3, 3, 16, 8), (8, 8)),      # dres4.conv0: two packed tensors concatenated
    ("s1", (1, 3, 3, 7, 5), (4, 3)),
    ("s2", (3, 3, 3, 8, 16), None),        # FM_conv1.0's strided conv, dres4.conv1
    ("deconv", (3, 3, 3, 16, 8), None),    # deconv_3, dres4.conv6
    ("1x1", (1, 1, 1, 8, 1), None),        # classif3
    ("1x1", (1, 1, 1, 6, 5), None),
])
def test_transforms_equal_dffx_bit_for_bit(rng, name, shape, groups):
    """The same DHWIO numpy weight through the JAX transform and the port's."""
    w = _w(rng, *shape)
    if name == "s1":
        ref = jpacked.pack_conv_s1(jnp.asarray(w), in_groups=groups and list(groups))
        got = tp.pack_conv_s1(_conv_w(w), in_groups=groups)
    elif name == "s2":
        ref, got = jpacked.pack_conv_s2(jnp.asarray(w)), tp.pack_conv_s2(_conv_w(w))
    elif name == "deconv":
        ref, got = jpacked.pack_deconv(jnp.asarray(w)), tp.pack_deconv(_deconv_w(w))
    else:
        ref, got = jpacked.pack_conv_1x1(jnp.asarray(w)), tp.pack_conv_1x1(_conv_w(w))
    ref = np.asarray(ref)
    assert got.is_contiguous() and _dhwio(got).shape == ref.shape
    np.testing.assert_array_equal(_dhwio(got), ref)
    assert (ref == 0).mean() >= (0.7 if name in ("s1", "1x1") else 0.0)  # structural zeros


def test_pack_affine_equals_dffx(rng):
    scale, shift = (rng.standard_normal(6).astype(np.float32) for _ in range(2))
    ref = jpacked.pack_affine(jnp.asarray(scale), jnp.asarray(shift))
    got = tp.pack_affine(torch.from_numpy(scale), torch.from_numpy(shift), torch.float32)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (1, 24, 1, 1, 1)
        np.testing.assert_array_equal(g.reshape(-1).numpy(), np.asarray(r))


@pytest.mark.parametrize("pfx,c", [("FM_conv1.0", 8), ("FM_conv2.0", 16)])
def test_packed_efd_matches_dffx_and_the_ports_efd(params, rng, pfx, c):
    x = rng.uniform(-1, 1, (1, 3, 32, 48, c)).astype(np.float32)
    ref = jpacked.packed_efd_apply(_jp(params), f"DFF_net.{pfx}", jpacked.pack(jnp.asarray(x)),
                                   Ctx())
    efd = load_jax_params(Network(), params).eval().DFF_net.get_submodule(pfx)
    with torch.no_grad():
        xp = tp.pack(_t(x))
        got = tp.packed_efd(efd, xp, tp.efd_params(xp, efd.stride_conv[0].weight))
        own = efd(_t(x))
    assert tuple(got.shape) == (1, 2 * c, 3, 16, 24)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), own.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_network_packed_matches_dffnet_apply_packed(params, rng):
    """``Network(packed=True)`` against ``dffnet_apply`` under
    ``Ctx(use_packed=True)``: all four heads at 1e-4 (both sides run both
    packed EFDs, which feed every head, and the packed full-resolution stage,
    which feeds pred3)."""
    fs = rng.uniform(-1, 1, (1, 5, 64, 96, 3)).astype(np.float32)
    fd = np.linspace(0.1, 1.5, 5, dtype=np.float32)[None]
    ref = dffnet_apply(_jp(params), jnp.asarray(fs), jnp.asarray(fd), Ctx(use_packed=True))
    net = load_jax_params(Network(packed=True), params).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(fs), torch.from_numpy(fd))
    for g, r, name in zip(got, ref, HEADS):
        assert tuple(g.shape) == (1, 64, 96), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=name)


def test_e2e_packed_matches_e2e_apply_packed(e2e_params):
    """``E2ENetwork(packed=True)`` against ``e2e_apply`` under
    ``Ctx(use_packed=True)`` at a non-square size (64 x 160; the real-scene
    shape 608 x 1088 is not square either): heads at 1e-4, ``warped`` at 5e-5
    (the unpacked parity test holds it at 2e-5 at W = 96; the motion is in
    normalised coordinates, so the same motion error is a larger shift in
    pixels at W = 160).
    Against the port's own ``packed=False``: ``warped`` is the same program
    (FlowNetwork is never packed) and must be equal; the four heads all sit
    behind a packed EFD and are held at 5e-5."""
    rng = np.random.default_rng(5)
    h, w = 64, 160
    fs = rng.uniform(-1, 1, (1, 10, h, w, 3)).astype(np.float32)
    fd = np.linspace(0.1, 1.5, 10, dtype=np.float32)[None]
    fovs = (1.0 + np.linspace(0.0, 0.06, 10) + rng.uniform(-0.01, 0.01, 10)).astype(
        np.float32)[None]
    ref = e2e_apply(_jp(e2e_params), *(jnp.asarray(a) for a in (fs, fd, fovs)),
                    Ctx(use_packed=True))
    packed = load_jax_params(E2ENetwork(packed=True), e2e_params).eval()
    plain = load_jax_params(E2ENetwork(packed=False), e2e_params).eval()
    args = [torch.from_numpy(a) for a in (fs, fd, fovs)]
    with torch.no_grad():
        got, own = packed(*args), plain(*args)
    for g, r, name in zip(got[:4], ref[:4], HEADS):
        assert tuple(g.shape) == (1, h, w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), atol=5e-5)
    assert torch.equal(got[4], own[4])
    for g, o, name in zip(got[:4], own[:4], HEADS):
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=5e-5, err_msg=name)


def _tail_inputs(rng, n=3, h=32, w=48):
    """What ``DFFNet.forward`` hands its last stage: out_in 16ch @1/2, fm 8ch
    @1/1, and dres3's pre_1 and output (presqu, postsqu), both 16ch @1/2."""
    def act(c, hh, ww):
        return torch.from_numpy(rng.uniform(-1, 1, (1, c, n, hh, ww)).astype(np.float32))
    return act(16, h // 2, w // 2), act(8, h, w), act(16, h // 2, w // 2), act(16, h // 2, w // 2)


def _tails(dff, out_in, fm, pre, out, dtype):
    """The full-resolution stage of ``DFFNet.forward``: unpacked in fp32, and
    packed in ``dtype``."""
    with torch.no_grad():
        out2 = dff.deconv_3(out_in)
        o, _ = dff.dres4(torch.cat([out2, fm], dim=1), pre, out)
        ref = dff.classif3(out2 + o)[:, 0]
        out_in, fm, pre, out = (t.to(dtype) for t in (out_in, fm, pre, out))
        params = tp.stage_params(out_in, *tp.stage_sources(dff.deconv_3, dff.dres4,
                                                           dff.classif3[0]))
        got = tp.packed_stage(dff.dres4, out_in, tp.pack(fm), pre, out, params)
    return ref, got


def test_packed_stage_matches_the_unpacked_stage(params, rng):
    """deconv_3 -> dres4 -> classif3 alone, with both cross-hourglass skips, at 1e-5
    times the cost's size (a few units)."""
    dff = load_jax_params(Network(), params).eval().DFF_net
    ref, got = _tails(dff, *_tail_inputs(rng), torch.float32)
    assert tuple(got.shape) == (1, 3, 32, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5 * ref.abs().max().item())


def test_bf16_packed_against_fp32_unpacked(params, rng):
    """bf16 packed against fp32 unpacked, not against JAX bf16: the
    full-resolution stage and both EFDs, each within 2^-5 of the largest
    fp32 value (bf16 keeps 8 bits; the stage is ten convs deep, an EFD two; the
    worst seen here is 2^-7).  A whole bf16 forward needs the card (the CPU has
    no bf16 ``avg_pool3d``): ``tests/test_torch_gpu.py`` and ``chip_smoke.py``
    report it."""
    dff = load_jax_params(Network(), params).eval().DFF_net
    ref, got = _tails(dff, *_tail_inputs(rng), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    err, size = (got.float() - ref).abs().max().item(), ref.abs().max().item()
    assert err <= 2.0 ** -5 * size, (err, size)
    for efd, c in ((dff.FM_conv1[0], 8), (dff.FM_conv2[0], 16)):
        x = torch.from_numpy(rng.uniform(-1, 1, (1, c, 3, 32, 48)).astype(np.float32))
        with torch.no_grad():
            ref = efd(x)
            xp = tp.pack(x.bfloat16())
            got = tp.packed_efd(efd, xp, tp.efd_params(xp, efd.stride_conv[0].weight))
        assert got.dtype == torch.bfloat16
        err, size = (got.float() - ref).abs().max().item(), ref.abs().max().item()
        assert err <= 2.0 ** -5 * size, (c, err, size)


def test_packed_weights_follow_their_sources(params, rng):
    """Packed weights are derived on use: a weight changed in place reaches
    the next forward, and the result is the unpacked model's with that weight."""
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 64, 3)).astype(np.float32))
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 3, dtype=np.float32)[None])
    packed = load_jax_params(Network(packed=True), params).eval()
    plain = load_jax_params(Network(packed=False), params).eval()
    with torch.no_grad():
        first = packed(fs, fd)
        for net in (packed, plain):
            net.DFF_net.deconv_3[0].weight.mul_(1.5)
            net.DFF_net.FM_conv1[0].stride_conv[0].weight.mul_(0.5)
        got, want = packed(fs, fd), plain(fs, fd)
    assert (got[3] - first[3]).abs().max().item() > 1e-3
    for g, w, name in zip(got, want, HEADS):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-5, err_msg=name)


def test_stage_params_come_in_the_activation_dtype(params):
    """``stage_params`` casts before the gather; the structural zeros stay exact."""
    dff = load_jax_params(Network(), params).eval().DFF_net
    src = tp.stage_sources(dff.deconv_3, dff.dres4, dff.classif3[0])
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            w_up, aff_up, w0, aff0, w1, w6, aff6, wc = tp.stage_params(
                torch.zeros(1, dtype=dtype), *src)
        assert [tuple(w.shape) for w in (w_up, w0, w1, w6, wc)] == [
            (32, 16, 3, 2, 2), (32, 64, 3, 3, 3), (16, 32, 3, 2, 2), (32, 16, 3, 2, 2),
            (4, 32, 1, 1, 1)]
        for t in (w_up, *aff_up, w0, *aff0, w1, w6, *aff6, wc):
            assert t.dtype == dtype
        assert (w0 == 0).float().mean().item() >= 0.75
        assert tuple(aff0[0].shape) == (1, 32, 1, 1, 1)


@pytest.mark.parametrize("arch", ["dffnet", "e2e"])
def test_packed_forward_matches_stored_goldens(arch):
    """tests/test_golden_regression.py's inputs (seed 7 params, rng 42) through
    ``packed=True``, at the unpacked port's golden tolerances."""
    rng = np.random.default_rng(42)
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, 64, 96, 3)).astype(np.float32))
    fd = torch.from_numpy((1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None])
    ref = np.load(GOLDEN)
    net = load_params_auto(7, device="cpu", packed=True, arch=arch)
    assert net.DFF_net.packed
    with torch.no_grad():
        if arch == "e2e":
            fovs = torch.from_numpy(np.linspace(1.0, 1.02, 10, dtype=np.float32)[None])
            out = net(fs, fd, fovs)
            np.testing.assert_allclose(out[3].numpy(), ref["e2e_pred3"], atol=1e-4)
            np.testing.assert_allclose(out[4].sum(dim=(2, 3)).numpy(), ref["e2e_warped_sum"],
                                       atol=1e-3)
        else:
            mid, _, _, pred3 = net(fs, fd)
            np.testing.assert_allclose(mid.numpy(), ref["mid"], atol=1e-4)
            np.testing.assert_allclose(pred3.numpy(), ref["pred3"], atol=1e-4)


def test_packed_default_is_one_constant():
    """``DFFNet``, ``Network``, ``E2ENetwork`` and ``load_params_auto`` share
    ``PACKED_DEFAULT``; an explicit ``packed`` wins either way."""
    import inspect

    for fn in (Network, E2ENetwork, load_params_auto):
        assert inspect.signature(fn).parameters["packed"].default is tp.PACKED_DEFAULT
    assert Network().DFF_net.packed is tp.PACKED_DEFAULT
    for flag in (False, True):
        assert load_params_auto(0, device="cpu", packed=flag).DFF_net.packed is flag
        assert E2ENetwork(packed=flag).DFF_net.packed is flag


# ---------------------------------------------------------------------------
# the NDHWC layout of 16-bit eval activations (ops/conv.py::activation_format)
# ---------------------------------------------------------------------------

LAYOUTS = [torch.contiguous_format, torch.channels_last_3d]


@pytest.mark.parametrize("fmt", LAYOUTS, ids=["ncdhw", "ndhwc"])
def test_pack_and_unpack_keep_the_layout(rng, fmt):
    """The same values bit for bit from either layout, returned in the layout
    given; ``pack`` writes the one it is asked for."""
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 8, 12)).astype(np.float32))
    xf = x.contiguous(memory_format=fmt)
    xp = tp.pack(xf)
    assert layout_of(xp) == fmt and torch.equal(xp, tp.pack(x))
    back = tp.unpack(xp)
    assert layout_of(back) == fmt and torch.equal(back, x)
    for out in LAYOUTS:
        asked = tp.pack(xf, out)
        assert layout_of(asked) == out and torch.equal(asked, xp)


@pytest.mark.parametrize("fmt", LAYOUTS, ids=["ncdhw", "ndhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_packed_efd_keeps_the_layout(params, rng, fmt, dtype):
    """The same values bit for bit from either layout; the strided weight
    and, in bf16, the output in the layout given (the CPU's fp32 convs
    choose their output layout by shape)."""
    efd = load_jax_params(Network(), params).eval().DFF_net.FM_conv1[0]
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 8, 3, 32, 48)).astype(np.float32)).to(dtype)
    w = efd.stride_conv[0].weight
    with torch.no_grad():
        xp, ref_xp = tp.pack(x, fmt), tp.pack(x)
        w_s2 = tp.efd_params(xp, w)
        got = tp.packed_efd(efd, xp, w_s2)
        ref = tp.packed_efd(efd, ref_xp, tp.efd_params(ref_xp, w))
    assert layout_of(w_s2) == fmt and torch.equal(got, ref)
    assert dtype == torch.float32 or layout_of(got) == fmt


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_ndhwc_forward_matches_ncdhw(params, rng, packed, monkeypatch):
    """An fp32 eval forward with the layout policy forced to NDHWC against
    the NCDHW one: every head within 1e-5 (the CPU has no bf16
    ``avg_pool3d`` to run a 16-bit forward NCDHW)."""
    from dffx_torch.models import dffnet

    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 64, 96, 3)).astype(np.float32))
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 4, dtype=np.float32)[None])
    net = load_jax_params(Network(packed=packed), params).eval()
    with torch.no_grad():
        ref = net(fs, fd)
        monkeypatch.setattr(dffnet, "activation_format",
                            lambda x, training: torch.channels_last_3d)
        got = net(fs, fd)
    for g, r, name in zip(got, ref, HEADS):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch", ["dffnet", "e2e"])
def test_bf16_eval_forward_counts_its_stock_convs_by_layout(arch):
    """A bf16 eval forward: DFFNet's 65 stock convs and deconvs (the FM
    chain's five are kernels on the card) run on NDHWC inputs; FlowNetwork's
    14 stay NCDHW.  Every eval BN outside the kernels (DFFNet's 55,
    FlowNetwork's 10 more) takes the one pass (``stock.bn_fused``)."""
    from dffx_torch.utils import profiling

    e2e = arch == "e2e"
    n = 10 if e2e else 4
    net = load_params_auto(0, device="cpu", arch=arch)
    fs = torch.linspace(-1, 1, n * 64 * 96 * 3).reshape(1, n, 64, 96, 3).bfloat16()
    fd = torch.linspace(0.1, 1.5, n)[None]
    extra = (torch.linspace(1.0, 1.05, n)[None],) if e2e else ()
    profiling.reset()
    try:
        with torch.no_grad(), profiling.collect():
            net(fs, fd, *extra)
        counted = profiling.counters()
    finally:
        profiling.reset()
    convs = {k: v for k, v in counted.items() if k.startswith("stock.conv")}
    assert convs == {"stock.conv_ndhwc": 65, **({"stock.conv_ncdhw": 14} if e2e else {})}
    assert {k: v for k, v in counted.items() if k.startswith("stock.bn")} == {
        "stock.bn_fused": 65 if e2e else 55}
