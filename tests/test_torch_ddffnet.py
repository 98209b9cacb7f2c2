"""DDFFNet in the port (``dffx_torch/models/ddffnet.py``) against its plain
reference (``tests/ddffnet_reference.py``) on the CPU, with the ops it
brought: ``deconv3d``'s ``(1, 4, 4)`` upconvs and ``max_pool3d`` on NDHWC;
and DDFFNet on the serving path: ``load_params_auto(arch="ddffnet")`` and
``eval/test.py --arch ddffnet``.

Weights are the port's own seeded draw (``load_params_auto``: every conv
N(0, sqrt(2 / (prod(k) * Cout))) as ddff-pytorch's init), with the
BatchNorm statistics and affine drawn away from the identity so that
folding them is exercised.  At b2, N=5, 64x96 the encoder pools down to
2x3, so every layer runs."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_fixtures as fx
from ddffnet_reference import DDFFNetReference, port_state_dict, reference_state_dict
from dffx_torch.checkpoint import load_jax_params
from dffx_torch.eval.common import TimedForward, load_params_auto
from dffx_torch.models import DDFFNet, ddffnet_init_params
from dffx_torch.models.ddffnet import score
from dffx_torch.models.layers import BatchNorm3d
from dffx_torch.ops import deconv3d, max_pool3d
from dffx_torch.ops.conv import conv3d, is_ndhwc, slice_conv2d
from dffx_torch.utils import profiling

CL = torch.channels_last_3d
SHAPE = (2, 5, 64, 96)
#: fp32 against the fp32 reference: the port's (1, k, k) conv3ds and folded
#: BN sum in other orders than the reference's conv2ds and batch_norm, each
#: rounding at about 1e-7 a layer over 27 layers
FP32_RMS = 1e-5
#: bf16 activations (fp32 BN folding and fusion) against the same: bf16's
#: 8-bit significand rounds each of 26 layers' outputs by up to 2^-9;
#: the maps read 0.0044 at seed 1, and the depth, a sum over N of maps
#: weighted with both signs, cancels part of itself and reads 0.0125
BF16_RMS = {"pred": 0.04, "maps": 0.02}
#: eval BNs and stock 16-bit convs (13 + 13 convs, 5 upconvs) a forward
BNS, CONVS = 25, 31


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from fx.one_thread()


def rms_gap(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).square().mean().sqrt() / want.square().mean().sqrt())


def seeded_ddffnet(seed: int, n: int = SHAPE[1]) -> DDFFNet:
    net = DDFFNet(n)
    load_jax_params(net, ddffnet_init_params(seed, n))
    g = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm3d):
                c = m.num_features
                m.weight.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
                m.bias.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_mean.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_var.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
    return net.eval()


def stack(seed: int, shape=SHAPE):
    b, n, h, w = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, n, h, w, 3), generator=g) * 2 - 1,
            torch.linspace(0.2, 7.0, n).expand(b, n).contiguous())


def reference_of(net: DDFFNet) -> DDFFNetReference:
    ref = DDFFNetReference(net.focal_stack_size).eval()
    ref.load_state_dict(reference_state_dict(net.state_dict(), net.focal_stack_size))
    return ref


@pytest.fixture(scope="module")
def run():
    """The port in fp32 and bf16 and the reference in fp32, on seed 1."""
    net = seeded_ddffnet(1)
    fs, fd = stack(7)
    with torch.no_grad():
        want = reference_of(net)(fs, fd)
        got = net(fs, fd)
        with profiling.collect():
            profiling.reset()
            low = net(fs.bfloat16(), fd)
            counts, spans = profiling.counters(), profiling.spans()
        profiling.reset()
    return {"want": want, "fp32": got, "bf16": low, "counters": counts, "spans": spans}


#: (index, name, shape) of each output at SHAPE
OUTPUTS = [(0, "pred", (2, 64, 96)), (1, "maps", (2, 5, 64, 96))]


@pytest.mark.parametrize("i,name,shape", OUTPUTS)
def test_fp32_matches_the_reference(run, i, name, shape):
    assert run["fp32"][i].dtype == torch.float32 and run["fp32"][i].shape == shape
    assert rms_gap(run["fp32"][i], run["want"][i]) <= FP32_RMS


@pytest.mark.parametrize("i,name,shape", OUTPUTS)
def test_bf16_ndhwc_matches_the_reference(run, i, name, shape):
    assert run["bf16"][i].dtype == torch.bfloat16 and run["bf16"][i].shape == shape
    assert rms_gap(run["bf16"][i], run["want"][i]) <= BF16_RMS[name]


def test_bf16_forward_is_ndhwc_with_its_spans_and_counter(run):
    """Every 16-bit conv and upconv reads NDHWC, every eval BN is one pass;
    the three spans fire once; the counter adds the CC3 concat's bytes."""
    counts = run["counters"]
    assert counts.get("stock.conv_ndhwc") == CONVS and "stock.conv_ncdhw" not in counts
    assert counts.get("stock.bn_fused") == BNS and "stock.bn_aten" not in counts
    assert {k: v[0] for k, v in run["spans"].items() if k.startswith("ddffnet.")} == {
        "ddffnet.encode": 1, "ddffnet.decode": 1, "ddffnet.score": 1}
    b, n, h, w = SHAPE
    assert counts["ddffnet.concat_bytes"] == b * 512 * n * (h // 4) * (w // 4) * 2


def test_score_is_the_sum_over_n():
    g = torch.Generator().manual_seed(4)
    maps, w = torch.randn(2, 5, 6, 7, generator=g), torch.randn(1, 5, 1, 1, 1, generator=g)
    want = (maps.double() * w.double().view(1, 5, 1, 1)).sum(1)
    torch.testing.assert_close(score(maps, w).double(), want, rtol=1e-6, atol=1e-6)
    assert score(maps.bfloat16(), w).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(3, 64), (16, 8), (8, 1)])
def test_slice_conv2d_is_a_conv2d_of_each_slice(dtype, cin, cout):
    """On NDHWC: ``F.conv2d`` on each slice, laid out NDHWC (one output
    channel lies alike in both layouts); on NCDHW: ``conv3d`` bit for bit;
    each call counted once by the input's layout."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, cin, 3, 6, 7, generator=g).to(dtype)
    wt = torch.randn(cout, cin, 1, 3, 3, generator=g) / 4
    b, _, n, h, w = x.shape
    slices = x.transpose(1, 2).reshape(b * n, cin, h, w)
    want = F.conv2d(slices, wt[:, :, 0].to(dtype), padding=1)
    want = want.reshape(b, n, cout, h, w).transpose(1, 2)
    with profiling.collect():
        profiling.reset()
        y = slice_conv2d(x.contiguous(memory_format=CL), wt, padding=1)
        counts = profiling.counters()
    profiling.reset()
    assert y.shape == (b, cout, n, h, w) and y.is_contiguous(memory_format=CL)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert counts == {"stock.conv_ndhwc": 1}
    assert torch.equal(slice_conv2d(x, wt, padding=(1, 1)), conv3d(x, wt, padding=(0, 1, 1)))


#: (Cin, Cout, B, N, H, W) of an upconv's input
UPCONVS = [(64, 64, 2, 3, 4, 6), (16, 8, 1, 2, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,b,n,h,w", UPCONVS)
def test_upconv_on_ndhwc_is_a_deconv2d_of_each_slice(dtype, cin, cout, b, n, h, w):
    """DDFFNet's (1, 4, 4) stride-2 upconv of an NDHWC input: the same values
    as ``F.conv_transpose2d`` on each slice, laid out NDHWC, H and W doubled."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, cin, n, h, w, generator=g).to(dtype).contiguous(memory_format=CL)
    wt = torch.randn(cin, cout, 1, 4, 4, generator=g) / 8
    y = deconv3d(x, wt, stride=(1, 2, 2), padding=(0, 1, 1), output_padding=0)
    slices = x.transpose(1, 2).reshape(b * n, cin, h, w).contiguous()
    want = F.conv_transpose2d(slices, wt[:, :, 0].to(dtype), stride=2, padding=1)
    want = want.reshape(b, n, cout, 2 * h, 2 * w).transpose(1, 2)
    assert y.shape == (b, cout, n, 2 * h, 2 * w) and is_ndhwc(y)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    ncdhw = deconv3d(x.contiguous(), wt, stride=(1, 2, 2), padding=(0, 1, 1), output_padding=0)
    torch.testing.assert_close(ncdhw.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["ndhwc", "ncdhw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deconv_defaults_are_as_before(dtype, layout):
    """DFFNet's deconv (k3, pad 1, stride (1, 2, 2), output_padding (0, 1,
    1)) still runs as ``F.conv_transpose3d``, bit for bit."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 8, 3, 5, 6, generator=g).to(dtype)
    if layout == "ndhwc":
        x = x.contiguous(memory_format=CL)
    wt = torch.randn(8, 4, 3, 3, 3, generator=g)
    want = F.conv_transpose3d(x, wt.to(dtype), stride=(1, 2, 2), padding=1,
                              output_padding=(0, 1, 1))
    assert torch.equal(deconv3d(x, wt), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool3d_on_ndhwc_is_max_pool2d_of_each_slice(dtype):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 16, 3, 8, 12, generator=g).to(dtype).contiguous(memory_format=CL)
    y = max_pool3d(x, (1, 2, 2))
    b, c, n, h, w = x.shape
    want = F.max_pool2d(x.transpose(1, 2).reshape(b * n, c, h, w).contiguous(), 2, 2)
    want = want.reshape(b, n, c, h // 2, w // 2).transpose(1, 2)
    assert is_ndhwc(y) and torch.equal(y, want)
    assert torch.equal(max_pool3d(x.contiguous(), (1, 2, 2)), want)
    # a window over N too keeps F.max_pool3d
    assert torch.equal(max_pool3d(x, (3, 2, 2)), F.max_pool3d(x.contiguous(), (3, 2, 2)))


def test_load_params_auto_serves_ddffnet():
    net = load_params_auto(0, arch="ddffnet", device="cpu")
    assert isinstance(net, DDFFNet) and not net.training and net.focal_stack_size == 10
    assert sum(p.numel() for p in net.parameters()) == 39_790_346
    assert sum(m.num_features for m in net.modules() if isinstance(m, BatchNorm3d)) == 7936


@pytest.mark.parametrize("wrapped", [False, True])
def test_checkpoint_under_ddffnets_names_loads(tmp_path, wrapped):
    """A ``.pth`` with DDFFNet's names and 2-D shapes (convs ``(Cout, Cin, 3,
    3)``, upconvs ``(Cin, Cout, 4, 4)``), plain or as a training checkpoint
    with DataParallel's prefix: the same weights, and the same forward as
    the reference it came from."""
    ref = DDFFNetReference(10).eval()
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    sd = ref.state_dict()
    assert sd["upconv5.weight"].shape == (512, 512, 4, 4)
    assert sd["scoring.weight"].shape == (1, 10, 1, 1)
    path = tmp_path / "ddffnet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}} if wrapped else sd,
               path)
    net = load_params_auto(str(path), arch="ddffnet", device="cpu")
    want = port_state_dict(ref)
    got = net.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    fs, fd = stack(9, (1, 10, 32, 32))
    with torch.no_grad():
        for o, r in zip(net(fs, fd), ref(fs, fd)):
            assert rms_gap(o, r) <= FP32_RMS


@pytest.mark.parametrize("shape", [(1, 4, 64, 96), (1, 5, 48, 96), (1, 5, 64, 80)])
def test_forward_refuses_stacks_it_cannot_take(shape):
    with pytest.raises(ValueError, match="DDFFNet"):
        DDFFNet(5).eval()(*stack(0, shape))


def test_timed_forward_serves_ddffnet():
    net = seeded_ddffnet(0)
    fs, fd = stack(2, (2, 5, 32, 64))
    with torch.no_grad():
        want = net(fs.bfloat16(), fd)
    got = TimedForward(net, dtype=torch.bfloat16)(fs, fd)
    assert len(got) == 2 and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def ddff(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddffnet_eval"))
    fx.write_ddff_test(root)
    return root + "/"


def test_eval_cli_serves_ddffnet(ddff, tmp_path):
    """``--arch ddffnet`` on DDFF-12's test file (10 x 47 x 72, padded to 64
    x 96): DDFFNet on seed 0 through ``TimedForward``, its ``pred`` cropped
    into ``predictions.npy``, equal to DDFFNet's forward on the reader's
    stacks."""
    from dffx_torch.data import DDFFBenchmark
    from dffx_torch.eval import test as T

    results = str(tmp_path) + "/"
    with fx.recording_forwards(T) as kept:
        out = fx.run_cli(T.main, ["--dataset", "DDFF", "--data-root", ddff, "--results-root",
                                  results, "--allow-random-init", "--device", "cpu", "--arch",
                                  "ddffnet", "--batch_size", "2"])
    assert "AVG_time:" in out and len(kept[0]) == 2
    preds = np.load(tmp_path / "DDFF" / "predictions.npy")
    data = DDFFBenchmark(h5_path=ddff + "DDFF/ddff-dataset-test.h5")
    fs = torch.stack([torch.as_tensor(data[i]["fs"]) for i in range(len(data))])
    fd = torch.stack([torch.as_tensor(data[i]["focus_dists"]) for i in range(len(data))])
    with torch.no_grad():
        want = load_params_auto(0, arch="ddffnet", device="cpu")(fs, fd)[0].numpy()
    want = want[:, :data.HEIGHT, :data.WIDTH]  # the CLI's crop (none at this size)
    assert preds.shape == want.shape == (2, 64, 96)
    assert rms_gap(torch.as_tensor(preds), torch.as_tensor(want)) <= FP32_RMS


def test_eval_cli_refuses_spatial_ddffnet(ddff, tmp_path):
    from dffx_torch.eval import test as T

    with pytest.raises(SystemExit):
        T.main(["--dataset", "DDFF", "--data-root", ddff, "--results-root", str(tmp_path),
                "--allow-random-init", "--device", "cpu", "--arch", "ddffnet", "--spatial", "2"])
