"""DFV in the port (``dffx_torch/models/dfv.py``) against its plain
reference (``tests/dfv_reference.py``) on the CPU, with the ops it brought:
``avg_pool3d`` over N on NDHWC, the trilinear and nearest resizes,
``softmax_argmax`` and the differential volume; and DFV on the serving
path: ``load_params_auto(arch="dfv")`` and ``eval/test.py --arch dfv``.

Weights are the port's own seeded draw (``load_params_auto``: every conv
N(0, sqrt(2 / (prod(k) * Cout))) as DFV's init), with the BatchNorm
statistics and affine drawn away from the identity so that folding them
is exercised.  At b2, N=5, 128x192 the 1/32 level is 4x6: the feature
pyramid pools at 4x6 and 2x3, and ``decoder6`` at (5, 4, 6) and (2, 2, 3),
so every branch fires."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_fixtures as fx
from dfv_reference import DFVReference, port_state_dict, reference_state_dict
from dffx_torch.eval.common import TimedForward, load_params_auto
from dffx_torch.models import DFV
from dffx_torch.models.dfv import diff_volume, pool_sizes
from dffx_torch.models.layers import BatchNorm3d
from dffx_torch.ops import avg_pool3d, resize_trilinear, softmax_argmax, upsample_nearest2x
from dffx_torch.ops.conv import conv3d, is_ndhwc
from dffx_torch.utils import profiling

CL = torch.channels_last_3d
SHAPE = (2, 5, 128, 192)
#: fp32 against the reference in float64: the port and the reference sum
#: their convolutions in other orders (conv3d (1, k, k) against conv2d over
#: the slices) and the port folds BN into one multiply-add; both round at
#: about 1e-7 a layer, which the softmax's weights carry into the outputs
FP32_RMS = 1e-5
#: bf16 activations (fp32 BN folding and softmax) against the same: bf16's
#: 8-bit significand over about 30 layers, through a softmax over N that
#: the drawn weights make sharp, so that rounding moves weight between
#: adjacent slices; the spread, a square root of a variance that is near
#: zero where one slice wins, moves most; the cost, before the softmax,
#: carries the rounding alone (0.054 at seed 1)
BF16_RMS = {"pred3": 0.1, "std3": 0.3, "cost3": 0.1}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from fx.one_thread()


def rms_gap(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).square().mean().sqrt() / want.square().mean().sqrt())


def seeded_dfv(seed: int) -> DFV:
    net = load_params_auto(seed, arch="dfv", device="cpu")
    g = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm3d):
                c = m.num_features
                m.weight.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
                m.bias.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_mean.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_var.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
    return net


def stack(seed: int, shape=SHAPE):
    b, n, h, w = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, n, h, w, 3), generator=g) * 2 - 1,
            torch.linspace(0.2, 7.0, n).expand(b, n).contiguous())


@pytest.fixture(scope="module")
def run():
    """The port in fp32 and bf16 and the reference in float64, on seed 1."""
    net = seeded_dfv(1)
    ref = DFVReference().double().eval()
    ref.load_state_dict(reference_state_dict(net.state_dict()))
    fs, fd = stack(7)
    with torch.no_grad():
        want = ref(fs.double(), fd.double())
        got = net(fs, fd)
        with profiling.collect():
            profiling.reset()
            low = net(fs.bfloat16(), fd)
            counts, spans = profiling.counters(), profiling.spans()
        profiling.reset()
    return {"want": want, "fp32": got, "bf16": low, "counters": counts, "spans": spans,
            "net": net, "inputs": (fs, fd)}


#: (index, name, shape) of each output at SHAPE
OUTPUTS = [(0, "pred3", (2, 128, 192)), (1, "std3", (2, 128, 192)),
           (2, "cost3", (2, 5, 32, 48))]


@pytest.mark.parametrize("i,name,shape", OUTPUTS)
def test_fp32_matches_the_reference(run, i, name, shape):
    assert run["fp32"][i].dtype == torch.float32 and run["fp32"][i].shape == shape
    assert rms_gap(run["fp32"][i], run["want"][i]) <= FP32_RMS


@pytest.mark.parametrize("i,name,shape", OUTPUTS)
def test_bf16_ndhwc_matches_the_reference(run, i, name, shape):
    assert run["bf16"][i].dtype == torch.bfloat16
    assert rms_gap(run["bf16"][i], run["want"][i]) <= BF16_RMS[name]


def test_the_reference_in_fp32_agrees_too(run):
    """The reference as it runs in fp32 (tests and benchmark), for scale."""
    ref = DFVReference().eval()
    ref.load_state_dict(reference_state_dict(run["net"].state_dict()))
    with torch.no_grad():
        got = ref(*run["inputs"])
    for g, w in zip(got, run["want"]):
        assert rms_gap(g, w) <= 1e-4


def test_bf16_forward_is_ndhwc_with_its_spans_and_counter(run):
    """Every 16-bit conv, pooled branches included, reads NDHWC; the four
    spans fire once; the counter adds the four volumes' bytes."""
    counts = run["counters"]
    assert counts.get("stock.conv_ndhwc") == 62 and "stock.conv_ncdhw" not in counts
    assert {k: v[0] for k, v in run["spans"].items() if k.startswith("dfv.")} == {
        "dfv.features": 1, "dfv.volume": 1, "dfv.decode": 1, "dfv.regress": 1}
    b, n, h, w = SHAPE
    pixels = b * n * h * w
    want = 2 * sum(c * pixels // s for c, s in ((16, 16), (32, 64), (64, 256), (128, 1024)))
    assert counts["dfv.volume_bytes"] == want


def test_checkpoint_under_dfvs_keys_loads(tmp_path):
    """A ``.pth`` with DFV's keys and shapes (its 2-D convs' 4-D weights),
    wrapped as a training checkpoint with DataParallel's prefix: the same
    forward as the net it came from."""
    ref = DFVReference()
    sd = {f"module.{k}": v for k, v in ref.state_dict().items()}
    assert sd["module.feature_extraction.firstconv.0.0.weight"].dim() == 4
    path = tmp_path / "dfv.pth"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    net = load_params_auto(str(path), arch="dfv", device="cpu")
    want = port_state_dict(ref)
    got = net.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    other = tmp_path / "dfv.ckpt"
    other.write_bytes(path.read_bytes())
    with pytest.raises(ValueError, match="seed or a .pth"):
        load_params_auto(str(other), arch="dfv", device="cpu")


def test_load_params_auto_defaults_stay():
    from dffx_torch.models import Network

    assert type(load_params_auto(0, device="cpu")) is Network
    net = load_params_auto(0, arch="dfv", device="cpu")
    assert isinstance(net, DFV) and not net.training
    assert sum(p.numel() for p in net.parameters()) == 5_291_124
    with pytest.raises(TypeError):
        load_params_auto(0, device="cpu", e2e=True)
    with pytest.raises(ValueError):
        load_params_auto(0, arch="psmnet", device="cpu")


@pytest.mark.parametrize("shape", [(1, 5, 80, 128), (1, 5, 32, 64), (1, 1, 64, 64)])
def test_forward_refuses_sizes_it_cannot_pool(shape):
    net = DFV().eval()
    with pytest.raises(ValueError, match="multiples of 32"):
        net(*stack(0, shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [(5, 4, 6), (2, 2, 3), (3, 4, 6)])
def test_avg_pool3d_over_n_keeps_ndhwc(dtype, window):
    x = torch.randn(2, 16, 5, 4, 6).to(dtype).contiguous(memory_format=CL)
    y = avg_pool3d(x, window)
    want = F.avg_pool3d(x.float(), window).to(dtype)
    assert y.is_contiguous(memory_format=CL) and torch.equal(y, want)


def test_avg_pool3d_over_slices_is_as_before():
    """The (1, k, k) window on NDHWC: ``F.avg_pool2d`` on the channels-last
    slices, bit for bit, with no copy."""
    x = torch.randn(2, 8, 5, 12, 18).bfloat16().contiguous(memory_format=CL)
    y = avg_pool3d(x, (1, 4, 6))
    b, c, n, h, w = x.shape
    before = F.avg_pool2d(x.transpose(1, 2).reshape(b * n, c, h, w), (4, 6), (4, 6))
    before = before.reshape(b, n, c, *before.shape[2:]).transpose(1, 2)
    assert is_ndhwc(y) and torch.equal(y, before)
    x = x.float().contiguous()
    assert torch.equal(avg_pool3d(x, (1, 4, 6)), F.avg_pool3d(x, (1, 4, 6)))


@pytest.mark.parametrize("size", [(5, 8, 12), (5, 24, 36), (10, 12, 18), (3, 2, 3)])
@pytest.mark.parametrize("layout", ["ndhwc", "ncdhw"])
def test_resize_trilinear_matches_interpolate(size, layout):
    """NDHWC resizes that change N are three products of 1-D matrices, which
    sum the same terms in another order than ATen's kernel: 1e-5."""
    x = torch.randn(2, 8, 5, 4, 6, generator=torch.Generator().manual_seed(1))
    if layout == "ndhwc":
        x = x.contiguous(memory_format=CL)
    y = resize_trilinear(x, size)
    want = F.interpolate(x.contiguous(), size=size, mode="trilinear", align_corners=False)
    assert y.shape == want.shape and is_ndhwc(y) == (layout == "ndhwc")
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_resize_trilinear_takes_the_callers_layout():
    """A pooled (B, C, 1, 1, 1), contiguous in both layouts, resized as the
    features it is added to are laid out."""
    y = torch.randn(2, 8, 1, 1, 1, generator=torch.Generator().manual_seed(2))
    out = resize_trilinear(y, (5, 4, 6), memory_format=CL)
    assert is_ndhwc(out)
    torch.testing.assert_close(out, y.expand(2, 8, 5, 4, 6), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["ndhwc", "ncdhw"])
def test_upsample_nearest2x_matches_interpolate(layout):
    x = torch.randn(2, 8, 5, 4, 6).bfloat16()
    if layout == "ndhwc":
        x = x.contiguous(memory_format=CL)
    y = upsample_nearest2x(x)
    want = F.interpolate(x.float().contiguous(), scale_factor=(1, 2, 2), mode="nearest")
    assert is_ndhwc(y) == (layout == "ndhwc") and torch.equal(y.float(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_argmax_is_the_formula(dtype):
    g = torch.Generator().manual_seed(3)
    cost = (4 * torch.randn(2, 5, 6, 7, generator=g)).to(dtype)
    fd = torch.linspace(0.2, 7.0, 5).expand(2, 5)
    p = torch.exp(cost.double() - cost.double().amax(1, keepdim=True))
    p = p / p.sum(1, keepdim=True)
    depth = (p * fd.double()[:, :, None, None]).sum(1)
    std = (p * (fd.double()[:, :, None, None] - depth[:, None]) ** 2).sum(1).sqrt()
    got_depth, got_std = softmax_argmax(cost, fd, std=True)
    assert got_depth.dtype == got_std.dtype == dtype
    assert torch.equal(softmax_argmax(cost, fd), got_depth)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got_depth.double(), depth, rtol=tol, atol=tol)
    torch.testing.assert_close(got_std.double(), std, rtol=tol, atol=tol)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("layout", ["ndhwc", "ncdhw"])
def test_diff_volume_is_dfvs_slicing(grad, layout):
    f = torch.randn(2, 4, 5, 3, 4)
    if layout == "ndhwc":
        f = f.contiguous(memory_format=CL)
    f.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        v = diff_volume(f)
    want = torch.cat([f[:, :, :-1] - f[:, :, 1:], f[:, :, -1:]], dim=2)
    assert torch.equal(v, want) and is_ndhwc(v) == (layout == "ndhwc")
    assert v.requires_grad == grad


def test_pool_sizes_are_hsms():
    assert pool_sizes((10, 12, 18)) == [[10, 12, 18], [5, 6, 9], [3, 4, 6], [2, 2, 3]]
    assert pool_sizes((10, 24, 36)) == [[10, 24, 36], [5, 12, 18], [3, 8, 12], [2, 4, 7]]
    assert pool_sizes((12, 18)) == [[12, 18], [6, 9], [3, 4], [2, 3]]


def test_a_conv_of_a_pooled_volume_counts_as_ndhwc():
    """A (B, C, 1, 1, 1) input lies alike in both layouts: cuDNN transposes
    nothing, and the counter says NDHWC."""
    x = torch.randn(2, 8, 1, 1, 1).bfloat16().contiguous(memory_format=CL)
    w = torch.randn(8, 8, 1, 1, 1)
    with profiling.collect():
        profiling.reset()
        conv3d(x, w)
        counts = profiling.counters()
    profiling.reset()
    assert counts == {"stock.conv_ndhwc": 1}


def test_timed_forward_serves_dfv():
    net = seeded_dfv(0)
    fs, fd = stack(2, (2, 5, 64, 96))
    with torch.no_grad():
        want = net(fs.bfloat16(), fd)
    got = TimedForward(net, dtype=torch.bfloat16)(fs, fd)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and len(got) == 3


@pytest.fixture(scope="module")
def ddff(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dfv_eval"))
    fx.write_ddff_test(root)
    return root + "/"


@pytest.mark.parametrize("batch", [1, 8])
def test_eval_cli_serves_dfv(ddff, tmp_path, batch):
    """``--arch dfv`` on DDFF-12's test file (10 x 47 x 72, padded to 64 x
    96): DFV on seed 0 through ``TimedForward``, its ``pred3`` cropped into
    ``predictions.npy``, equal to DFV's forward on the reader's stacks."""
    from dffx_torch.data import DDFFBenchmark
    from dffx_torch.eval import test as T

    results = str(tmp_path) + "/"
    with fx.recording_forwards(T) as kept:
        out = fx.run_cli(T.main, ["--dataset", "DDFF", "--data-root", ddff, "--results-root",
                                  results, "--allow-random-init", "--device", "cpu", "--arch",
                                  "dfv", "--batch_size", str(batch)])
    assert "AVG_time:" in out and len(kept[0]) == 3
    preds = np.load(tmp_path / "DDFF" / "predictions.npy")
    data = DDFFBenchmark(h5_path=ddff + "DDFF/ddff-dataset-test.h5")
    fs = torch.stack([torch.as_tensor(data[i]["fs"]) for i in range(len(data))])
    fd = torch.stack([torch.as_tensor(data[i]["focus_dists"]) for i in range(len(data))])
    with torch.no_grad():
        want = load_params_auto(0, arch="dfv", device="cpu")(fs, fd)[0].numpy()
    want = want[:, :data.HEIGHT, :data.WIDTH]  # the CLI's crop (none at this size)
    assert preds.shape == want.shape == (2, 64, 96)
    assert rms_gap(torch.as_tensor(preds), torch.as_tensor(want)) <= FP32_RMS


def test_eval_cli_refuses_spatial_dfv(ddff, tmp_path):
    from dffx_torch.eval import test as T

    with pytest.raises(SystemExit):
        T.main(["--dataset", "DDFF", "--data-root", ddff, "--results-root", str(tmp_path),
                "--allow-random-init", "--device", "cpu", "--arch", "dfv", "--spatial", "2"])
