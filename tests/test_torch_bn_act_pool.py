"""DDFFNet's BN-ReLU and the 2x2 max-pool after it in one pass, on the CPU:
``kernels.bn_act_pool``'s plain twin against the kernel's own arithmetic and
scan (``csrc/bn_act.cu``), the route (``ops/norm.py::affine_act_pool``) and
its gate, and bf16 eval forwards of DDFFNet with the route and without it.

The kernel computes each of a window's four values as ``bn_act`` does (one
rounding), then takes ATen's max over them in (h, w) order: the first value,
then each later one that is greater or NaN.  So the pass is ``bn_act`` then
``F.max_pool3d`` bit for bit, signed zeros and NaN included, and the forward
with it is the forward without it bit for bit."""

import pytest
import torch
import torch.nn.functional as F

import torch_fixtures as fx
from dffx_torch.checkpoint import load_jax_params
from dffx_torch.models import DDFFNet, ddffnet_init_params
from dffx_torch.models.layers import BatchNorm3d
from dffx_torch.ops import bn_fused_affine, kernels as tk, norm
from dffx_torch.utils import profiling

CL = torch.channels_last_3d
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from fx.one_thread()


def _affine(c: int, dtype, g: torch.Generator):
    """A BN folded in fp32 and rounded to ``dtype``; every fourth channel's
    scale positive and shift -0, so that a -0 input stays -0 through the
    ReLU."""
    weight, bias = 1 + 0.3 * torch.randn(c, generator=g), 0.2 * torch.randn(c, generator=g)
    mean, var = 0.3 * torch.randn(c, generator=g), 0.5 + torch.rand(c, generator=g)
    scale, shift = (v.to(dtype) for v in bn_fused_affine(weight, bias, mean, var))
    scale[::4], shift[::4] = scale[::4].abs(), -0.0
    return scale, shift


def _operands(dtype, c: int, seed: int = 0, shape=(2, None, 3, 6, 10)):
    """x NDHWC with NaN, +0 and -0, and windows of equal values."""
    g = torch.Generator().manual_seed(seed)
    b, _, n, h, w = shape
    x = (2 * torch.randn((b, c, n, h, w), generator=g)).to(dtype)
    x[:, :, :, ::3] = 0.0
    x[:, ::4, :, :, 1::3] = -0.0
    x[0, 1, 0, 0, 1] = x[1, c - 1, 2, 5, 4] = float("nan")
    x[1, :, 1, 3] = x[1, :, 1, 2]  # rows 2 and 3 alike: ties between h
    return x.contiguous(memory_format=CL), *_affine(c, dtype, g)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _same_but_nan_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same places, every other value bit for bit."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(_bits(a[~nan]), _bits(b[~nan]))


def _kernel_scan(y: torch.Tensor) -> torch.Tensor:
    """The kernel's max over each 2x2 window of ``y``, as ATen scans it: the
    (2i, 2j) value, then (2i, 2j+1), (2i+1, 2j) and (2i+1, 2j+1), each taken
    where it is greater than the max so far or NaN."""
    m = y[..., 0::2, 0::2]
    for v in (y[..., 0::2, 1::2], y[..., 1::2, 0::2], y[..., 1::2, 1::2]):
        m = torch.where((v > m) | v.isnan(), v, m)
    return m


@pytest.mark.parametrize("c", [8, 64])
@pytest.mark.parametrize("keep", [False, True], ids=["pool", "keep"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_twin_is_bn_act_then_max_pool3d_bit_for_bit(dtype, keep, c):
    x, scale, shift = _operands(DTYPES[dtype], c, seed=c)
    y, pooled = tk.bn_act_pool(x, scale, shift, keep)
    want_y = tk.bn_act_ref(x, scale, shift, relu=True)
    want = F.max_pool3d(want_y, (1, 2, 2))
    assert pooled.dtype == x.dtype and pooled.shape == (2, c, 3, 3, 5)
    assert pooled.is_contiguous(memory_format=CL)
    assert torch.equal(_bits(pooled), _bits(want))
    # ATen's max-pool on the CPU returns its NaN as the canonical NaN; on the
    # card it keeps the bits of the NaN it took, as the kernel does
    assert _same_but_nan_bits(pooled, _kernel_scan(want_y))
    if keep:
        assert y.stride() == x.stride() and torch.equal(_bits(y), _bits(want_y))
    else:
        assert y is None
    # what the operands exercise: NaN, a -0 that the max keeps, ties
    assert bool(pooled.isnan().any())
    assert bool(torch.signbit(pooled[pooled == 0]).any())
    assert bool((pooled == 0).sum() > pooled.numel() // 20)


def test_kernel_scan_keeps_the_first_of_equal_values():
    """Of +0 and -0 the first in the scan stays, as in ATen's max-pool; a
    NaN anywhere wins."""
    for first in (0.0, -0.0):
        y = torch.tensor([[first, -first], [0.0, -0.0]]).bfloat16().view(1, 1, 1, 2, 2)
        got = _kernel_scan(y)
        assert bool(torch.signbit(got)) == (str(first) == "-0.0")
        assert torch.equal(_bits(got), _bits(F.max_pool3d(y, (1, 2, 2))))
    y[0, 0, 0, 1, 1] = float("nan")
    assert _kernel_scan(y).isnan().all() and F.max_pool3d(y, (1, 2, 2)).isnan().all()


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    flat = torch.empty(x.numel() + 8, dtype=x.dtype)
    return flat[1:1 + x.numel()].as_strided(x.shape, x.stride()).copy_(x)


def _refused(x: torch.Tensor) -> dict:
    """Inputs that the kernel does not read, beside ``x`` (bf16, NDHWC)."""
    return {"fp32": x.float(), "ncdhw": x.contiguous(),
            "c12": x[:, :12].contiguous(memory_format=CL),
            "odd h": x[:, :, :, :5].contiguous(memory_format=CL),
            "odd w": x[:, :, :, :, :9].contiguous(memory_format=CL),
            "misaligned": _misaligned(x), "4-d": x[:, :, 0]}


def test_route_takes_the_pass_for_16_bit_ndhwc_eval_outside_autograd():
    x, scale, shift = _operands(torch.bfloat16, 16)
    assert norm.takes_pool_pass(x, scale, shift)
    assert norm.takes_pool_pass(x.half(), scale.half(), shift.half())
    scale.requires_grad_()
    assert not norm.takes_pool_pass(x, scale, shift)  # autograd records
    with torch.no_grad():
        assert norm.takes_pool_pass(x, scale, shift)
    scale.requires_grad_(False)
    for what, a in _refused(x).items():
        c = a.shape[1]
        assert not tk.bn_act_pool_takes(a), what
        assert not norm.takes_pool_pass(a, scale[:c], shift[:c]), what
        with pytest.raises(ValueError, match="bn_act_pool takes"):
            tk.bn_act_pool(a, scale[:c], shift[:c])


def _routed(x, scale, shift, keep):
    profiling.reset()
    try:
        with profiling.collect():
            out = norm.affine_act_pool(x, scale, shift, keep=keep)
        return out, profiling.counters()
    finally:
        profiling.reset()


@pytest.mark.parametrize("how", ["pass", "fp32", "gate_off", "ncdhw", "odd_w"])
def test_route_and_its_counters(how, monkeypatch):
    """The pass counts one eval BN and one fused pool; the two-op route
    (fp32, the gate forced off, an input the kernel does not read) is
    ``affine_act`` then ``max_pool3d`` and counts ``stock.pool_aten``; both
    give ``affine_act``'s BN-ReLU and its pool."""
    x, scale, shift = _operands(torch.bfloat16, 16, seed=3)
    x = {"fp32": x.float(), "ncdhw": x.contiguous(),
         "odd_w": x[..., :9].contiguous(memory_format=CL)}.get(how, x)
    if how == "fp32":
        scale, shift = scale.float(), shift.float()
    if how == "gate_off":
        monkeypatch.setattr(norm, "takes_pass", lambda *a, **k: False)
    (y, pooled), counted = _routed(x, scale, shift, True)
    want_y = norm.affine_act(x, scale, shift, relu=True)
    assert torch.equal(_bits(y), _bits(want_y)) and y.stride() == x.stride()
    assert torch.equal(_bits(pooled), _bits(F.max_pool3d(want_y, (1, 2, 2))))
    bn = "stock.bn_aten" if how in ("fp32", "gate_off") else "stock.bn_fused"
    pool = "stock.pool_fused" if how == "pass" else "stock.pool_aten"
    assert counted == {bn: 1, pool: 1}
    (none, pooled_again), _ = _routed(x, scale, shift, False)
    assert none is None and torch.equal(_bits(pooled_again), _bits(pooled))


# --- DDFFNet ------------------------------------------------------------------

SHAPE = (1, 5, 64, 96)  # (B, N, H, W): the encoder pools down to 2 x 3


def _ddffnet(seed: int = 1) -> DDFFNet:
    net = DDFFNet(SHAPE[1])
    load_jax_params(net, ddffnet_init_params(seed, SHAPE[1]))
    g = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():  # statistics and affine away from the identity
        for m in net.modules():
            if isinstance(m, BatchNorm3d):
                c = m.num_features
                m.weight.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
                m.bias.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_mean.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_var.copy_(0.8 + 0.4 * torch.rand(c, generator=g))
    return net


def _stack(dtype):
    b, n, h, w = SHAPE
    g = torch.Generator().manual_seed(7)
    return ((torch.rand((b, n, h, w, 3), generator=g) * 2 - 1).to(dtype),
            torch.linspace(0.2, 7.0, n).expand(b, n).contiguous())


def _forward(net, dtype) -> tuple:
    profiling.reset()
    try:
        with torch.no_grad(), profiling.collect():
            out = net(*_stack(dtype))
        counted = {k: v for k, v in profiling.counters().items() if k.startswith("stock.")}
    finally:
        profiling.reset()
    return out, counted


@pytest.fixture(scope="module")
def forwards():
    """A bf16 eval forward of DDFFNet with the route, the same with only the
    pool's route off (``bn_act`` then ``max_pool3d``), and in fp32."""
    net = _ddffnet().eval()
    runs = {"route": _forward(net, torch.bfloat16)}
    takes = norm.takes_pool_pass
    norm.takes_pool_pass = lambda *a, **k: False
    try:
        runs["two_ops"] = _forward(net, torch.bfloat16)
    finally:
        norm.takes_pool_pass = takes
    runs["fp32"] = _forward(net, torch.float32)
    return runs


def test_bf16_forward_takes_the_pass_at_five_sites(forwards):
    counted = forwards["route"][1]
    assert counted["stock.pool_fused"] == 5 and "stock.pool_aten" not in counted
    assert counted["stock.bn_fused"] == 25 and "stock.bn_aten" not in counted
    assert forwards["two_ops"][1]["stock.pool_aten"] == 5
    assert "stock.pool_fused" not in forwards["two_ops"][1]


@pytest.mark.parametrize("i,name", [(0, "pred"), (1, "maps")])
def test_bf16_forward_is_the_two_ops_forward_bit_for_bit(forwards, i, name):
    got, want = forwards["route"][0][i], forwards["two_ops"][0][i]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want)), name


def test_fp32_and_training_keep_the_two_ops(forwards):
    """fp32 eval (the goldens' and the plain reference's) and a train-mode
    forward pool with ``max_pool3d``: five ``stock.pool_aten``, no pass."""
    counted = forwards["fp32"][1]
    assert counted["stock.pool_aten"] == 5 and "stock.pool_fused" not in counted
    assert counted["stock.bn_aten"] == 25
    net = _ddffnet().train()
    profiling.reset()
    try:
        with profiling.collect():
            net(*_stack(torch.float32))
        counted = profiling.counters()
    finally:
        profiling.reset()
    assert counted["stock.pool_aten"] == 5 and "stock.pool_fused" not in counted
    assert not any(k.startswith("stock.bn") for k in counted)
