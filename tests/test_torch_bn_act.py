"""The 16-bit eval BatchNorm's one pass on the CPU: ``kernels.bn_act``'s
plain twin against float64 arithmetic rounded once, the layouts the pass
takes, the gate (``ops/norm.py::affine_act``), and bf16 eval forwards of
DFFNet (packed and unpacked), the end-to-end network and DFV, in which every
eval BN outside the hand kernels takes the pass.

The twin computes as the CUDA kernel does (``csrc/bn_act.cu``): the product
of two 16-bit values is exact in fp32, the shift and the residual are added
in fp32, and the result is rounded once to the activation dtype.  It equals
the float64 result rounded once, except where that result lies within fp32's
rounding error of a point halfway between two 16-bit values; there either
neighbour is right."""

import sys
from pathlib import Path

import pytest
import torch

import torch_fixtures as fx
from dfv_reference import DFVReference, port_state_dict
from dffx.models import e2e_network_specs, init_params as jinit, network_specs
from dffx_torch.eval import load_params_auto
from dffx_torch.models import DFFNet
from dffx_torch.models.layers import BatchNorm3d
from dffx_torch.ops import batch_norm, bn_fused_affine, kernels as tk, norm
from dffx_torch.utils import profiling

CL = torch.channels_last_3d
LAYOUTS = {"ndhwc": CL, "ncdhw": torch.contiguous_format}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from fx.one_thread()


def _affine(c: int, dtype, g: torch.Generator):
    """A BN folded in fp32 (``bn_fused_affine``) and rounded to ``dtype``."""
    weight, bias = 1 + 0.3 * torch.randn(c, generator=g), 0.2 * torch.randn(c, generator=g)
    mean, var = 0.3 * torch.randn(c, generator=g), 0.5 + torch.rand(c, generator=g)
    return tuple(v.to(dtype) for v in bn_fused_affine(weight, bias, mean, var))


def _operands(dtype, layout: str, c: int, residual: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    shape = (2, c, 3, 4, 8)
    x = (2 * torch.randn(shape, generator=g)).to(dtype).contiguous(memory_format=LAYOUTS[layout])
    z = torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=LAYOUTS[layout])
    return x, *_affine(c, dtype, g), (z if residual else None)


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["no_z", "z"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_twin_rounds_once(dtype, layout, residual, relu, c):
    x, scale, shift, z = _operands(dtype, layout, c, residual, seed=c)
    assert tk.bn_act_layout(x, z) == layout
    got = tk.bn_act(x, scale, shift, z, relu)
    assert got.dtype == dtype and got.shape == x.shape and got.stride() == x.stride()
    view = (1, -1, 1, 1, 1)
    prod, b = x.double() * scale.double().view(view), shift.double().view(view)
    r = torch.zeros_like(prod) if z is None else z.double()
    exact = prod + b + r
    # fp32 rounds the exact x * scale + shift once, then its sum with z once:
    # each moves it by at most 2^-24 of what it rounds (twice that here)
    tol = 2.0 ** -23 * ((prod + b).abs() + (exact.abs() if z is not None else 0))
    act = torch.relu if relu else (lambda t: t)
    lo, hi, want = act(exact - tol).to(dtype), act(exact + tol).to(dtype), act(exact).to(dtype)
    in_fp32 = ((prod + b).float().double() == prod + b) & (exact.float().double() == exact)
    near = (lo != hi) & ~in_fp32  # a halfway point within fp32's error: either neighbour
    assert torch.equal(got[~near], want[~near])
    assert ((lo <= got) & (got <= hi))[near].all()
    assert near.double().mean() < 0.01


def test_twin_and_aten_differ_by_aten_roundings():
    """ATen's ops round after the multiply, the shift and the residual; the
    pass rounds once: the two differ by at most those roundings."""
    x, scale, shift, z = _operands(torch.bfloat16, "ndhwc", 32, True, seed=3)
    got = tk.bn_act(x, scale, shift, z, True)
    view = (1, -1, 1, 1, 1)
    aten = torch.relu(x * scale.view(view) + shift.view(view) + z)
    assert _within_roundings(got, aten, x, scale, shift, z)
    assert not torch.equal(got, aten)  # one rounding where ATen has three


def _ulp(v: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values at |v|."""
    info = torch.finfo(dtype)
    return info.eps * torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(info.tiny))))


def _within_roundings(got, aten, x, scale, shift, z) -> bool:
    """|got - aten| within the roundings ATen makes and the pass does not."""
    view = (1, -1, 1, 1, 1)
    prod = x.double() * scale.double().view(view)
    terms = [prod.abs(), prod.abs() + shift.double().abs().view(view)]
    if z is not None:
        terms.append(terms[-1] + z.double().abs())
    bound = sum(_ulp(t, x.dtype) for t in terms)
    return bool(((got.double() - aten.double()).abs() <= bound).all())


def test_layouts_the_pass_takes_and_refuses():
    """Every dense layout is taken, whatever its sizes and alignment (the
    kernel has a path for each); tensors dense in no one layout, or another
    dtype, raise."""
    x, scale, shift, z = _operands(torch.bfloat16, "ndhwc", 16, True)
    assert tk.bn_act_layout(x) == tk.bn_act_layout(x, z) == "ndhwc"
    ncdhw = z.contiguous()
    flat = torch.zeros(2 * 16 * 96 + 1, dtype=torch.bfloat16)
    flat[1:] = ncdhw.flatten()
    g = torch.Generator().manual_seed(7)
    taken = {
        "ncdhw": (ncdhw, None, "ncdhw"),
        "pooled, dense in both: read NDHWC": (ncdhw[:, :, :1, :1, :1].contiguous(), None, "ndhwc"),
        "pooled, C % 8: read NCDHW": (ncdhw[:, :12, :1, :1, :1].contiguous(), None, "ncdhw"),
        "misaligned view": (flat[1:].view(2, 16, 3, 4, 8), ncdhw, "ncdhw"),
        "ndhwc, C % 8": (torch.randn(2, 12, 3, 4, 8, generator=g).bfloat16().contiguous(
            memory_format=CL), None, "ndhwc"),
        "ncdhw, N * H * W % 8": (torch.randn(2, 16, 3, 4, 5, generator=g).bfloat16(), None,
                                 "ncdhw"),
        "4-D channels last": (torch.randn(2, 16, 4, 5, generator=g).bfloat16().contiguous(
            memory_format=torch.channels_last), None, "ndhwc"),
    }
    for what, (a, b, layout) in taken.items():
        assert tk.bn_act_layout(a, b) == layout, what
        c = a.shape[1]
        got = tk.bn_act(a, scale[:c], shift[:c], b, True)
        assert got.stride() == a.stride(), what
        assert torch.equal(got, tk.bn_act_ref(a.contiguous(), scale[:c], shift[:c],
                                              None if b is None else b.contiguous(), True)), what
    refused = {
        "mixed layouts": (x, ncdhw),
        "fp32": (x.float(), None),
        "z in another dtype": (x, z.half()),
        "z of another shape": (x, z[:1]),
        "not dense": (x[:, :, :2], None),
    }
    for what, (a, b) in refused.items():
        assert tk.bn_act_layout(a, b) is None, what
        with pytest.raises(ValueError, match="bn_act takes"):
            tk.bn_act(a, scale[:a.shape[1]], shift[:a.shape[1]], b)


def test_gate_sends_recording_and_fp32_to_aten():
    """``affine_act``: the pass for every 16-bit activation outside autograd
    (one it cannot read raises: nothing else runs it), ATen's ops while
    autograd records or in fp32, bit for bit ``batch_norm`` there."""
    x, scale, shift, _ = _operands(torch.bfloat16, "ndhwc", 16, False)
    assert norm.takes_pass(x, scale, shift)
    scale.requires_grad_()
    assert not norm.takes_pass(x, scale, shift)  # autograd records
    with torch.no_grad():
        assert norm.takes_pass(x, scale, shift)
        assert norm.takes_pass(x[:, :, :2], scale, shift)
        with pytest.raises(ValueError, match="bn_act takes"):
            norm.affine_act(x[:, :, :2], scale, shift)
    assert not norm.takes_pass(x.float(), scale, shift)
    g = torch.Generator().manual_seed(5)
    weight, bias = 1 + 0.3 * torch.randn(16, generator=g), 0.2 * torch.randn(16, generator=g)
    mean, var = 0.3 * torch.randn(16, generator=g), 0.5 + torch.rand(16, generator=g)
    xf = torch.randn(2, 16, 3, 4, 8, generator=g)
    profiling.reset()
    try:
        with profiling.collect():
            got = norm.affine_act(xf, *bn_fused_affine(weight, bias, mean, var))
            fused = norm.affine_act(x, *_affine(16, torch.bfloat16, g), relu=True)
        counted = profiling.counters()
    finally:
        profiling.reset()
    assert torch.equal(got, batch_norm(xf, mean, var, weight, bias))
    assert fused.dtype == torch.bfloat16
    assert counted == {"stock.bn_aten": 1, "stock.bn_fused": 1}


# --- bf16 eval forwards -------------------------------------------------------

#: network -> load_params_auto's arguments and the stack it serves (B, N, H, W)
NETWORKS = {"dffnet_packed": ({"packed": True}, (1, 4, 64, 96)),
            "dffnet_unpacked": ({"packed": False}, (1, 4, 64, 96)),
            "e2e": ({"arch": "e2e"}, (1, 10, 64, 96)),
            "dfv": ({"arch": "dfv"}, (1, 5, 64, 96)),
            "ddffnet": ({"arch": "ddffnet"}, (1, 10, 64, 96))}
#: eval BNs a forward applies: DFFNet's 55 outside the FM kernels,
#: FlowNetwork's 10 on stock layers, DFV's 61, DDFFNet's 25
BNS = {"dffnet_packed": 55, "dffnet_unpacked": 55, "e2e": 65, "dfv": 61, "ddffnet": 25}
#: networks with no residual add after a BN
NO_RESIDUAL = {"ddffnet"}


def _net(name: str, seed: int = 0):
    kw, _ = NETWORKS[name]
    net = load_params_auto(seed, device="cpu", **kw)
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


def _inputs(name: str, dtype):
    b, n, h, w = NETWORKS[name][1]
    g = torch.Generator().manual_seed(7)
    fs = (torch.rand((b, n, h, w, 3), generator=g) * 2 - 1).to(dtype)
    fd = torch.linspace(0.2, 1.5, n).expand(b, n).contiguous()
    return (fs, fd, torch.linspace(1.0, 1.03, n)[None]) if name == "e2e" else (fs, fd)


def _counted(net, args) -> tuple:
    """A forward's outputs and its ``stock.bn_*`` counters."""
    profiling.reset()
    try:
        with profiling.collect():
            out = net(*args)
        counted = {k: v for k, v in profiling.counters().items() if k.startswith("stock.bn")}
    finally:
        profiling.reset()
    return out, counted


def _rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


@pytest.fixture(scope="module")
def forwards():
    """Each network's bf16 eval forward with the pass (every call of the
    pass recorded), with the gate forced off, and in fp32."""
    runs = {}
    for name in NETWORKS:
        net = _net(name).eval()
        calls, bn_calls = [], []
        hooks = [m.register_forward_hook(lambda *a: bn_calls.append(1))
                 for m in net.modules() if isinstance(m, BatchNorm3d)]
        real = tk.bn_act

        def recording(x, scale, shift, z=None, relu=False, _real=real):
            y = _real(x, scale, shift, z, relu)
            calls.append((x, scale, shift, z, relu, y))
            return y

        with torch.no_grad():
            tk.bn_act = recording
            try:
                fused, counted = _counted(net, _inputs(name, torch.bfloat16))
            finally:
                tk.bn_act = real
            for h in hooks:
                h.remove()
            takes_pass = norm.takes_pass
            norm.takes_pass = lambda *a, **k: False
            try:
                aten, aten_counted = _counted(net, _inputs(name, torch.bfloat16))
            finally:
                norm.takes_pass = takes_pass
            fp32, fp32_counted = _counted(net, _inputs(name, torch.float32))
        runs[name] = {"net": net, "fused": fused, "counted": counted, "calls": calls,
                      "bn_modules": len(bn_calls), "aten": aten, "aten_counted": aten_counted,
                      "fp32": fp32, "fp32_counted": fp32_counted}
    return runs


@pytest.mark.parametrize("name", list(NETWORKS))
def test_every_eval_bn_takes_the_pass(forwards, name):
    run = forwards[name]
    packed = any(isinstance(m, DFFNet) and m.packed for m in run["net"].modules())
    packed_affines = 3 if packed else 0  # the packed stage's, applied from packed affines
    assert run["bn_modules"] + packed_affines == BNS[name]
    assert run["counted"] == {"stock.bn_fused": BNS[name]} == {"stock.bn_fused": len(run["calls"])}
    assert run["aten_counted"] == {"stock.bn_aten": BNS[name]}


def test_chip_smoke_expects_the_passes_counted_here():
    """``chip_smoke.py`` holds the card's ``bn_act`` launches, a bf16 forward,
    to the counts these forwards show."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert BNS["dffnet_packed"] == BNS["dffnet_unpacked"]
    assert chip_smoke.BN_PASSES == {"dffnet": BNS["dffnet_packed"], "e2e": BNS["e2e"],
                                    "flownet": BNS["e2e"] - BNS["dffnet_packed"],
                                    "ddffnet": BNS["ddffnet"]}


@pytest.mark.parametrize("name", list(NETWORKS))
def test_each_pass_is_atens_ops_within_their_roundings(forwards, name):
    """At every site of the forward, on the operands it got there: the pass
    (residual and ReLU as the site asks) against ATen's ops."""
    relu_sites = residual_sites = 0
    for x, scale, shift, z, relu, y in forwards[name]["calls"]:
        view = (1, -1, 1, 1, 1)
        aten = x * scale.view(view) + shift.view(view)
        aten = aten if z is None else aten + z
        aten = torch.relu(aten) if relu else aten
        assert _within_roundings(y, aten, x, scale, shift, z)
        relu_sites += relu
        residual_sites += z is not None
    assert relu_sites > 0 and (residual_sites > 0) == (name not in NO_RESIDUAL)


@pytest.mark.parametrize("name", list(NETWORKS))
def test_forward_matches_the_gate_off_within_bf16s_rounding(forwards, name):
    """The pass rounds once where ATen rounds two to four times: each output
    lies no farther from the fp32 forward than the gate-off forward's does,
    with a quarter of room for the way rounding spreads through the network."""
    run = forwards[name]
    for got, aten, ref in zip(run["fused"], run["aten"], run["fp32"]):
        assert got.dtype == aten.dtype and got.shape == aten.shape
        assert _rms(got, ref) <= 1.25 * _rms(aten, ref) + 1e-4


@pytest.mark.parametrize("name", list(NETWORKS))
def test_fp32_and_train_forwards_take_no_pass(forwards, name):
    """fp32 eval keeps ATen's ops (bit for bit ``batch_norm``, which the fp32
    goldens hold); a train-mode forward (fp32, as the train step runs)
    applies batch statistics and counts neither."""
    assert forwards[name]["fp32_counted"] == {"stock.bn_aten": BNS[name]}
    net = _net(name).train()
    _, counted = _counted(net, _inputs(name, torch.float32))
    assert counted == {}


def test_state_dict_keys_are_the_references():
    """The rewired call sites keep every module and key: DFFNet's and the
    end-to-end network's are the JAX package's parameters, DFV's the plain
    reference's."""
    assert set(_net("dffnet_packed").state_dict()) == set(jinit(network_specs(), 0))
    assert set(_net("e2e").state_dict()) == set(jinit(e2e_network_specs(), 0))
    assert set(_net("dfv").state_dict()) == set(port_state_dict(DFVReference()))
