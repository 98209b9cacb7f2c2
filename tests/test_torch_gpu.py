"""dffx_torch's CUDA kernels on the card, each against its plain twin.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports no JAX, so on a machine with a GPU and no JAX it runs alone, without
the suite's conftest (which sets JAX up):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from dffx_torch.models import E2ENetwork, Network
from dffx_torch.ops import kernels as tk

pytestmark = pytest.mark.gpu
SHAPES = [(1, 3, 64, 96), (2, 1, 40, 72), (1, 2, 7, 5)]  # (b, n, h, w); ragged edges
DFFNET_KERNELS = ("fm_conv_bn_relu", "rb2d_residual", "srd_attention_residual")
#: launches of each kernel in one E2E forward: three pyramid chains, one head
E2E_LAUNCHES = {"fm_conv_bn_relu": 1, "rb2d_residual": 1, "srd_attention_residual": 1,
                "rb_of_chain": 3, "motion_head_conv_chain": 1}
CHAINS = [((3, 8), (8, 8)), ((16, 16),), ((32, 32),)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tk.reset_launches()
    return torch.device("cuda")


def _act(rng, shape, dev):
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)


def _wt(rng, shape, dev):
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).to(dev)


def _aff(rng, c, dev):
    g, b = rng.standard_normal(c), rng.standard_normal(c)
    mu, va = rng.standard_normal(c) * 0.1, rng.random(c) + 0.5
    return tuple(t.to(dev) for t in tk.bn_fused_affine(
        *(torch.from_numpy(a.astype(np.float32)) for a in (g, b, mu, va))))


@pytest.mark.parametrize("b,n,h,w", SHAPES)
def test_fm_conv_bn_relu_matches_twin(cuda, rng, b, n, h, w):
    args = (_act(rng, (b, 3, n, h, w), cuda), _wt(rng, (8, 3, 1, 9, 9), cuda),
            *_aff(rng, 8, cuda))
    got = tk.fm_conv_bn_relu(*args)
    torch.cuda.synchronize()
    assert tk.launches["fm_conv_bn_relu"] == 1
    torch.testing.assert_close(got, tk.fm_conv_bn_relu_ref(*args), atol=1e-4, rtol=0)


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("b,n,h,w", SHAPES)
def test_rb2d_and_attention_match_twins(cuda, rng, b, n, h, w, c):
    x = _act(rng, (b, c, n, h, w), cuda)
    args = (x, _wt(rng, (c, c, 1, 3, 3), cuda), _aff(rng, c, cuda),
            _wt(rng, (c, c, 1, 3, 3), cuda), _aff(rng, c, cuda))
    got = tk.rb2d_residual(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.rb2d_residual_ref(*args), atol=1e-4, rtol=0)
    args = (x, _wt(rng, (c, c, 3, 1, 1), cuda), _wt(rng, (c, c, 1, 1, 1), cuda))
    got = tk.srd_attention_residual(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.srd_attention_residual_ref(*args), atol=1e-4, rtol=0)
    assert tk.launches["rb2d_residual"] == 1 and tk.launches["srd_attention_residual"] == 1


def _chain_args(rng, b, n, h, w, chans, dev):
    x = _act(rng, (b, chans[0][0], n, h, w), dev)
    return x, [(_wt(rng, (co, ci, 1, 3, 3), dev), _aff(rng, co, dev),
                _wt(rng, (co, co, 1, 3, 3), dev), _aff(rng, co, dev),
                _wt(rng, (co, ci, 1, 1, 1), dev)) for ci, co in chans]


def _head_args(rng, b, n, h, w, dev):
    return (_act(rng, (b, 18, n, h, w), dev), _wt(rng, (16, 18, 1, 3, 3), dev), _aff(rng, 16, dev),
            _wt(rng, (16, 16, 1, 3, 3), dev), _aff(rng, 16, dev),
            _wt(rng, (16, 16, 1, 3, 3), dev), _aff(rng, 16, dev),
            _wt(rng, (3, 16, 1, 3, 3), dev), _wt(rng, (3,), dev))


@pytest.mark.parametrize("chans", CHAINS, ids=["fe1_pair", "c16", "c32"])
@pytest.mark.parametrize("b,n,h,w", SHAPES)
def test_rb_of_chain_matches_twin(cuda, rng, b, n, h, w, chans):
    x, blocks = _chain_args(rng, b, n, h, w, chans, cuda)
    got = tk.rb_of_chain(x, blocks)
    torch.cuda.synchronize()
    assert tk.launches["rb_of_chain"] == 1
    torch.testing.assert_close(got, tk.rb_of_chain_ref(x, blocks), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,n,h,w", SHAPES)
def test_motion_head_conv_chain_matches_twin(cuda, rng, b, n, h, w):
    args = _head_args(rng, b, n, h, w, cuda)
    got = tk.motion_head_conv_chain(*args)
    torch.cuda.synchronize()
    assert tk.launches["motion_head_conv_chain"] == 1
    torch.testing.assert_close(got, tk.motion_head_conv_chain_ref(*args), atol=1e-4, rtol=0)


def test_bf16_rounds_only_the_output(cuda, rng):
    """bf16 in, fp32 inside: within half a bf16 ulp (< 2^-8 |max|) of the fp32 twin."""
    x = _act(rng, (1, 3, 2, 40, 72), cuda).bfloat16()
    args = (_wt(rng, (8, 3, 1, 9, 9), cuda), *_aff(rng, 8, cuda))
    got = tk.fm_conv_bn_relu(x, *args)
    assert got.dtype == torch.bfloat16
    ref = tk.fm_conv_bn_relu_ref(x.float(), *args)
    bound = 2.0 ** -8 * ref.abs().max().item() + 1e-4
    assert (got.float() - ref).abs().max().item() <= bound
    x, blocks = _chain_args(rng, 1, 2, 40, 72, CHAINS[0], cuda)
    got = tk.rb_of_chain(x.bfloat16(), blocks)
    ref = tk.rb_of_chain_ref(x.bfloat16().float(), blocks)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() <= 2.0 ** -8 * ref.abs().max().item() + 1e-4
    x, *args = _head_args(rng, 1, 2, 40, 72, cuda)
    got = tk.motion_head_conv_chain(x.bfloat16(), *args)
    ref = tk.motion_head_conv_chain_ref(x.bfloat16().float(), *args)
    assert (got.float() - ref).abs().max().item() <= 2.0 ** -8 * ref.abs().max().item() + 1e-4


@pytest.mark.parametrize("chans", CHAINS, ids=["fe1_pair", "c16", "c32"])
@pytest.mark.parametrize("b,n,h,w", [(1, 2, 40, 72), (2, 3, 7, 5)])
def test_rb_of_chain_bf16_rounds_only_the_output(cuda, rng, b, n, h, w, chans):
    """bf16 in, fp32 inside (3xTF32 on the tensor cores at 16 and 32 channels):
    within half a bf16 ulp (< 2^-8 |max|) of the fp32 twin."""
    x, blocks = _chain_args(rng, b, n, h, w, chans, cuda)
    got = tk.rb_of_chain(x.bfloat16(), blocks)
    ref = tk.rb_of_chain_ref(x.bfloat16().float(), blocks)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() <= 2.0 ** -8 * ref.abs().max().item() + 1e-4


@pytest.mark.parametrize("chans,shape", [
    (((32, 32),), (2, 10, 152, 272)),  # 3,420 tiles: many per block of the persistent grid
    (((16, 16),), (1, 10, 304, 544)),
    (((16, 16),), (1, 3, 7, 5)),       # fewer tiles than blocks, ragged
    (((32, 32),), (1, 3, 7, 5)),
], ids=["c32_b2_fe3", "c16_fe2", "c16_tiny", "c32_tiny"])
def test_rb_of_chain_persistent_grid_matches_twin(cuda, rng, chans, shape):
    x, blocks = _chain_args(rng, *shape, chans, cuda)
    got = tk.rb_of_chain(x, blocks)
    torch.cuda.synchronize()
    assert tk.launches["rb_of_chain"] == 1
    torch.testing.assert_close(got, tk.rb_of_chain_ref(x, blocks), atol=1e-4, rtol=0)


def _bf16_bound(ref):
    """bf16 in, fp32 inside: half a bf16 ulp (< 2^-8 |max|) of the fp32 twin, plus
    1e-4 for the order of the fp32 sums."""
    return 2.0 ** -8 * ref.abs().max().item() + 1e-4


#: the persistent grids of fm_conv_bn_relu, motion_head_conv_chain, rb2d_residual
#: and rb_of_chain's pair: more tiles than blocks; H and W no multiple of the
#: tile or of 4; less than one tile
GRID_SHAPES = [(2, 10, 304, 544), (1, 3, 45, 101), (1, 1, 3, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,h,w", GRID_SHAPES, ids=["many_tiles", "odd", "strip"])
def test_fm_conv_persistent_grid_matches_twin(cuda, rng, b, n, h, w, dtype):
    x = _act(rng, (b, 3, n, h, w), cuda).to(dtype)
    args = (_wt(rng, (8, 3, 1, 9, 9), cuda), *_aff(rng, 8, cuda))
    got = tk.fm_conv_bn_relu(x, *args)
    torch.cuda.synchronize()
    assert tk.launches["fm_conv_bn_relu"] == 1 and got.dtype == dtype
    ref = tk.fm_conv_bn_relu_ref(x.float(), *args)
    bound = 1e-4 if dtype == torch.float32 else _bf16_bound(ref)
    assert (got.float() - ref).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,h,w", GRID_SHAPES, ids=["many_tiles", "odd", "strip"])
def test_motion_head_persistent_grid_matches_twin(cuda, rng, b, n, h, w, dtype):
    x, *args = _head_args(rng, b, n, h, w, cuda)
    x = x.to(dtype)
    got = tk.motion_head_conv_chain(x, *args)
    torch.cuda.synchronize()
    assert tk.launches["motion_head_conv_chain"] == 1 and got.dtype == dtype
    ref = tk.motion_head_conv_chain_ref(x.float(), *args)
    bound = 1e-4 if dtype == torch.float32 else _bf16_bound(ref)
    assert (got.float() - ref).abs().max().item() <= bound


def _rb2d_args(rng, b, n, h, w, c, dev):
    return (_act(rng, (b, c, n, h, w), dev), _wt(rng, (c, c, 1, 3, 3), dev), _aff(rng, c, dev),
            _wt(rng, (c, c, 1, 3, 3), dev), _aff(rng, c, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,h,w", GRID_SHAPES, ids=["many_tiles", "odd", "strip"])
def test_rb2d_persistent_grid_matches_twin(cuda, rng, b, n, h, w, dtype):
    """bf16 in, fp32 inside: the kernel rounds only its output."""
    x, *args = _rb2d_args(rng, b, n, h, w, 8, cuda)
    x = x.to(dtype)
    got = tk.rb2d_residual(x, *args)
    torch.cuda.synchronize()
    assert tk.launches["rb2d_residual"] == 1 and got.dtype == dtype
    kept = tk.rb2d_residual(x, *args, params=tk.rb2d_params(x, *args))
    assert torch.equal(kept, got)
    ref = tk.rb2d_residual_ref(x.float(), *args)
    bound = 1e-4 if dtype == torch.float32 else _bf16_bound(ref)
    assert (got.float() - ref).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,h,w", GRID_SHAPES, ids=["many_tiles", "odd", "strip"])
def test_rb_of_pair_persistent_grid_matches_twin(cuda, rng, b, n, h, w, dtype):
    """The 3 -> 8 -> 8 pair; bf16 in, fp32 inside: it rounds only its output."""
    x, blocks = _chain_args(rng, b, n, h, w, CHAINS[0], cuda)
    x = x.to(dtype)
    got = tk.rb_of_chain(x, blocks)
    torch.cuda.synchronize()
    assert tk.launches["rb_of_chain"] == 1 and got.dtype == dtype
    ref = tk.rb_of_chain_ref(x.float(), blocks)
    bound = 1e-4 if dtype == torch.float32 else _bf16_bound(ref)
    assert (got.float() - ref).abs().max().item() <= bound


@pytest.mark.parametrize("c", [8, 16, 32])
def test_rb2d_takes_more_than_65535_slices(cuda, rng, c):
    """B * N is no grid dimension of rb2d_residual's launch."""
    args = _rb2d_args(rng, 1, 65537, 2, 3, c, cuda)
    got = tk.rb2d_residual(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.rb2d_residual_ref(*args), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,n", [(1, 65537), (65537, 1)], ids=["slices", "batches"])
def test_srd_attention_takes_more_than_65535_slices_or_stacks(cuda, rng, b, n):
    """N is walked inside a thread and B is part of the block index."""
    args = (_act(rng, (b, 8, n, 2, 3), cuda), _wt(rng, (8, 8, 3, 1, 1), cuda),
            _wt(rng, (8, 8, 1, 1, 1), cuda))
    got = tk.srd_attention_residual(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.srd_attention_residual_ref(*args), atol=1e-4, rtol=0)


def test_fm_conv_and_motion_head_take_more_than_65535_slices(cuda, rng):
    """B * N is no grid dimension of their launches."""
    x = _act(rng, (1, 3, 65537, 2, 3), cuda)
    args = (_wt(rng, (8, 3, 1, 9, 9), cuda), *_aff(rng, 8, cuda))
    got = tk.fm_conv_bn_relu(x, *args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.fm_conv_bn_relu_ref(x, *args), atol=1e-4, rtol=0)
    args = _head_args(rng, 1, 65537, 2, 3, cuda)
    got = tk.motion_head_conv_chain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.motion_head_conv_chain_ref(*args), atol=1e-4, rtol=0)


@pytest.mark.parametrize("chans", CHAINS, ids=["fe1_pair", "c16", "c32"])
def test_rb_of_chain_takes_more_than_65535_slices(cuda, rng, chans):
    """B * N is no grid dimension of rb_of_chain's launches."""
    x, blocks = _chain_args(rng, 1, 65537, 2, 3, chans, cuda)
    got = tk.rb_of_chain(x, blocks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.rb_of_chain_ref(x, blocks), atol=1e-4, rtol=0)


def test_wrappers_refuse_non_contiguous_and_unbuilt_widths(cuda, rng):
    x = _act(rng, (1, 8, 2, 16, 16), cuda)
    aff = _aff(rng, 8, cuda)
    w = _wt(rng, (8, 8, 1, 3, 3), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tk.rb2d_residual(x.transpose(3, 4), w, aff, w, aff)
    with pytest.raises(ValueError, match="params"):  # another width's packed weights
        tk.rb2d_residual(x, w, aff, w, aff, params=torch.zeros(2 * (9 * 256 + 32), device=cuda))
    x12 = _act(rng, (1, 12, 2, 16, 16), cuda)
    with pytest.raises(ValueError, match="C in"):
        tk.srd_attention_residual(x12, _wt(rng, (12, 12, 3, 1, 1), cuda),
                                  _wt(rng, (12, 12, 1, 1, 1), cuda))
    x, blocks = _chain_args(rng, 1, 2, 16, 16, ((8, 16),), cuda)
    with pytest.raises(ValueError, match="chains"):
        tk.rb_of_chain(x, blocks)
    with pytest.raises(ValueError, match=r"\(Cin, C\)"):  # the conv2 head's width
        tk.motion_head_conv_chain(
            _act(rng, (1, 34, 2, 16, 16), cuda), _wt(rng, (32, 34, 1, 3, 3), cuda),
            _aff(rng, 32, cuda), _wt(rng, (32, 32, 1, 3, 3), cuda), _aff(rng, 32, cuda),
            _wt(rng, (32, 32, 1, 3, 3), cuda), _aff(rng, 32, cuda),
            _wt(rng, (3, 32, 1, 3, 3), cuda), _wt(rng, (3,), cuda))
    assert tk.launches == dict.fromkeys(tk.launches, 0)


def test_network_on_the_card_matches_cpu(cuda, rng):
    from dffx_torch.eval import load_params_auto

    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 64, 96, 3)).astype(np.float32))
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 4, dtype=np.float32)[None])
    net = load_params_auto(0, device=cuda)
    assert isinstance(net, Network)
    with torch.inference_mode():
        got = net(fs.to(cuda), fd.to(cuda))
        ref = load_params_auto(0, device="cpu")(fs, fd)
    assert {k: tk.launches[k] for k in DFFNET_KERNELS} == dict.fromkeys(DFFNET_KERNELS, 1)
    assert tk.launches["rb_of_chain"] == tk.launches["motion_head_conv_chain"] == 0
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=0)


def test_e2e_network_on_the_card_matches_cpu(cuda, rng):
    from dffx_torch.eval import load_params_auto

    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, 64, 96, 3)).astype(np.float32))
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 10, dtype=np.float32)[None])
    fovs = torch.from_numpy(np.linspace(1.0, 1.05, 10, dtype=np.float32)[None])
    net = load_params_auto(0, device=cuda, e2e=True)
    assert isinstance(net, E2ENetwork)
    with torch.inference_mode():
        got = net(fs.to(cuda), fd.to(cuda), fovs.to(cuda))
        ref = load_params_auto(0, device="cpu", e2e=True)(fs, fd, fovs)
    assert tk.launches == E2E_LAUNCHES
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=0)


def _train_batch(rng, dev, b=2, n=5, h=32, w=32, e2e=False):
    batch = {"fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
             "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32),
             "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32), (b, 1)),
             "mask": rng.random((b, h, w)) > 0.2}
    if e2e:
        batch["fovs"] = np.tile(np.linspace(1.003, 1.05, n, dtype=np.float32), (b, 1))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def test_kept_parameters_follow_the_weights(cuda, rng):
    """The modules keep their kernels' packed weights between forwards; new
    weights (a state dict loaded in place, an optimizer step, a train-mode BN
    update) reach the next forward."""
    from dffx_torch.train import LossConfig, create_train_state, make_train_step
    from dffx_torch.eval import load_params_auto

    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, 64, 96, 3)).astype(np.float32)).to(cuda)
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 10, dtype=np.float32)[None]).to(cuda)
    fovs = torch.from_numpy(np.linspace(1.0, 1.05, 10, dtype=np.float32)[None]).to(cuda)
    net, other = (load_params_auto(s, device=cuda, e2e=True) for s in (0, 1))
    with torch.inference_mode():
        first, again, want = net(fs, fd, fovs), net(fs, fd, fovs), other(fs, fd, fovs)
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)  # two forwards are not bit-equal
    net.load_state_dict(other.state_dict())
    with torch.inference_mode():
        got = net(fs, fd, fovs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    assert (got[3] - first[3]).abs().max().item() > 1e-3
    # one train step writes the weights (Adam) and the BN statistics in place
    state = create_train_state(net, 1e-3)
    make_train_step(1e-3, LossConfig(), e2e=True)(state, _train_batch(rng, cuda, 1, 10, 64, 96,
                                                                      e2e=True))
    net.eval()
    cpu = load_params_auto(1, device="cpu", e2e=True)
    cpu.load_state_dict(net.state_dict())
    tk.reset_launches()
    with torch.inference_mode():
        trained = net(fs, fd, fovs)
        want = cpu(fs.cpu(), fd.cpu(), fovs.cpu())
    assert tk.launches == E2E_LAUNCHES
    assert (trained[3] - got[3]).abs().max().item() > 1e-4
    for g, w in zip(trained, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=0)


def test_train_step_on_the_card_matches_cpu(cuda, rng):
    """One DFFNet step from the same weights and batch: the loss, every
    gradient (``tests/test_torch_train.py``'s bound: 0.25 max|g| + 1e-7 a
    tensor, 5 % L2 over all) and the new BN statistics; no kernel launches."""
    from dffx_torch.eval import load_params_auto
    from dffx_torch.train import LossConfig, create_train_state, make_train_step

    batch = _train_batch(rng, "cpu")
    states = {}
    for dev in ("cpu", cuda):
        state = create_train_state(load_params_auto(0, device=dev, packed=False), 1e-3)
        tk.reset_launches()
        states[dev], logs = make_train_step(1e-3, LossConfig())(
            state, {k: v.to(dev) for k, v in batch.items()})
        states[dev].loss = float(logs["loss"])
    assert tk.launches == dict.fromkeys(tk.launches, 0)
    cpu, gpu = states["cpu"], states[cuda]
    assert abs(gpu.loss - cpu.loss) <= 1e-5 * abs(cpu.loss)
    num = den = 0.0
    for (k, p), q in zip(cpu.model.named_parameters(), gpu.model.parameters()):
        g, w = q.grad.cpu(), p.grad
        assert (g - w).abs().max().item() <= 0.25 * w.abs().max().item() + 1e-7, k
        num, den = num + float(((g - w) ** 2).sum()), den + float((w ** 2).sum())
    assert num <= 0.05 ** 2 * den
    want, got = cpu.model.state_dict(), gpu.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(w), k
        elif k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[k].cpu(), w, rtol=1e-5, atol=1e-6)


def _kernel_call(rng, name, dev):
    """(wrapper, args, index of a weight among args) at a small shape."""
    if name == "fm_conv_bn_relu":
        return tk.fm_conv_bn_relu, [_act(rng, (1, 3, 2, 16, 24), dev),
                                    _wt(rng, (8, 3, 1, 9, 9), dev), *_aff(rng, 8, dev)], 1
    if name == "rb2d_residual":
        return tk.rb2d_residual, list(_rb2d_args(rng, 1, 2, 16, 24, 8, dev)), 1
    if name == "srd_attention_residual":
        return tk.srd_attention_residual, [_act(rng, (1, 8, 2, 16, 24), dev),
                                           _wt(rng, (8, 8, 3, 1, 1), dev),
                                           _wt(rng, (8, 8, 1, 1, 1), dev)], 2
    if name == "rb_of_chain":
        x, blocks = _chain_args(rng, 1, 2, 16, 24, CHAINS[1], dev)
        return (lambda x, ws: tk.rb_of_chain(x, [(blocks[0][0], *blocks[0][1:4], ws)]),
                [x, blocks[0][4]], 1)
    return tk.motion_head_conv_chain, list(_head_args(rng, 1, 2, 16, 24, dev)), 7


@pytest.mark.parametrize("name", sorted(E2E_LAUNCHES))
def test_wrappers_refuse_to_cut_a_gradient(cuda, rng, name):
    """The kernels have no backward: with grad enabled, a weight, an affine or
    the input that requires grad makes the wrapper raise, naming itself; it
    does not switch to its twin.  Under ``no_grad`` it launches."""
    fn, args, wi = _kernel_call(rng, name, cuda)
    fn(*args)  # nothing requires grad: it launches with grad enabled
    assert tk.launches[name] == 1
    for count, i in ((1, wi), (2, 0)):
        args[i].requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no backward"):
            fn(*args)
        assert tk.launches[name] == count  # it raised before the launch
        with torch.no_grad():
            out = fn(*args)
        assert not out.requires_grad and tk.launches[name] == count + 1
        args[i].requires_grad_(False)


def test_module_forward_with_gradients_raises_on_the_card(cuda, rng):
    """A module's parameters require grad by default: outside ``no_grad`` a CUDA
    forward raises at the first kernel where it once returned heads whose
    graph stopped there."""
    from dffx_torch.eval import load_params_auto

    net = load_params_auto(0, device=cuda)
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)).to(cuda)
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 2, dtype=np.float32)[None]).to(cuda)
    with pytest.raises(RuntimeError, match="fm_conv_bn_relu: the CUDA kernel has no backward"):
        net(fs, fd)
    with torch.no_grad():
        assert all(torch.isfinite(t).all() for t in net(fs, fd))


@pytest.mark.parametrize("e2e", [False, True], ids=["dffnet", "e2e"])
def test_train_mode_forward_on_the_card_launches_no_kernel(cuda, rng, e2e):
    """In training mode every module runs on stock ops: with gradients the
    forward does not raise, launches no kernel, and the backward reaches
    every used parameter."""
    from dffx_torch.eval import load_params_auto

    net = load_params_auto(0, device=cuda, e2e=e2e).train()
    batch = _train_batch(rng, cuda, 1, 10, 32, 32, e2e=e2e)
    extra = (batch["fovs"],) if e2e else ()
    tk.reset_launches()
    outs = net(batch["fs"], batch["focus_dists"], *extra)
    sum(o.float().sum() for o in outs[:4]).backward()
    torch.cuda.synchronize()
    assert tk.launches == dict.fromkeys(tk.launches, 0)
    unused = [k for k, p in net.named_parameters() if p.grad is None]
    assert all(".pre_conv." in k or ".redir3." in k for k in unused), unused


@pytest.mark.parametrize("e2e", [False, True], ids=["dffnet", "e2e"])
def test_packed_forward_on_the_card_matches_unpacked(cuda, rng, e2e):
    """fp32 within 1e-4 on every head; bf16 packed against fp32 unpacked under a
    stated bound: 15 % of the focus range (a whole bf16 forward is some forty
    convs deep; on the card at 10 x 384 x 384 the unpacked bf16 forward is up
    to 7 % of the range from its fp32, ``chip_smoke.py``'s ``forward_vs_cpu``)."""
    from dffx_torch.eval import load_params_auto

    h, w = (64, 160) if e2e else (64, 96)
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, h, w, 3)).astype(np.float32)).to(cuda)
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 10, dtype=np.float32)[None]).to(cuda)
    extra = (torch.from_numpy(np.linspace(1.0, 1.05, 10, dtype=np.float32)[None]).to(cuda),
             ) if e2e else ()
    plain, packed = (load_params_auto(0, device=cuda, e2e=e2e, packed=p) for p in (False, True))
    with torch.inference_mode():
        ref = plain(fs, fd, *extra)
        tk.reset_launches()
        got = packed(fs, fd, *extra)
        assert tk.launches == (E2E_LAUNCHES if e2e else
                               {**dict.fromkeys(E2E_LAUNCHES, 0),
                                **dict.fromkeys(DFFNET_KERNELS, 1)})
        half = packed(fs.bfloat16(), fd, *extra)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=0)
    for g, r in zip(half[:4], ref[:4]):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r).abs().max().item() <= 0.15 * (1.5 - 0.1)


def test_kept_packed_weights_follow_their_sources(cuda, rng):
    """``DFFNet`` keeps its packed weights per device and dtype; a source
    weight written in place, or a state dict loaded, reaches the next forward."""
    from dffx_torch.eval import load_params_auto

    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 64, 96, 3)).astype(np.float32)).to(cuda)
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 3, dtype=np.float32)[None]).to(cuda)
    packed, plain = (load_params_auto(0, device=cuda, packed=p) for p in (True, False))
    with torch.inference_mode():
        first = packed(fs, fd)
        kept = packed.DFF_net._tail_params._buf
        packed(fs, fd)
        assert packed.DFF_net._tail_params._buf is kept  # made once
        packed(fs.bfloat16(), fd)
        assert packed.DFF_net._tail_params._buf[0].dtype == torch.bfloat16
    with torch.no_grad():
        for net in (packed, plain):
            net.DFF_net.deconv_3[0].weight.mul_(1.5)
            net.DFF_net.FM_conv1[0].stride_conv[0].weight.mul_(0.5)
    with torch.inference_mode():
        got, want = packed(fs, fd), plain(fs, fd)
    assert (got[3] - first[3]).abs().max().item() > 1e-3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    other = load_params_auto(1, device=cuda, packed=False)
    packed.load_state_dict(other.state_dict())
    with torch.inference_mode():
        for g, w in zip(packed(fs, fd), other(fs, fd)):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


# --- the command lines and the prefetch on the card ---------------------------
# The card's installation has no h5py and no imageio (PERF.md §7): these tests
# read cv2, EXR and in-memory data, and keep the depth images in memory.


@pytest.fixture
def no_jpegs(monkeypatch):
    """``imageio`` whose ``imwrite`` keeps each image in a list."""
    import sys
    import types

    kept = []
    imageio = types.ModuleType("imageio")
    imageio.imwrite = lambda path, image, **kw: kept.append((str(path), image))
    monkeypatch.setitem(sys.modules, "imageio", imageio)
    return kept


def _cli(main, argv) -> dict:
    """Run a command line in-process; returns its ``Avg_*`` prints."""
    import torch_fixtures as fx

    vals = {}
    for line in fx.run_cli(main, argv).splitlines():
        key, sep, value = line.partition(":")
        if sep and key.strip().startswith("Avg_"):
            vals[key.strip()] = float(value)
    return vals


def test_prefetch_pins_and_copies_on_a_side_stream(cuda, rng, monkeypatch):
    """Each array is pinned and copied with ``non_blocking`` on a stream other
    than the consumer's; what arrives equals a synchronous copy."""
    from dffx_torch.data import device_prefetch

    batches = [{"fs": rng.uniform(-1, 1, (4, 10, 64, 96, 3)).astype(np.float32),
                "mask": rng.random((4, 64, 96)) > 0.5} for _ in range(3)]
    seen, to = [], torch.Tensor.to

    def spy(self, *args, **kw):
        if self.device.type == "cpu":
            seen.append((self.is_pinned(), kw.get("non_blocking"),
                         torch.cuda.current_stream() != torch.cuda.default_stream()))
        return to(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    got = [dev for _, dev in device_prefetch(iter(batches), cuda, ("fs", "mask"))]
    monkeypatch.undo()
    assert seen == [(True, True, True)] * 6
    for b, g in zip(batches, got):
        for k in b:
            assert g[k].device.type == "cuda"
            assert torch.equal(g[k], torch.from_numpy(b[k]).to(cuda))


def test_eval_cli_on_the_card_matches_cpu(cuda, tmp_path, no_jpegs):
    """DefocusNet at 5 x 64 x 64, batch 8 (two stacks a forward): the metrics
    on the card within 1e-4 relative of the CPU's, one launch of each DFFNet
    kernel a forward."""
    import torch_fixtures as fx
    from dffx_torch.eval import test as T

    data = fx.write_fs6(str(tmp_path), modes=("test",))[: -len("fs_6/")]
    argv = ["--dataset", "DefocusNet", "--data-root", data, "--allow-random-init"]
    want = _cli(T.main, argv + ["--results-root", str(tmp_path / "cpu"), "--device", "cpu"])
    tk.reset_launches()
    got = _cli(T.main, argv + ["--results-root", str(tmp_path / "gpu")])
    assert {k: tk.launches[k] for k in DFFNET_KERNELS} == dict.fromkeys(DFFNET_KERNELS, 1)
    assert sorted(got) == sorted(want) and len(want) == 9
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert len(no_jpegs) == 4


def test_real_scenes_cli_on_the_card_matches_cpu(cuda, tmp_path, no_jpegs):
    import torch_fixtures as fx
    from dffx_torch.eval import real_scenes as RS

    scenes = fx.write_real_scene(str(tmp_path / "scenes"))
    argv = ["--data-root", scenes, "--allow-random-init"]
    with fx.recording_forwards(RS) as want:
        _cli(RS.main, argv + ["--out", str(tmp_path / "cpu"), "--device", "cpu"])
    tk.reset_launches()
    with fx.recording_forwards(RS) as got:
        _cli(RS.main, argv + ["--out", str(tmp_path / "gpu")])
    assert dict(tk.launches) == E2E_LAUNCHES
    for k, name in ((3, "depth"), (4, "warped")):
        np.testing.assert_allclose(got[0][k], want[0][k], atol=1e-4, rtol=0, err_msg=name)


def test_train_cli_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The DDFF recipe on an in-memory set of 4 stacks of 5 x 32 x 32, batch 4,
    one step an epoch: the first loss within 1e-5 relative of the CPU's, the
    validation launches one of each DFFNet kernel a forward (epochs 0 and 1)
    and the train steps none, ``models/1.ckpt`` written."""
    import torch_fixtures as fx
    from dffx_torch.train import cli
    from dffx_torch.train.recipes import Recipe

    r = np.random.default_rng(0)
    samples = [{"fs": r.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32),
                "depth": r.uniform(0.1, 1.5, (32, 32)).astype(np.float32),
                "focus_dists": np.linspace(0.1, 1.5, 5, dtype=np.float32),
                "mask": np.ones((32, 32), bool), "unpadded": (32, 32)} for _ in range(5)]
    monkeypatch.setattr(Recipe, "make_datasets", lambda self, root, seed: (samples[:4], samples[4:]))
    benchmark = torch.backends.cudnn.benchmark
    argv = ["--recipe", "DDFF", "--lr", "1e-4", "--batch_size", "4", "--cpus", "2",
            "--steps-per-epoch", "1", "--max_epoch", "1"]
    with fx.recording_train(cli) as want:
        _cli(cli.main, argv + ["--saveroot", str(tmp_path / "cpu"), "--device", "cpu"])
    tk.reset_launches()
    try:
        with fx.recording_train(cli) as got:
            _cli(cli.main, argv + ["--saveroot", str(tmp_path / "gpu")])
    finally:
        torch.backends.cudnn.benchmark = benchmark
    assert {k: tk.launches[k] for k in DFFNET_KERNELS} == dict.fromkeys(DFFNET_KERNELS, 2)
    assert tk.launches["rb_of_chain"] == tk.launches["motion_head_conv_chain"] == 0
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)
    assert np.isfinite(got["losses"]).all() and (tmp_path / "gpu" / "models" / "1.ckpt").exists()
