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
#: launches of each kernel in one fp32 E2E forward: three pyramid chains, one
#: head, and no BN pass (fp32 eval BN stays on ATen's ops)
E2E_LAUNCHES = {"fm_conv_bn_relu": 1, "rb2d_residual": 1, "srd_attention_residual": 1,
                "rb_of_chain": 3, "motion_head_conv_chain": 1, "bn_act": 0}
CHAINS = [((3, 8), (8, 8)), ((16, 16),), ((32, 32),)]
#: bf16 pred3 of a DFFNet forward kept NDHWC against the same forward kept
#: NCDHW, over pred3's largest value: 2^-5, four bf16 units in the last place
#: (the two layouts run other cuDNN algorithms, and each conv rounds its fp32
#: sums to bf16; an H100 read 0.7-1.1 % at 2 x 10 x 64 x 96, PERF.md §6)
PRED3_NCDHW_RTOL = 2.0 ** -5


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


#: the bf16 designs of fm_conv_bn_relu and rb2d_residual beyond GRID_SHAPES:
#: W % 8 == 4 (fm_conv stages value by value, rb2d by 8-byte copies) and more
#: slices than a grid dimension holds; rb2d's other widths at every shape
BF16_SHAPES = [(1, 3, 45, 100), (1, 65537, 2, 3)]
BF16_IDS = ["w4", "slices"]
RB2D_BF16 = ([(8, s) for s in BF16_SHAPES]
             + [(c, s) for c in (16, 32) for s in GRID_SHAPES + BF16_SHAPES])
RB2D_BF16_IDS = ([f"c8_{i}" for i in BF16_IDS]
                 + [f"c{c}_{i}" for c in (16, 32) for i in ["many_tiles", "odd", "strip"] + BF16_IDS])


@pytest.mark.parametrize("b,n,h,w", BF16_SHAPES, ids=BF16_IDS)
def test_fm_conv_bf16_matches_twin(cuda, rng, b, n, h, w):
    """bf16 in, fp32 inside: the kernel rounds only its output; a kept
    buffer gives the same bits as one packed on the call."""
    x = _act(rng, (b, 3, n, h, w), cuda).bfloat16()
    args = (_wt(rng, (8, 3, 1, 9, 9), cuda), *_aff(rng, 8, cuda))
    got = tk.fm_conv_bn_relu(x, *args)
    torch.cuda.synchronize()
    assert tk.launches["fm_conv_bn_relu"] == 1 and got.dtype == torch.bfloat16
    assert torch.equal(tk.fm_conv_bn_relu(x, *args, params=tk.fm_conv_params(x, *args)), got)
    ref = tk.fm_conv_bn_relu_ref(x.float(), *args)
    assert (got.float() - ref).abs().max().item() <= _bf16_bound(ref)


@pytest.mark.parametrize("c,shape", RB2D_BF16, ids=RB2D_BF16_IDS)
def test_rb2d_bf16_matches_twin(cuda, rng, c, shape):
    """Each width in bf16 against the fp32 twin on the same rounded input;
    the fp32 packing's buffer is refused."""
    x, *args = _rb2d_args(rng, *shape, c, cuda)
    x = x.bfloat16()
    got = tk.rb2d_residual(x, *args)
    torch.cuda.synchronize()
    assert tk.launches["rb2d_residual"] == 1 and got.dtype == torch.bfloat16
    assert torch.equal(tk.rb2d_residual(x, *args, params=tk.rb2d_params(x, *args)), got)
    ref = tk.rb2d_residual_ref(x.float(), *args)
    assert (got.float() - ref).abs().max().item() <= _bf16_bound(ref)
    with pytest.raises(ValueError, match="params"):
        tk.rb2d_residual(x, *args, params=tk.rb2d_params(x.float(), *args))


@pytest.mark.parametrize("b,n", [(1, 65537), (65537, 1)], ids=["slices", "batches"])
def test_srd_attention_takes_more_than_65535_slices_or_stacks(cuda, rng, b, n):
    """The grid splits N into runs of slices (``srd_attention_plan``) and
    flattens B, the runs and the pixel tiles into one block index: no grid
    dimension holds B or N."""
    args = (_act(rng, (b, 8, n, 2, 3), cuda), _wt(rng, (8, 8, 3, 1, 1), cuda),
            _wt(rng, (8, 8, 1, 1, 1), cuda))
    got = tk.srd_attention_residual(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tk.srd_attention_residual_ref(*args), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("b,n,h,w", [(1, 10, 40, 72), (2, 9, 45, 101), (1, 2, 7, 5)],
                         ids=["split_runs", "odd", "tiny"])
def test_srd_attention_widths_match_twin(cuda, rng, b, n, h, w, c, dtype):
    """Each width in both dtypes against the fp32 twin on the same rounded
    input: 16-byte loads (40 x 72), scalar ones (45 x 101, 7 x 5), N split
    into runs (10 and 9 slices at these sizes)."""
    f = _act(rng, (b, c, n, h, w), cuda).to(dtype)
    args = (_wt(rng, (c, c, 3, 1, 1), cuda), _wt(rng, (c, c, 1, 1, 1), cuda))
    got = tk.srd_attention_residual(f, *args)
    torch.cuda.synchronize()
    ref = tk.srd_attention_residual_ref(f.float(), *args)
    bound = 1e-4 if dtype == torch.float32 else _bf16_bound(ref)
    assert got.dtype == dtype and (got.float() - ref).abs().max().item() <= bound
    assert tk.launches["srd_attention_residual"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_srd_attention_kept_params_equal_fresh_ones(cuda, rng, dtype):
    """The buffer a ParamCache keeps gives the same bits as one packed on the
    call; another width's buffer is refused."""
    f = _act(rng, (1, 8, 10, 40, 72), cuda).to(dtype)
    args = (_wt(rng, (8, 8, 3, 1, 1), cuda), _wt(rng, (8, 8, 1, 1, 1), cuda))
    cache = tk.ParamCache(tk.srd_attention_params)
    kept = cache(f, *args)
    assert cache(f, *args) is kept
    assert torch.equal(tk.srd_attention_residual(f, *args, params=kept),
                       tk.srd_attention_residual(f, *args))
    with pytest.raises(ValueError, match="params"):
        tk.srd_attention_residual(f, *args, params=torch.zeros(tk.srd_params_size(16),
                                                               device=cuda))


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


#: the bf16 designs of FlowNetwork's kernels: the motion head and each
#: rb_of_chain level (FLOW_LEVELS: the index into CHAINS); head and fe1 beyond
#: GRID_SHAPES (which the persistent-grid tests cover in bf16), fe2 and fe3 at
#: every shape
FLOW_LEVELS = {"head": None, "fe1": 0, "fe2": 1, "fe3": 2}
FLOW_BF16 = ([(k, s) for k in ("head", "fe1") for s in BF16_SHAPES]
             + [(k, s) for k in ("fe2", "fe3") for s in GRID_SHAPES + BF16_SHAPES])
FLOW_BF16_IDS = ([f"{k}_{i}" for k in ("head", "fe1") for i in BF16_IDS]
                 + [f"{k}_{i}" for k in ("fe2", "fe3")
                    for i in ["many_tiles", "odd", "strip"] + BF16_IDS])


def _flow_kernel(rng, level, shape, dev):
    """(wrapper, twin, packer, launch name, x, the weights' args) of a FlowNetwork level."""
    if level == "head":
        x, *args = _head_args(rng, *shape, dev)
        return (tk.motion_head_conv_chain, tk.motion_head_conv_chain_ref, tk.motion_head_params,
                "motion_head_conv_chain", x, args)
    x, blocks = _chain_args(rng, *shape, CHAINS[FLOW_LEVELS[level]], dev)
    return (tk.rb_of_chain, tk.rb_of_chain_ref, tk.rb_of_chain_params, "rb_of_chain", x,
            [blocks])


@pytest.mark.parametrize("level,shape", FLOW_BF16, ids=FLOW_BF16_IDS)
def test_flow_kernels_bf16_match_twins(cuda, rng, level, shape):
    """bf16 in, fp32 inside: each rounds only its output against the fp32
    twin on the same rounded input; a kept buffer gives the same bits as one
    packed on the call, and the fp32 packing's buffer is refused."""
    fn, twin, pack, name, x, args = _flow_kernel(rng, level, shape, cuda)
    x = x.bfloat16()
    got = fn(x, *args)
    torch.cuda.synchronize()
    assert tk.launches[name] == 1 and got.dtype == torch.bfloat16
    assert torch.equal(fn(x, *args, params=pack(x, *args)), got)
    ref = twin(x.float(), *args)
    assert (got.float() - ref).abs().max().item() <= _bf16_bound(ref)
    with pytest.raises(ValueError, match="params"):
        fn(x, *args, params=pack(x.float(), *args))


@pytest.mark.parametrize("level", sorted(FLOW_LEVELS))
def test_param_cache_keeps_each_dtype_its_own_buffer(cuda, rng, level):
    """One ParamCache met by an fp32 and a bf16 input in turns packs each dtype
    its own buffer, and every launch reads the buffer of its input's dtype:
    the same bits as a buffer packed on the call."""
    fn, _, pack, _, x, args = _flow_kernel(rng, level, (1, 2, 40, 72), cuda)
    cache = tk.ParamCache(pack)
    kept = {}
    for xx in (x, x.bfloat16(), x, x.bfloat16()):
        buf = cache(xx, *args)
        assert buf.numel() == pack(xx, *args).numel()
        kept.setdefault(xx.dtype, buf.numel())
        assert torch.equal(fn(xx, *args, params=buf), fn(xx, *args))
    assert kept[torch.float32] != kept[torch.bfloat16]


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
    net = load_params_auto(0, device=cuda, arch="e2e")
    assert isinstance(net, E2ENetwork)
    with torch.inference_mode():
        got = net(fs.to(cuda), fd.to(cuda), fovs.to(cuda))
        ref = load_params_auto(0, device="cpu", arch="e2e")(fs, fd, fovs)
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
    net, other = (load_params_auto(s, device=cuda, arch="e2e") for s in (0, 1))
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
    cpu = load_params_auto(1, device="cpu", arch="e2e")
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
    if name == "bn_act":
        x = _act(rng, (1, 16, 2, 16, 24), dev).bfloat16().contiguous(
            memory_format=torch.channels_last_3d)
        return tk.bn_act, [x, *(v.bfloat16() for v in _aff(rng, 16, dev))], 1
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


@pytest.mark.parametrize("arch", ["dffnet", "e2e"])
def test_train_mode_forward_on_the_card_launches_no_kernel(cuda, rng, arch):
    """In training mode every module runs on stock ops: with gradients the
    forward does not raise, launches no kernel, and the backward reaches
    every used parameter."""
    from dffx_torch.eval import load_params_auto

    net = load_params_auto(0, device=cuda, arch=arch).train()
    e2e = arch == "e2e"
    batch = _train_batch(rng, cuda, 1, 10, 32, 32, e2e=e2e)
    extra = (batch["fovs"],) if e2e else ()
    tk.reset_launches()
    outs = net(batch["fs"], batch["focus_dists"], *extra)
    sum(o.float().sum() for o in outs[:4]).backward()
    torch.cuda.synchronize()
    assert tk.launches == dict.fromkeys(tk.launches, 0)
    unused = [k for k, p in net.named_parameters() if p.grad is None]
    assert all(".pre_conv." in k or ".redir3." in k for k in unused), unused


@pytest.mark.parametrize("arch", ["dffnet", "e2e"])
def test_packed_forward_on_the_card_matches_unpacked(cuda, rng, arch):
    """fp32 within 1e-4 on every head; bf16 packed against fp32 unpacked under a
    stated bound: 15 % of the focus range (a whole bf16 forward is some forty
    convs deep; on the card at 10 x 384 x 384 the unpacked bf16 forward is up
    to 7 % of the range from its fp32, ``chip_smoke.py``'s ``forward_vs_cpu``)."""
    from dffx_torch.eval import load_params_auto

    e2e = arch == "e2e"
    h, w = (64, 160) if e2e else (64, 96)
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, h, w, 3)).astype(np.float32)).to(cuda)
    fd = torch.from_numpy(np.linspace(0.1, 1.5, 10, dtype=np.float32)[None]).to(cuda)
    extra = (torch.from_numpy(np.linspace(1.0, 1.05, 10, dtype=np.float32)[None]).to(cuda),
             ) if e2e else ()
    plain, packed = (load_params_auto(0, device=cuda, packed=p, arch=arch) for p in (False, True))
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


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_bf16_eval_forward_runs_every_stock_conv_ndhwc(cuda, rng, packed, monkeypatch):
    """A bf16 eval DFFNet forward hands cuDNN NDHWC activations alone: every
    stock conv and deconv counts ``stock.conv_ndhwc``, none
    ``stock.conv_ncdhw``, no cuDNN layout transpose runs, every eval BN
    counts ``stock.bn_fused`` (the one pass) and none ``stock.bn_aten``, and
    ``pred3`` is that of the same forward kept NCDHW, within
    ``PRED3_NCDHW_RTOL``."""
    import torch.nn.functional as F

    from dffx_torch.eval import load_params_auto
    from dffx_torch.models import dffnet
    from dffx_torch.models.layers import BatchNorm3d
    from dffx_torch.utils import profiling

    fs = torch.from_numpy(rng.uniform(-1, 1, (2, 10, 64, 96, 3)).astype(np.float32))
    fs = fs.to(cuda, torch.bfloat16)
    fd = torch.from_numpy(np.tile(np.linspace(0.1, 1.5, 10, dtype=np.float32), (2, 1))).to(cuda)
    net, plain = (load_params_auto(0, device=cuda, packed=packed) for _ in range(2))
    convs = []
    for name in ("conv3d", "conv2d", "conv_transpose3d", "linear"):
        monkeypatch.setattr(F, name, lambda *a, _fn=getattr(F, name), **k:
                            convs.append(_fn) or _fn(*a, **k))
    bns = []
    hooks = [m.register_forward_hook(lambda *a: bns.append(1)) for m in net.modules()
             if isinstance(m, BatchNorm3d)]
    with torch.inference_mode():
        net(fs, fd)  # cuDNN's choice, the kept weights
        convs.clear()
        bns.clear()
        profiling.reset()
        with profiling.collect():
            got = net(fs, fd)
        counted, calls, bn_calls = profiling.counters(), len(convs), len(bns)
        for h in hooks:
            h.remove()
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            net(fs, fd)
            torch.cuda.synchronize()
        profiling.reset()
        by_layout = {k: v for k, v in counted.items() if k.startswith("stock.conv")}
        assert by_layout == {"stock.conv_ndhwc": calls} and calls == 65
        # every eval BN outside the FM kernels takes the one pass: the BN
        # modules called, and the packed stage's three packed affines
        assert {k: v for k, v in counted.items() if k.startswith("stock.bn")} == {
            "stock.bn_fused": bn_calls + (3 if packed else 0)} == {"stock.bn_fused": 55}
        transposes = [e.key for e in prof.key_averages()
                      if "nchwToNhwc" in e.key or "nhwcToNchw" in e.key]
        assert not transposes, transposes
        monkeypatch.setattr(dffnet, "activation_format",
                            lambda x, training: torch.contiguous_format)
        want = plain(fs, fd)
    gap = (got[3].float() - want[3].float()).abs().max().item()
    assert gap <= PRED3_NCDHW_RTOL * want[3].float().abs().max().item(), gap


#: activations of the eval BN pass at the cells' shapes, b2: DFFNet's at 10 x
#: 384 x 576 plain NDHWC (16ch @ 1/2, 32ch @ 1/4) and packed NDHWC (the full
#: resolution's 8 channels as 32 @ 1/2), and FlowNetwork's NCDHW 8ch at 608 x
#: 1088 and 16ch @ 1/2
BN_ACT_SHAPES = {"dffnet_half": ((2, 16, 10, 192, 288), "ndhwc"),
                 "dffnet_quarter": ((2, 32, 10, 96, 144), "ndhwc"),
                 "dffnet_packed": ((2, 32, 10, 192, 288), "ndhwc"),
                 "flownet_full": ((1, 8, 10, 608, 1088), "ncdhw"),
                 "flownet_half": ((1, 16, 10, 304, 544), "ncdhw")}


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["no_z", "z"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("where", list(BN_ACT_SHAPES))
def test_bn_act_matches_twin(cuda, where, dtype, residual, relu):
    """The eval BN's pass is its twin bit for bit: the same fp32 arithmetic
    (an exact product, then the shift and z added) and one rounding."""
    shape, layout = BN_ACT_SHAPES[where]
    fmt = torch.channels_last_3d if layout == "ndhwc" else torch.contiguous_format
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (2 * torch.randn(shape, generator=gen, device=cuda)).to(dtype).contiguous(
        memory_format=fmt)
    z = (torch.randn(shape, generator=gen, device=cuda).to(dtype).contiguous(memory_format=fmt)
         if residual else None)
    scale, shift = (v.to(dtype) for v in _aff(np.random.default_rng(1), shape[1], cuda))
    assert tk.bn_act_layout(x, z) == layout
    got = tk.bn_act(x, scale, shift, z, relu)
    torch.cuda.synchronize()
    assert tk.launches["bn_act"] == 1
    assert got.dtype == dtype and got.stride() == x.stride()
    assert torch.equal(got, tk.bn_act_ref(x, scale, shift, z, relu))


#: dense tensors off the two vectorised paths, which the general path takes:
#: (shape, layout, offset in values from a 16-byte boundary)
BN_ACT_GENERAL = {"ndhwc_c12": ((2, 12, 5, 40, 72), "ndhwc", 0),
                  "ndhwc_c6152": ((1, 6152, 1, 2, 3), "ndhwc", 0),  # beyond shared memory
                  "ncdhw_odd": ((1, 16, 10, 45, 101), "ncdhw", 0),  # FlowNetwork at 180 x 404
                  "ncdhw_tail": ((1, 3, 1, 1, 5), "ncdhw", 0),  # 15 values: a partial vector
                  "ncdhw_misaligned": ((1, 16, 10, 152, 272), "ncdhw", 1),
                  "ndhwc_misaligned": ((2, 16, 5, 40, 72), "ndhwc", 3)}


@pytest.mark.parametrize("residual", [False, True], ids=["no_z", "z"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("where", list(BN_ACT_GENERAL))
def test_bn_act_takes_every_dense_layout(cuda, where, dtype, residual):
    """Channels that change inside a vector, more channels than shared memory
    holds, a partial last vector, a view off 16-byte alignment: the kernel's
    general path, its twin bit for bit."""
    shape, layout, offset = BN_ACT_GENERAL[where]
    fmt = torch.channels_last_3d if layout == "ndhwc" else torch.contiguous_format
    gen = torch.Generator(device=cuda).manual_seed(2)

    def draw():
        t = (2 * torch.randn(shape, generator=gen, device=cuda)).to(dtype).contiguous(
            memory_format=fmt)
        if not offset:
            return t
        flat = torch.empty(t.numel() + offset, dtype=dtype, device=cuda)
        return flat[offset:].as_strided(t.shape, t.stride()).copy_(t)

    x, z = draw(), (draw() if residual else None)
    assert x.data_ptr() % 16 == 2 * offset
    scale, shift = (v.to(dtype) for v in _aff(np.random.default_rng(3), shape[1], cuda))
    assert tk.bn_act_layout(x, z) == layout
    got = tk.bn_act(x, scale, shift, z, True)
    torch.cuda.synchronize()
    assert tk.launches["bn_act"] == 1
    assert got.dtype == dtype and got.stride() == x.stride()
    assert torch.equal(got, tk.bn_act_ref(x, scale, shift, z, True))


def test_bn_act_refuses_what_it_does_not_take(cuda, rng):
    """On the card the wrapper raises where no layout holds the tensors: no
    launch, no fallback."""
    cl = torch.channels_last_3d
    x = _act(rng, (1, 16, 2, 16, 24), cuda).bfloat16()
    scale, shift = (v.bfloat16() for v in _aff(rng, 16, cuda))
    cases = {"mixed layouts": (x.contiguous(memory_format=cl), x),
             "not dense": (x[:, :, :, :8], None),
             "z in another dtype": (x, x.half()),
             "fp32": (x.float(), None)}
    for what, (a, z) in cases.items():
        with pytest.raises(ValueError, match="bn_act takes"):
            tk.bn_act(a, scale[:a.shape[1]], shift[:a.shape[1]], z)
    assert tk.launches["bn_act"] == 0
    for n in range(1, 4):
        tk.bn_act(x, scale, shift, relu=True)
        assert tk.launches["bn_act"] == n


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


@pytest.mark.parametrize("profile", [0, 1], ids=["pixel4_XL", "pixel6"])
def test_simulator_on_the_card_matches_cpu(cuda, rng, profile):
    """``generate_scene`` at 32 x 48, 4 slices, 200 planes, rendered on the
    card and on the CPU: uint8 |d| <= 1 at more than 99.9 % of the pixels with
    a median of 0, disparity and depth to rtol 1e-4 / atol 1e-3, the same
    draws; no kernel of the port launches, and the TF32 flags are as before."""
    from dffx_torch import sim

    image = rng.uniform(0, 255, (32, 48, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 1.1, (32, 48))
    kw = dict(profile=sim.DEVICE_PROFILES[profile], pixel_vs_meter=1 / 0.0000014 * 48 / 4080,
              num_imgs=4, num_planes=200)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = sim.generate_scene(image, depth, rng=np.random.default_rng(profile), **kw)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = sim.generate_scene(image, depth, rng=np.random.default_rng(profile), device="cpu",
                              **kw)
    d = np.abs(np.stack(got["imgs"]).astype(int) - np.stack(want["imgs"]).astype(int))
    assert (d <= 1).mean() > 0.999 and np.median(d) == 0, d.max()
    np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4, atol=1e-3)
    assert got["camera_setting"] == want["camera_setting"]
    assert sum(tk.launches.values()) == 0


# ---------------------------------------------------------------------------
# several processes on the card (tests/torch_dist_worker.py): two ranks share
# it over gloo, each a process of its own
# ---------------------------------------------------------------------------


def test_data_parallel_steps_on_the_card(cuda, tmp_path):
    """Two ranks on the card, ``sync`` and ``per_shard``: the same state on
    both after three steps; the first ``sync`` step against one process on
    the card on the global batch (loss 1e-5, gradients 0.25 max|g| + 1e-7 a
    tensor and 5 % L2, statistics 1e-5), and in float64 (each gradient
    within 1e-10 of its tensor's largest value); no kernel launches.  Sync BN
    alone on ranks of 1 and 3 rows in float64 against one process of 4 on
    the CPU (y, x's gradient, the running statistics within 1e-10)."""
    import torch_dist_worker as w
    from dffx_torch.train import LossConfig, create_train_state, make_train_step

    ranks = w.launch("train", 2, tmp_path, timeout=600, device="cuda")
    for mode in ("sync", "per_shard"):
        a, b = ranks[0][mode][-1], ranks[1][mode][-1]
        assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"]), mode
    state = create_train_state(w.new_model(False).to(cuda), w.LR)
    state, logs = make_train_step(w.LR, LossConfig())(
        state, {k: v.to(cuda) for k, v in w.torch_batch(w.train_batch(0)).items()})
    assert tk.launches == dict.fromkeys(tk.launches, 0)
    got = ranks[0]["sync"][0]
    assert abs(got["logs"]["loss"] - float(logs["loss"])) <= 1e-5 * abs(float(logs["loss"]))
    num = den = 0.0
    for k, p in state.model.named_parameters():
        g, want = got["grads"][k], p.grad.cpu()
        assert (g - want).abs().max().item() <= 0.25 * want.abs().max().item() + 1e-7, k
        num, den = num + float(((g - want) ** 2).sum()), den + float((want ** 2).sum())
    assert num <= 0.05 ** 2 * den
    for k, want in state.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got["stats"][k], want.cpu(), rtol=1e-5, atol=1e-6)
    state = create_train_state(w.new_model(False).to(cuda, torch.float64), w.LR)
    state, logs = make_train_step(w.LR, LossConfig(), compute_dtype=torch.float64)(
        state, {k: v.to(cuda) for k, v in w.torch_batch(w.in_float64(w.train_batch(0))).items()})
    got = ranks[0]["sync64"][0]
    for k, p in state.model.named_parameters():
        g, want = got["grads"][k], p.grad.cpu()
        assert g.dtype == torch.float64, k
        assert (g - want).abs().max().item() <= 1e-10 * want.abs().max().item(), k
    # sync BN on 1 and 3 rows, float64, against one process on the CPU
    want = w.bn_rows_step(w.bn_rows_inputs(np.float64), slice(None))
    got = [r["bn_rows"]["float64"] for r in ranks]
    for k in ("y", "dx"):
        joined = torch.cat([rec[k] for rec in got])
        assert (joined - want[k]).abs().max().item() <= 1e-10 * want[k].abs().max().item(), k
    for rec in got:
        for k in ("running_mean", "running_var"):
            assert (rec[k] - want[k]).abs().max().item() <= 1e-10 * want[k].abs().max().item()


def test_spatial_chain_sites_on_the_card(cuda, tmp_path):
    """The three chain sites sharded over two ranks on the card: the kernels
    against the same sites whole on the card (1e-4), the stock layers too;
    one launch of each kernel a site with the kernels, none without."""
    import torch_dist_worker as w

    ranks = w.launch("halo", 2, tmp_path, timeout=600, device="cuda", spatial=2)
    dff, e2e = w.new_model(False).to(cuda).eval(), w.new_model(True).to(cuda).eval()
    flow = e2e.optical_flow_aggregation
    sites = {"fm": dff.DFF_net.FM_measure, "of": flow.OF_feature, "head": flow.conv3}
    with torch.no_grad():
        want = {k: sites[k](torch.from_numpy(x).to(cuda)).cpu()
                for k, x in w.chain_inputs(2).items()}
    for r in ranks:
        for site, ref in want.items():
            for how in ("kernels", "stock"):
                torch.testing.assert_close(r[f"{site}_{how}"], ref, rtol=0, atol=1e-4)
        assert r["launches_kernels"] == {**dict.fromkeys(E2E_LAUNCHES, 1), "bn_act": 0}
        assert r["launches_stock"] == dict.fromkeys(E2E_LAUNCHES, 0)
        assert r["traffic"]["host_staged"] > 0  # gloo carries host tensors


def test_spatial_forwards_on_the_card(cuda, tmp_path):
    """``TimedForward(spatial=2)`` on two ranks on the card against the same
    forward whole on the card (1e-4): DFFNet, and E2E whose lower levels run
    whole; every kernel launched once a forward a rank (``rb_of_chain``
    three times), none under ``--spatial-xla``."""
    import torch_dist_worker as w
    from dffx_torch.eval import TimedForward

    ranks = w.launch("forward", 2, tmp_path, timeout=600, device="cuda", spatial=2)
    for key in [k for k in ranks[0] if isinstance(k[0], bool)]:
        e2e, h, wd, pallas = key
        want = TimedForward(w.new_model(e2e).to(cuda))(*w.forward_inputs(e2e, h, wd))
        launches = (E2E_LAUNCHES if e2e else dict.fromkeys(DFFNET_KERNELS, 1)) if pallas else {}
        for r in ranks:
            assert r["launches", *key] == {k: launches.get(k, 0) for k in E2E_LAUNCHES}, key
            for g, ref in zip(r[key], want):
                torch.testing.assert_close(g, ref.cpu(), rtol=0, atol=1e-4)


def test_dfv_bf16_on_the_card_matches_the_reference(cuda):
    """DFV served in bf16 NDHWC (``TimedForward``) at b2 of the cell's
    10 x 384 x 576 stacks against the plain fp32 reference
    (``tests/dfv_reference.py``) on the card, under the limits of the
    cell ``dfv-ddff12.batch-b32`` (rms gap over the reference's rms); its
    weights drawn as the benchmark draws them (MSRA convs but the head's
    last, U(+-1 / (4 sqrt(fan_in))); BatchNorm away from the identity).  None
    of the five hand kernels launches; each of its 61 eval BNs is one launch
    of the BN pass."""
    import json
    from pathlib import Path

    from dfv_reference import DFVReference, reference_state_dict

    from dffx_torch.eval import TimedForward, load_params_auto
    from dffx_torch.models.layers import BatchNorm3d

    limits = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "limits"
                         / "dfv-ddff12.batch-b32.json").read_text())["limits"]
    net = load_params_auto(3, arch="dfv", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm3d):
                for t, lo, hi in ((m.weight, 0.8, 1.2), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.8, 1.2)):
                    t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g, device=cuda))
        head = net.decoder3.classify[2][0].weight
        bound = 0.25 * head[0].numel() ** -0.5
        head.copy_(bound * (2 * torch.rand(head.shape, generator=g, device=cuda) - 1))
    ref = DFVReference().to(cuda).eval()
    ref.load_state_dict(reference_state_dict(net.state_dict()))
    fs = (torch.rand((2, 10, 384, 576, 3), generator=g, device=cuda) * 2 - 1).bfloat16()
    fd = torch.linspace(0.2, 7.0, 10, device=cuda).expand(2, 10).contiguous()
    got = TimedForward(net, dtype=torch.bfloat16)(fs, fd)
    with torch.inference_mode():
        want = ref(fs.float(), fd)
    assert tk.launches == {**dict.fromkeys(tk.launches, 0), "bn_act": 61}
    assert len(got) == len(want) == 3
    for name, o, w in zip(("pred3", "std3", "cost3"), got, want):
        assert o.dtype == torch.bfloat16
        if f"{name}_rms" in limits:  # the outputs the cell holds to a limit
            gap = float((o.float() - w).square().mean().sqrt() / w.square().mean().sqrt())
            assert gap <= limits[f"{name}_rms"], (name, gap)


def test_ddffnet_bf16_on_the_card_matches_the_reference(cuda):
    """DDFFNet served in bf16 NDHWC (``TimedForward``) at b2 of 10 x 64 x 96
    against the plain fp32 reference (``tests/ddffnet_reference.py``) on the
    card, under the limits of the cell ``ddffnet-ddff12.batch-b32`` (rms gap
    over the reference's rms); its weights drawn as the benchmark draws
    them (every conv and upconv MSRA but the last, U(+-1 / sqrt(fan_in));
    the fusion U[0.8, 1.2); BatchNorm away from the identity).
    Every conv, upconv and pool keeps the NDHWC layout (no stock conv
    counts NCDHW; each output but the one-channel map's and the fusion's is
    NDHWC), none of the five hand kernels launches, and each of its
    25 eval BNs is one launch of the BN pass."""
    import json
    import math
    from pathlib import Path

    from ddffnet_reference import DDFFNetReference, reference_state_dict

    from dffx_torch.eval import TimedForward, load_params_auto
    from dffx_torch.models.layers import BatchNorm3d, Conv3d, ConvTranspose3d
    from dffx_torch.ops.conv import is_ndhwc
    from dffx_torch.utils import profiling

    limits = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "limits"
                         / "ddffnet-ddff12.batch-b32.json").read_text())["limits"]
    net = load_params_auto(3, arch="ddffnet", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm3d):
                for t, lo, hi in ((m.weight, 0.8, 1.2), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.8, 1.2)):
                    t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g, device=cuda))
            elif m is net.scoring:  # the fusion, drawn as the benchmark draws it
                m.weight.copy_(0.8 + 0.4 * torch.rand(m.weight.shape, generator=g, device=cuda))
            elif m is net.conv1_1_D:  # the last conv, at torch's default bound
                bound = m.weight[0].numel() ** -0.5
                m.weight.copy_(bound * (2 * torch.rand(m.weight.shape, generator=g,
                                                       device=cuda) - 1))
            elif isinstance(m, (Conv3d, ConvTranspose3d)):
                w = m.weight
                cout = w.shape[1] if isinstance(m, ConvTranspose3d) else w.shape[0]
                w.copy_(torch.randn(w.shape, generator=g, device=cuda)
                        * math.sqrt(2.0 / (math.prod(w.shape[2:]) * cout)))
    ref = DDFFNetReference(10).to(cuda).eval()
    ref.load_state_dict(reference_state_dict(net.state_dict()))
    fs = (torch.rand((2, 10, 64, 96, 3), generator=g, device=cuda) * 2 - 1).bfloat16()
    fd = torch.linspace(0.2, 7.0, 10, device=cuda).expand(2, 10).contiguous()
    layouts = []
    hooks = [m.register_forward_hook(lambda m, a, out: layouts.append(is_ndhwc(out)))
             for m in net.modules() if isinstance(m, (Conv3d, ConvTranspose3d))
             and m is not net.conv1_1_D and m is not net.scoring]
    with profiling.collect():
        profiling.reset()
        got = TimedForward(net, dtype=torch.bfloat16)(fs, fd)
        counts = profiling.counters()
    profiling.reset()
    for h in hooks:
        h.remove()
    with torch.inference_mode():
        want = ref(fs.float(), fd)
    assert tk.launches == {**dict.fromkeys(tk.launches, 0), "bn_act": 25}
    assert counts["stock.conv_ndhwc"] == 31 and "stock.conv_ncdhw" not in counts
    assert len(layouts) == 30 and all(layouts)  # every conv and upconv but the last two
    assert len(got) == len(want) == 2
    for name, o, w in zip(("pred", "maps"), got, want):
        assert o.dtype == torch.bfloat16 and o.shape == w.shape
        if f"{name}_rms" in limits:  # the outputs the cell holds to a limit
            gap = float((o.float() - w).square().mean().sqrt() / w.square().mean().sqrt())
            assert gap <= limits[f"{name}_rms"], (name, gap)


def test_timed_forward_returns_after_the_previous_forward(cuda):
    """On the card ``TimedForward`` waits for the previous call's forward,
    not its own: after a call, only its own events are pending; reading
    ``total`` takes them in; the outputs are the model's, and ``avg_time``
    is the events' time a sample."""
    from dffx_torch.eval import TimedForward, load_params_auto

    net = load_params_auto(0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    fs = torch.rand((2, 5, 64, 96, 3), generator=g, device=cuda) * 2 - 1
    fd = torch.linspace(0.2, 7.0, 5, device=cuda).expand(2, 5).contiguous()
    tf = TimedForward(net)
    outs = [tf(fs, fd) for _ in range(3)]
    last = tf._pending
    assert last is not None and tf.count == 6
    total = tf.total
    assert tf._pending is None and last[1].query()
    assert total > 0 and tf.avg_time == pytest.approx(total / 6)
    with torch.inference_mode():
        want = net(fs, fd)
    for got in outs:
        for o, w in zip(got, want):
            torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)
    tf.total, tf.count = 0.0, 0
    tf(fs, fd)
    assert 0 < tf.total < total


#: cycles a stand-in model spins on the card before it reads its inputs
#: (``torch.cuda._sleep``; about 30 ms on an H100), so that a later call's
#: stage-in runs while the forward still waits to read
STAGE_WAIT_CYCLES = 50_000_000
CELL_STACK = (1, 10, 608, 1088, 3)


class _Staged(torch.nn.Module):
    """A model that spins ``cycles`` on the card, then hands back a copy of
    each input it got: what the serving entry staged, as the forward reads
    it."""

    def __init__(self, dev, cycles=0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1, device=dev))
        self.cycles = cycles

    def forward(self, *inputs):
        if self.cycles:
            torch.cuda._sleep(self.cycles)
        return tuple(t.clone() for t in inputs)


def _host_inputs(seed, shape=CELL_STACK, layout="contiguous"):
    """A float32 stack in host memory (values over a wide range, so that
    every cast rounds) laid out as ``layout`` says, with focus distances
    and fields of view as E2E takes them."""
    g = torch.Generator().manual_seed(seed)
    b, n, h, w, c = shape
    if layout == "channels_first":
        fs = torch.randn((b, c, n, h, w), generator=g).mul_(100).permute(0, 2, 3, 4, 1)
    elif layout == "strided":
        fs = torch.randn((b, n, h, 2 * w, c), generator=g).mul_(100)[:, :, :, ::2]
    else:
        fs = torch.randn(shape, generator=g).mul_(100)
    fd = torch.linspace(0.2, 7.0, n).expand(b, n)
    fovs = (1.0 + 0.02 * torch.rand((b, n), generator=g))
    return fs, fd, fovs


@pytest.mark.parametrize("shape", [CELL_STACK, (3, 5, 64, 96, 3)], ids=["cell", "b3"])
@pytest.mark.parametrize("source", ["contiguous", "channels_first", "strided", "numpy"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
def test_host_inputs_stage_bit_for_bit(cuda, dtype, source, shape):
    """With the model on the card, a host stack (a tensor of any strides or
    a numpy array) and its focus distances and fields of view reach the
    model equal to ``.to(cuda, dtype)`` bit for bit, through the pinned
    stage-in: ``serve.staged_pinned`` counts every staged byte."""
    from dffx_torch.eval import TimedForward
    from dffx_torch.utils import profiling

    fs, fd, fovs = _host_inputs(3, shape, "contiguous" if source == "numpy" else source)
    assert fs.is_contiguous() == (source in ("contiguous", "numpy"))
    args = (fs.numpy(), fd.numpy(), fovs.numpy()) if source == "numpy" else (fs, fd, fovs)
    want = (fs.to(cuda, dtype), fd.to(cuda, torch.float32), fovs.to(cuda, torch.float32))
    tf = TimedForward(_Staged(cuda), dtype=dtype)
    profiling.reset()
    try:
        with profiling.collect():
            got = tf(*args)
        counters = profiling.counters()
    finally:
        profiling.reset()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    staged = sum(w.nbytes for w in want)
    assert counters == {"serve.staged_bytes": staged, "serve.staged_pinned": staged}


def test_e2e_served_from_host_memory_equals_inputs_staged_by_to(cuda):
    """E2E at the cell's 1 x 10 x 608 x 1088 in bf16: its outputs from host
    inputs (numpy, as a client hands them) equal those from the same inputs
    staged by ``.to()``."""
    from dffx_torch.eval import TimedForward, load_params_auto

    net = load_params_auto(0, device=cuda, arch="e2e")
    g = torch.Generator().manual_seed(24)
    fs = torch.rand(CELL_STACK, generator=g) * 2 - 1
    fd = torch.linspace(0.2, 7.0, 10)[None]
    fovs = torch.linspace(1.0, 1.02, 10)[None]
    got = [o.cpu() for o in TimedForward(net, dtype=torch.bfloat16)(
        fs.numpy(), fd.numpy(), fovs.numpy())]
    with torch.inference_mode():
        want = [o.cpu() for o in net(fs.to(cuda, torch.bfloat16), fd.to(cuda), fovs.to(cuda))]
    assert len(got) == len(want) == 5
    for o, w in zip(got, want):
        assert o.dtype == w.dtype and torch.equal(o, w)


def test_caller_may_overwrite_its_inputs_once_the_call_returns(cuda):
    """Once a call returns its host inputs are no longer read: overwriting
    them at once, while the forward has not yet read what was staged,
    changes nothing it gets."""
    from dffx_torch.eval import TimedForward

    fs, fd, fovs = (t.numpy().copy() for t in _host_inputs(4))
    want = [torch.from_numpy(fs).to(cuda, torch.bfloat16), torch.from_numpy(fd).to(cuda),
            torch.from_numpy(fovs).to(cuda)]
    tf = TimedForward(_Staged(cuda, STAGE_WAIT_CYCLES), dtype=torch.bfloat16)
    got = tf(fs, fd, fovs)
    for a in (fs, fd, fovs):
        a[...] = -3.0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_calls_back_to_back_each_get_their_own_stack(cuda):
    """Four calls with four stacks and no host read between them (each
    call's stage-in runs while the previous forward still waits to read):
    each forward reads its own stack, though the pinned chunks and the
    device memory of a staged stack are used again."""
    from dffx_torch.eval import TimedForward

    reqs = [_host_inputs(10 + i) for i in range(4)]
    tf = TimedForward(_Staged(cuda, STAGE_WAIT_CYCLES), dtype=torch.bfloat16)
    outs = [tf(*r) for r in reqs]
    for (fs, fd, fovs), got in zip(reqs, outs):
        assert torch.equal(got[0], fs.to(cuda, torch.bfloat16))
        assert torch.equal(got[1], fd.to(cuda)) and torch.equal(got[2], fovs.to(cuda))


def test_a_request_takes_no_new_pinned_memory(cuda):
    """After warm-up a request neither makes nor takes a pinned block: the
    stage-in holds ``STAGE_RING`` chunks of one slice each, at b3 as at b1."""
    from dffx_torch.eval import TimedForward
    from dffx_torch.eval.common import STAGE_RING

    shape = (3, 10, 608, 1088, 3)
    reqs = [[t.numpy() for t in _host_inputs(20 + i, shape)] for i in range(3)]
    tf = TimedForward(_Staged(cuda), dtype=torch.bfloat16)
    for r in reqs[:2]:
        tf(*r)
    torch.cuda.synchronize()
    before = torch.cuda.host_memory_stats()
    for r in reqs * 2:
        tf(*r)
    torch.cuda.synchronize()
    after = torch.cuda.host_memory_stats()
    for key in ("num_host_alloc", "active_requests.allocated"):
        assert after[key] == before[key], key
    chunks = tf._pinned.chunks
    assert len(chunks) == STAGE_RING
    assert all(c.is_pinned() and c.numel() == 608 * 1088 * 3 * 2 for c in chunks)
