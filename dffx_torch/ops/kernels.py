"""The port's hand-written CUDA kernels: wrappers and plain twins.

Five kernels (``dffx_torch/csrc``) replace the JAX package's Pallas kernels.
Three are DFFNet's full-resolution focus-measure chain, chained conv -> rb2d
-> attention as in ``dffx/models/layers.py::_fm_fused_chain``:

* ``fm_conv_bn_relu``        Conv3d(3->8, (1,9,9), pad (0,8,8), dil (1,2,2)) + BN + ReLU
* ``rb2d_residual``          relu(x + BN2(conv2(relu(BN1(conv1 x))))), (1,3,3) convs
* ``srd_attention_residual`` f + relu(W1 . relu(Wn . [f(n-1); f(n); f(n+1)]))

Two are the FlowNetwork alignment front end's (``dffx/models/alignnet.py``):

* ``rb_of_chain``            K stride-1 blocks relu(Ws . x + BN2(conv2(relu(BN1(conv1 x)))))
* ``motion_head_conv_chain`` four (1,3,3) convs 18->16->16->16->3, BN+ReLU after
                             the first three, a bias on the last

Each takes and returns torch's ``(B, C, N, H, W)`` layout, fp32 or bf16
activations; weights are torch-layout ``(Cout, Cin, kd, kh, kw)``, and eval
BN comes folded into fp32 ``(scale, shift)`` pairs (``bn_fused_affine``).

Dispatch is by device.  A CPU tensor goes to the plain twin (``*_ref``), a
CUDA tensor launches the kernel or raises; nothing falls back.  ``launches``
counts kernel launches per wrapper, so a run can show it went through them.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from dffx_torch.ops import _build
from dffx_torch.ops.norm import bn_fused_affine

__all__ = [
    "bn_fused_affine",
    "fm_conv_bn_relu",
    "fm_conv_bn_relu_ref",
    "rb2d_residual",
    "rb2d_residual_ref",
    "srd_attention_residual",
    "srd_attention_residual_ref",
    "rb_of_chain",
    "rb_of_chain_ref",
    "motion_head_conv_chain",
    "motion_head_conv_chain_ref",
    "fma_conv_layout",
    "mma_conv_layout",
    "rb_of_chain_params",
    "motion_head_params",
    "launches",
    "reset_launches",
]

Affine = Tuple[torch.Tensor, torch.Tensor]
#: one resnet_block_2d_OF: (w1, aff1, w2, aff2, w_shortcut)
OFBlock = Tuple[torch.Tensor, Affine, torch.Tensor, Affine, torch.Tensor]

#: kernel launches per wrapper since the last ``reset_launches()``
launches = {"fm_conv_bn_relu": 0, "rb2d_residual": 0, "srd_attention_residual": 0,
            "rb_of_chain": 0, "motion_head_conv_chain": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # DFFX_DTYPE_* in csrc/common.cuh
_KERNEL_CHANNELS = (8, 16, 32)
#: the (cin, cout) chains rb_of.cu is built for: FlowNetwork's three levels
_RB_OF_CHAINS = (((3, 8), (8, 8)), ((16, 16),), ((32, 32),))
#: the (cin, mid) widths motion_head.cu is built for: the full-res conv3 head
_MOTION_HEAD_WIDTHS = ((18, 16),)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _view(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1, 1)


def _check_act(x: torch.Tensor, c: int | None = None) -> None:
    if x.dim() != 5:
        raise ValueError(f"expected (B, C, N, H, W), got shape {tuple(x.shape)}")
    if c is not None and x.shape[1] != c:
        raise ValueError(f"expected {c} channels, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"activations must be float32 or bfloat16, got {x.dtype}")
    if min(x.shape) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")


def _check_param(t: torch.Tensor, shape: tuple, name: str) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _param(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A weight or affine vector as the kernel takes it: fp32, contiguous, on x's card."""
    if t.device != x.device:
        raise ValueError(f"parameter on {t.device}, activations on {x.device}")
    return t.float().contiguous()


def _cuda_args(x: torch.Tensor, c_ok=None, bn_in_grid: bool = True):
    """Check what only the kernel needs; returns (library, stream handle).
    ``bn_in_grid``: the launch has B * N as a grid dimension (at most 65535)."""
    if not x.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous (B, C, N, H, W) tensors")
    if c_ok is not None and x.shape[1] not in c_ok:
        raise ValueError(f"kernel built for C in {c_ok}, got C = {x.shape[1]}")
    if bn_in_grid and x.shape[0] * x.shape[2] > 65535:
        raise ValueError("B * N is a grid dimension of the launch: at most 65535")
    return _build.library(), torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _gather_index(shapes: tuple, layouts: tuple, device: torch.device) -> torch.Tensor:
    """Where each packed entry sits in the concatenation of the flat tensors."""
    parts, off = [], 0
    for shape, layout in zip(shapes, layouts):
        idx = torch.arange(off, off + math.prod(shape)).view(shape)
        parts.append(layout(idx) if layout else idx.reshape(-1))
        off += idx.numel()
    return torch.cat(parts).to(device)


def _packed(x: torch.Tensor, tensors, layouts) -> torch.Tensor:
    """Weights and affines in order, each flattened in its layout (``None``:
    as it is), back to back in one fp32 buffer on x's card.  One
    concatenation and one gather: the host's work per call stays two
    launches."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).float()
    if flat.device != x.device:
        raise ValueError(f"parameters on {flat.device}, activations on {x.device}")
    return flat.take(_gather_index(tuple(tuple(t.shape) for t in tensors), tuple(layouts),
                                   x.device))


def fma_conv_layout(w: torch.Tensor) -> torch.Tensor:
    """Conv weight ``(Cout, Cin, 1, kh, kw)`` as the FMA kernels read it
    (``csrc/chain.cuh``): flat ``[cin][tap][cout]``, tap = ky * kw + kx."""
    return w.permute(1, 2, 3, 4, 0).reshape(-1)


def mma_conv_layout(w: torch.Tensor) -> torch.Tensor:
    """Conv weight ``(Cout, Cin, 1, kh, kw)`` as B fragments of ``mma.sync``
    m16n8k8 (``csrc/rb_of.cu``): flat ``[tap][cin // 8][cout // 8][lane][2]``,
    where entry (lane, j) holds cin = 8 kc + 4 j + lane % 4 and cout = 8 nb +
    lane // 4.  Cin and Cout are multiples of 8."""
    co, ci = w.shape[:2]
    return (w.reshape(co // 8, 8, ci // 8, 2, 4, -1)   # nb, g, kc, j, t, tap
            .permute(5, 2, 0, 1, 4, 3).reshape(-1))    # tap, kc, nb, g, t, j


def rb_of_chain_params(x: torch.Tensor, blocks: Sequence[OFBlock]) -> torch.Tensor:
    """The fp32 buffer ``csrc/rb_of.cu`` reads, on x's device: per block w1,
    s1, b1, w2, s2, b2, ws, the convs in ``fma_conv_layout`` for the 3 -> 8 -> 8
    pair (FMA design) and in ``mma_conv_layout`` for a 16 -> 16 or 32 -> 32
    block (tensor cores)."""
    layout = fma_conv_layout if blocks[0][0].shape[1] % 8 else mma_conv_layout
    return _packed(x, [t for w1, aff1, w2, aff2, ws in blocks for t in (w1, *aff1, w2, *aff2, ws)],
                   [layout, None, None, layout, None, None, layout] * len(blocks))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _unsupported(x: torch.Tensor):
    return RuntimeError(f"no kernel or twin for device {x.device}")


# --------------------------------------------------------------------------
# fm_conv_bn_relu
# --------------------------------------------------------------------------


def fm_conv_bn_relu_ref(x, w, scale, shift):
    """Plain twin of ``fm_conv_bn_relu``."""
    y = F.conv3d(x, w.to(x.dtype), padding=(0, 8, 8), dilation=(1, 2, 2))
    return torch.relu(y.float() * _view(scale.float()) + _view(shift.float())).to(x.dtype)


def fm_conv_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor) -> torch.Tensor:
    """x ``(B, 3, N, H, W)``, w ``(8, 3, 1, 9, 9)``, scale/shift ``(8,)`` ->
    ``(B, 8, N, H, W)`` in x.dtype.  Any H, W >= 1."""
    _check_act(x, 3)
    _check_param(w, (8, 3, 1, 9, 9), "w")
    _check_param(scale, (8,), "scale")
    _check_param(shift, (8,), "shift")
    if x.device.type == "cpu":
        return fm_conv_bn_relu_ref(x, w, scale, shift)
    if x.device.type != "cuda":
        raise _unsupported(x)
    lib, stream = _cuda_args(x)
    b, _, n, h, wd = x.shape
    w, scale, shift = (_param(t, x) for t in (w, scale, shift))
    y = torch.empty((b, 8, n, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dffx_fm_conv_bn_relu(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            b, n, h, wd, _DTYPES[x.dtype], stream)
    _raise_on(err, "fm_conv_bn_relu")
    launches["fm_conv_bn_relu"] += 1
    return y


# --------------------------------------------------------------------------
# rb2d_residual
# --------------------------------------------------------------------------


def rb2d_residual_ref(x, w1, aff1: Affine, w2, aff2: Affine):
    """Plain twin of ``rb2d_residual``."""
    r = F.conv3d(x, w1.to(x.dtype), padding=(0, 1, 1)).float()
    r = torch.relu(r * _view(aff1[0].float()) + _view(aff1[1].float())).to(x.dtype)
    r = F.conv3d(r, w2.to(x.dtype), padding=(0, 1, 1)).float()
    r = r * _view(aff2[0].float()) + _view(aff2[1].float())
    return torch.relu(x.float() + r).to(x.dtype)


def rb2d_residual(x: torch.Tensor, w1: torch.Tensor, aff1: Affine, w2: torch.Tensor,
                  aff2: Affine) -> torch.Tensor:
    """x ``(B, C, N, H, W)``; w1/w2 ``(C, C, 1, 3, 3)``; aff = fp32 (scale, shift)
    of shape ``(C,)``.  The kernel takes C in 8, 16, 32 and any H, W >= 1."""
    _check_act(x)
    c = x.shape[1]
    for name, t in (("w1", w1), ("w2", w2)):
        _check_param(t, (c, c, 1, 3, 3), name)
    for name, t in (("aff1", aff1), ("aff2", aff2)):
        _check_param(t[0], (c,), f"{name} scale")
        _check_param(t[1], (c,), f"{name} shift")
    if x.device.type == "cpu":
        return rb2d_residual_ref(x, w1, aff1, w2, aff2)
    if x.device.type != "cuda":
        raise _unsupported(x)
    lib, stream = _cuda_args(x, _KERNEL_CHANNELS)
    b, _, n, h, wd = x.shape
    ps = [_param(t, x) for t in (w1, aff1[0], aff1[1], w2, aff2[0], aff2[1])]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.dffx_rb2d_residual(
            x.data_ptr(), *(p.data_ptr() for p in ps), y.data_ptr(),
            b, c, n, h, wd, _DTYPES[x.dtype], stream)
    _raise_on(err, "rb2d_residual")
    launches["rb2d_residual"] += 1
    return y


# --------------------------------------------------------------------------
# srd_attention_residual
# --------------------------------------------------------------------------


def srd_attention_residual_ref(f, wn, w1):
    """Plain twin of ``srd_attention_residual``."""
    a = torch.relu(F.conv3d(f, wn.to(f.dtype), padding=(1, 0, 0)))
    return f + torch.relu(F.conv3d(a, w1.to(f.dtype)))


def srd_attention_residual(f: torch.Tensor, wn: torch.Tensor, w1: torch.Tensor
                           ) -> torch.Tensor:
    """f ``(B, C, N, H, W)``; wn ``(C, C, 3, 1, 1)``; w1 ``(C, C, 1, 1, 1)``; both
    bias-free.  The kernel takes C in 8, 16, 32 and any N, H, W >= 1."""
    _check_act(f)
    c = f.shape[1]
    _check_param(wn, (c, c, 3, 1, 1), "wn")
    _check_param(w1, (c, c, 1, 1, 1), "w1")
    if f.device.type == "cpu":
        return srd_attention_residual_ref(f, wn, w1)
    if f.device.type != "cuda":
        raise _unsupported(f)
    lib, stream = _cuda_args(f, _KERNEL_CHANNELS)
    b, _, n, h, wd = f.shape
    wn, w1 = _param(wn, f), _param(w1, f)
    y = torch.empty_like(f)
    with torch.cuda.device(f.device):
        err = lib.dffx_srd_attention_residual(
            f.data_ptr(), wn.data_ptr(), w1.data_ptr(), y.data_ptr(),
            b, c, n, h, wd, _DTYPES[f.dtype], stream)
    _raise_on(err, "srd_attention_residual")
    launches["srd_attention_residual"] += 1
    return y


# --------------------------------------------------------------------------
# rb_of_chain
# --------------------------------------------------------------------------


def rb_of_chain_ref(x, blocks: Sequence[OFBlock]):
    """Plain twin of ``rb_of_chain``."""
    for w1, aff1, w2, aff2, ws in blocks:
        r = F.conv3d(x, w1.to(x.dtype), padding=(0, 1, 1)).float()
        r = torch.relu(r * _view(aff1[0].float()) + _view(aff1[1].float())).to(x.dtype)
        r = F.conv3d(r, w2.to(x.dtype), padding=(0, 1, 1)).float()
        r = r * _view(aff2[0].float()) + _view(aff2[1].float())
        x = torch.relu(F.conv3d(x, ws.to(x.dtype)).float() + r).to(x.dtype)
    return x


def rb_of_chain(x: torch.Tensor, blocks: Sequence[OFBlock]) -> torch.Tensor:
    """Consecutive stride-1 ``resnet_block_2d_OF``s in one launch.

    x ``(B, Cin, N, H, W)``; per block w1 ``(Cout, Cin, 1, 3, 3)``, w2
    ``(Cout, Cout, 1, 3, 3)``, the 1x1 projection shortcut ws ``(Cout, Cin, 1,
    1, 1)``, all bias-free, and aff = fp32 (scale, shift) ``(Cout,)``.  The
    kernel takes the chains (3->8, 8->8), (16->16) and (32->32) and any
    B, N, H, W >= 1; the twin takes any chain.  The weights are repacked on
    every call (``rb_of_chain_params``)."""
    _check_act(x)
    if not blocks:
        raise ValueError("rb_of_chain needs at least one block")
    chans, cin = [], x.shape[1]
    for k, (w1, aff1, w2, aff2, ws) in enumerate(blocks):
        cout = w1.shape[0]
        _check_param(w1, (cout, cin, 1, 3, 3), f"block {k} w1")
        _check_param(w2, (cout, cout, 1, 3, 3), f"block {k} w2")
        _check_param(ws, (cout, cin, 1, 1, 1), f"block {k} ws")
        for name, t in (("aff1", aff1), ("aff2", aff2)):
            _check_param(t[0], (cout,), f"block {k} {name} scale")
            _check_param(t[1], (cout,), f"block {k} {name} shift")
        chans.append((cin, cout))
        cin = cout
    if x.device.type == "cpu":
        return rb_of_chain_ref(x, blocks)
    if x.device.type != "cuda":
        raise _unsupported(x)
    if tuple(chans) not in _RB_OF_CHAINS:
        raise ValueError(f"kernel built for chains {_RB_OF_CHAINS}, got {tuple(chans)}")
    lib, stream = _cuda_args(x, bn_in_grid=False)
    b, _, n, h, wd = x.shape
    params = rb_of_chain_params(x, blocks)
    y = torch.empty((b, cin, n, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dffx_rb_of_chain(
            x.data_ptr(), params.data_ptr(), y.data_ptr(),
            b, chans[0][0], cin, len(blocks), n, h, wd, _DTYPES[x.dtype], stream)
    _raise_on(err, "rb_of_chain")
    launches["rb_of_chain"] += 1
    return y


# --------------------------------------------------------------------------
# motion_head_conv_chain
# --------------------------------------------------------------------------


def motion_head_conv_chain_ref(x, w0, aff0: Affine, w1, aff1: Affine, w2, aff2: Affine,
                               w3, bias3):
    """Plain twin of ``motion_head_conv_chain``."""
    y = x
    for w, (scale, shift) in ((w0, aff0), (w1, aff1), (w2, aff2)):
        y = F.conv3d(y, w.to(x.dtype), padding=(0, 1, 1)).float()
        y = torch.relu(y * _view(scale.float()) + _view(shift.float())).to(x.dtype)
    y = F.conv3d(y, w3.to(x.dtype), padding=(0, 1, 1)).float()
    return (y + _view(bias3.float())).to(x.dtype)


def motion_head_params(x, w0, aff0: Affine, w1, aff1: Affine, w2, aff2: Affine, w3, bias3
                       ) -> torch.Tensor:
    """The fp32 buffer ``csrc/motion_head.cu`` reads, on x's device: w0, s0, b0,
    w1, s1, b1, w2, s2, b2, w3, bias3, the convs in ``fma_conv_layout``."""
    return _packed(x, (w0, *aff0, w1, *aff1, w2, *aff2, w3, bias3),
                   [fma_conv_layout, None, None] * 3 + [fma_conv_layout, None])


def motion_head_conv_chain(x: torch.Tensor, w0: torch.Tensor, aff0: Affine,
                           w1: torch.Tensor, aff1: Affine, w2: torch.Tensor, aff2: Affine,
                           w3: torch.Tensor, bias3: torch.Tensor) -> torch.Tensor:
    """The eval motion head before its pooling: three (1,3,3) pad-1 conv + BN
    + ReLU and a biased (1,3,3) conv to 3 channels.

    x ``(B, Cin, N, H, W)``; w0 ``(C, Cin, 1, 3, 3)``; w1/w2 ``(C, C, 1, 3,
    3)``; w3 ``(3, C, 1, 3, 3)``; aff = fp32 (scale, shift) ``(C,)``; bias3
    ``(3,)``.  Returns ``(B, 3, N, H, W)``.  The kernel takes (Cin, C) =
    (18, 16), the full-resolution conv3 head, and any H, W >= 1."""
    _check_act(x)
    cin, c = x.shape[1], w0.shape[0]
    _check_param(w0, (c, cin, 1, 3, 3), "w0")
    _check_param(w1, (c, c, 1, 3, 3), "w1")
    _check_param(w2, (c, c, 1, 3, 3), "w2")
    _check_param(w3, (3, c, 1, 3, 3), "w3")
    _check_param(bias3, (3,), "bias3")
    for name, t in (("aff0", aff0), ("aff1", aff1), ("aff2", aff2)):
        _check_param(t[0], (c,), f"{name} scale")
        _check_param(t[1], (c,), f"{name} shift")
    if x.device.type == "cpu":
        return motion_head_conv_chain_ref(x, w0, aff0, w1, aff1, w2, aff2, w3, bias3)
    if x.device.type != "cuda":
        raise _unsupported(x)
    if (cin, c) not in _MOTION_HEAD_WIDTHS:
        raise ValueError(f"kernel built for (Cin, C) in {_MOTION_HEAD_WIDTHS}, got {(cin, c)}")
    lib, stream = _cuda_args(x)
    b, _, n, h, wd = x.shape
    params = motion_head_params(x, w0, aff0, w1, aff1, w2, aff2, w3, bias3)
    y = torch.empty((b, 3, n, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dffx_motion_head_conv_chain(
            x.data_ptr(), params.data_ptr(), y.data_ptr(),
            b, cin, c, n, h, wd, _DTYPES[x.dtype], stream)
    _raise_on(err, "motion_head_conv_chain")
    launches["motion_head_conv_chain"] += 1
    return y
