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

The kernels have no backward.  A wrapper that would have to carry gradients
(a CUDA tensor, grad enabled, and the input or a weight or affine that requires
grad: ``cuts_gradients``) raises instead of handing back a tensor whose graph
ends at it; the twins, on the CPU, carry gradients as any torch op does.
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
    "mma_conv_layout",
    "head_conv0_layout",
    "pair_conv0_layout",
    "fm_conv_taps",
    "fm_conv_layout",
    "fm_conv_params",
    "rb2d_params",
    "rb_of_chain_params",
    "motion_head_params",
    "ParamCache",
    "tensor_stamp",
    "cuts_gradients",
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


def cuts_gradients(on_cuda: bool, grad_enabled: bool, requires_grad) -> bool:
    """Whether a launch would cut an autograd graph without a word: the kernel
    would run (a CUDA tensor), autograd is recording, and one of the tensors
    it reads (``requires_grad``: a flag each) is part of a graph."""
    return bool(on_cuda and grad_enabled and any(requires_grad))


def _cuda_args(x: torch.Tensor, c_ok=None, *, name: str, reads=()):
    """Check what only the kernel needs; returns (library, stream handle).
    ``reads``: the weights and affines the launch reads beside x."""
    if cuts_gradients(x.is_cuda, torch.is_grad_enabled(),
                      (t.requires_grad for t in _tensors((x, *reads)))):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and its input or a weight requires "
            "grad with grad enabled; call it under torch.no_grad() or inference_mode()")
    if not x.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous (B, C, N, H, W) tensors")
    if c_ok is not None and x.shape[1] not in c_ok:
        raise ValueError(f"kernel built for C in {c_ok}, got C = {x.shape[1]}")
    return _build.library(), torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _gather_index(shapes: tuple, layouts: tuple, device: torch.device) -> torch.Tensor:
    """Where each packed entry sits in the concatenation of the flat tensors;
    a layout's padding (-1) points at the 0 that ``_packed`` appends."""
    parts, off = [], 0
    for shape, layout in zip(shapes, layouts):
        idx = torch.arange(off, off + math.prod(shape)).view(shape)
        parts.append(layout(idx) if layout else idx.reshape(-1))
        off += idx.numel()
    index = torch.cat(parts)
    return torch.where(index < 0, off, index).to(device)


def _packed(x: torch.Tensor, tensors, layouts) -> torch.Tensor:
    """Weights and affines in order, each flattened in its layout (``None``:
    as it is), back to back in one fp32 buffer on x's card.  One
    concatenation and one gather: the host's work per call stays two
    launches."""
    flat = torch.cat([t.reshape(-1) for t in (*tensors, tensors[0].new_zeros(1))]).float()
    if flat.device != x.device:
        raise ValueError(f"parameters on {flat.device}, activations on {x.device}")
    return flat.take(_gather_index(tuple(tuple(t.shape) for t in tensors), tuple(layouts),
                                   x.device))


def tensor_stamp(t: torch.Tensor) -> tuple:
    """What tells that a tensor is still the one seen before, unchanged: its
    identity, address and version counter (an inference tensor has none and
    cannot be written in place outside inference mode)."""
    return (id(t), t.data_ptr(), None if t.is_inference() else t._version)


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        else:
            yield from _tensors(a)


class ParamCache:
    """What one call site derives from its weights (a kernel's packed
    parameter buffer; ``models/packed.py``'s scattered conv weights), made
    again only when the device, the activation dtype or one of the source
    tensors changes.

    Eval weights are constants, and packing them (``fm_conv_params``,
    ``rb2d_params``, ``rb_of_chain_params``, ``motion_head_params``) costs the host about
    0.1 ms a call, which a small image or an idle card shows.  A module keeps
    one ``ParamCache(pack)`` per kernel it calls and hands ``cache(x, *args)``
    to the wrapper as ``params``; for a CPU tensor that is ``None`` (the twin
    takes the weights as they are).  The sources are recognised by
    ``tensor_stamp`` and kept alive here, so a write through ``.data`` at the
    same address goes unseen: call ``clear()`` after one."""

    def __init__(self, pack):
        self._pack = pack
        self.clear()

    def clear(self) -> None:
        self._key = self._held = self._buf = None

    def __call__(self, x: torch.Tensor, *args):
        if x.device.type != "cuda":
            return None
        held = list(_tensors(args))
        key = (x.device, x.dtype, *map(tensor_stamp, held))
        if key != self._key:
            self._buf = self._pack(x, *args)
            self._key, self._held = key, held
        return self._buf

    def or_packed(self, x: torch.Tensor, *args):
        """As a call, for what is needed on the CPU too: nothing is kept
        there, it is made on every call."""
        buf = self(x, *args)
        return self._pack(x, *args) if buf is None else buf


def _use_params(params, x: torch.Tensor, tensors, layouts) -> torch.Tensor:
    """The packed buffer a launch reads: the caller's (``ParamCache``), after
    a check of its device, type and size, or one packed now."""
    if params is None:
        return _packed(x, tensors, layouts)
    want = _gather_index(tuple(tuple(t.shape) for t in tensors), tuple(layouts),
                         x.device).numel()
    if (params.device != x.device or params.dtype != torch.float32
            or not params.is_contiguous() or params.numel() != want):
        raise ValueError(f"params: expected {want} contiguous float32 on {x.device}, got "
                         f"{params.numel()} {params.dtype} on {params.device}")
    return params


def _pad_value(w: torch.Tensor) -> int:
    """What a layout pads with: 0 in a weight, -1 in a tensor of indices
    (``_gather_index`` sends those to a 0)."""
    return 0 if w.is_floating_point() else -1


def _b_fragments(wk: torch.Tensor) -> torch.Tensor:
    """``(Cout, K)``, both multiples of 8, as B fragments of ``mma.sync``
    m16n8k8 (``csrc/mma.cuh``): flat ``[K // 8][Cout // 8][lane][2]``, where
    entry (lane, j) holds k = 8 ks + 4 j + lane % 4 and cout = 8 nb + lane // 4."""
    co, k = wk.shape
    return (wk.reshape(co // 8, 8, k // 8, 2, 4)   # nb, g, ks, j, t
            .permute(2, 0, 1, 4, 3).reshape(-1))   # ks, nb, g, t, j


def mma_conv_layout(w: torch.Tensor) -> torch.Tensor:
    """Conv weight ``(Cout, Cin, 1, kh, kw)`` as B fragments: flat
    ``[tap][cin // 8][cout // 8][lane][2]``, k = tap * Cin + cin.  Cin and
    Cout are padded to multiples of 8 (zero weights)."""
    co, ci = w.shape[:2]
    w = F.pad(w.reshape(co, ci, -1), (0, 0, 0, -ci % 8, 0, -co % 8), value=_pad_value(w))
    return _b_fragments(w.permute(0, 2, 1).reshape(w.shape[0], -1))


def head_conv0_layout(w: torch.Tensor) -> torch.Tensor:
    """The motion head's first conv ``(16, 18, 1, 3, 3)`` as ``csrc/
    motion_head.cu`` reads it: channels 0..15 in ``mma_conv_layout`` (18
    k-steps), then channels 16 and 17 as three k-steps of their own, k =
    9 (cin - 16) + tap, padded from 18 to 24."""
    co = w.shape[0]
    tail = F.pad(w[:, 16:].reshape(co, -1), (0, 6), value=_pad_value(w))
    return torch.cat([mma_conv_layout(w[:, :16]), _b_fragments(tail)])


def pair_conv0_layout(w: torch.Tensor) -> torch.Tensor:
    """The first conv of ``rb_of_chain``'s 3 -> 8 -> 8 pair ``(8, 3, 1, 3, 3)``
    as ``csrc/rb_of.cu`` reads it: B fragments of four k-steps, k = 9 cin +
    tap, padded from 27 to 32."""
    wk = w.reshape(w.shape[0], -1)
    return _b_fragments(F.pad(wk, (0, -wk.shape[1] % 8), value=_pad_value(w)))


def fm_conv_taps() -> torch.Tensor:
    """The K order of ``csrc/fm_conv.cu``: 248 entries, each the flat tap
    ``(cin * 9 + ky) * 9 + kx`` of the ``(3, 9, 9)`` kernel or -1 (padding).
    k-steps 0..26: one (cin, ky) each, kx = 0..7; 27..29: kx = 8 of one cin, ky
    = 0..7; 30: (8, 8) of the three cin, then five of padding."""
    c, ky, kx = torch.meshgrid(torch.arange(3), torch.arange(9), torch.arange(9), indexing="ij")
    flat = (c * 9 + ky) * 9 + kx
    return torch.cat([flat[:, :, :8].reshape(-1), flat[:, :8, 8].reshape(-1), flat[:, 8, 8],
                      torch.full((5,), -1)])


def fm_conv_layout(w: torch.Tensor) -> torch.Tensor:
    """The focus-measure conv ``(8, 3, 1, 9, 9)`` as B fragments in
    ``fm_conv_taps`` order: flat ``[31][lane][2]``."""
    wk = F.pad(w.reshape(8, 243), (0, 1), value=_pad_value(w))  # column 243: the padding
    return _b_fragments(wk[:, fm_conv_taps()])


def _pad_to_4(v: torch.Tensor) -> torch.Tensor:
    return F.pad(v, (0, -v.numel() % 4), value=_pad_value(v))


def _fm_conv_plan(w, scale, shift):
    return (w, scale, shift), (fm_conv_layout, None, None)


def fm_conv_params(x: torch.Tensor, w, scale, shift) -> torch.Tensor:
    """The fp32 buffer ``csrc/fm_conv.cu`` reads, on x's device: w in
    ``fm_conv_layout``, scale, shift."""
    return _packed(x, *_fm_conv_plan(w, scale, shift))


def _rb2d_plan(w1, aff1: Affine, w2, aff2: Affine):
    return ((w1, *aff1, w2, *aff2),
            (mma_conv_layout, None, None, mma_conv_layout, None, None))


def rb2d_params(x: torch.Tensor, w1, aff1: Affine, w2, aff2: Affine) -> torch.Tensor:
    """The fp32 buffer ``csrc/rb2d.cu`` reads, on x's device: w1, s1, b1, w2,
    s2, b2, the convs in ``mma_conv_layout``."""
    return _packed(x, *_rb2d_plan(w1, aff1, w2, aff2))


def _rb_of_chain_plan(blocks: Sequence[OFBlock]):
    tensors, layouts = [], []
    for w1, aff1, w2, aff2, ws in blocks:
        narrow = w1.shape[1] % 8 != 0  # the pair's 3-channel input
        tensors += [w1, *aff1, w2, *aff2, ws]
        layouts += [pair_conv0_layout if narrow else mma_conv_layout, None, None,
                    mma_conv_layout, None, None, None if narrow else mma_conv_layout]
    return tensors, layouts


def rb_of_chain_params(x: torch.Tensor, blocks: Sequence[OFBlock]) -> torch.Tensor:
    """The fp32 buffer ``csrc/rb_of.cu`` reads, on x's device: per block w1,
    s1, b1, w2, s2, b2, ws, every conv and shortcut in ``mma_conv_layout``;
    the 3 -> 8 block of the pair has its w1 in ``pair_conv0_layout`` and its
    shortcut as it is, ``[cout][cin]``."""
    return _packed(x, *_rb_of_chain_plan(blocks))


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
                    shift: torch.Tensor, *, params: torch.Tensor | None = None) -> torch.Tensor:
    """x ``(B, 3, N, H, W)``, w ``(8, 3, 1, 9, 9)``, scale/shift ``(8,)`` ->
    ``(B, 8, N, H, W)`` in x.dtype.  Any B, N, H, W >= 1.  ``params``: the
    same weights already packed (``fm_conv_params``, kept by a ``ParamCache``);
    without it they are packed on this call."""
    _check_act(x, 3)
    _check_param(w, (8, 3, 1, 9, 9), "w")
    _check_param(scale, (8,), "scale")
    _check_param(shift, (8,), "shift")
    if x.device.type == "cpu":
        return fm_conv_bn_relu_ref(x, w, scale, shift)
    if x.device.type != "cuda":
        raise _unsupported(x)
    lib, stream = _cuda_args(x, name="fm_conv_bn_relu", reads=(w, scale, shift))
    b, _, n, h, wd = x.shape
    params = _use_params(params, x, *_fm_conv_plan(w, scale, shift))
    y = torch.empty((b, 8, n, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dffx_fm_conv_bn_relu(
            x.data_ptr(), params.data_ptr(), y.data_ptr(), b, n, h, wd, _DTYPES[x.dtype], stream)
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
                  aff2: Affine, *, params: torch.Tensor | None = None) -> torch.Tensor:
    """x ``(B, C, N, H, W)``; w1/w2 ``(C, C, 1, 3, 3)``; aff = fp32 (scale, shift)
    of shape ``(C,)``.  The kernel takes C in 8, 16, 32 and any B, N, H, W >= 1.
    ``params``: the same weights already packed (``rb2d_params``, kept by a
    ``ParamCache``); without it they are packed on this call."""
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
    lib, stream = _cuda_args(x, _KERNEL_CHANNELS, name="rb2d_residual",
                             reads=(w1, aff1, w2, aff2))
    b, _, n, h, wd = x.shape
    params = _use_params(params, x, *_rb2d_plan(w1, aff1, w2, aff2))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.dffx_rb2d_residual(
            x.data_ptr(), params.data_ptr(), y.data_ptr(),
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
    bias-free.  The kernel takes C in 8, 16, 32 and any B, N, H, W >= 1."""
    _check_act(f)
    c = f.shape[1]
    _check_param(wn, (c, c, 3, 1, 1), "wn")
    _check_param(w1, (c, c, 1, 1, 1), "w1")
    if f.device.type == "cpu":
        return srd_attention_residual_ref(f, wn, w1)
    if f.device.type != "cuda":
        raise _unsupported(f)
    lib, stream = _cuda_args(f, _KERNEL_CHANNELS, name="srd_attention_residual", reads=(wn, w1))
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


def rb_of_chain(x: torch.Tensor, blocks: Sequence[OFBlock], *,
                params: torch.Tensor | None = None) -> torch.Tensor:
    """Consecutive stride-1 ``resnet_block_2d_OF``s in one launch.

    x ``(B, Cin, N, H, W)``; per block w1 ``(Cout, Cin, 1, 3, 3)``, w2
    ``(Cout, Cout, 1, 3, 3)``, the 1x1 projection shortcut ws ``(Cout, Cin, 1,
    1, 1)``, all bias-free, and aff = fp32 (scale, shift) ``(Cout,)``.  The
    kernel takes the chains (3->8, 8->8), (16->16) and (32->32) and any
    B, N, H, W >= 1; the twin takes any chain.  ``params``: the same blocks
    already packed (``rb_of_chain_params``, kept by a ``ParamCache``); without
    it they are packed on this call."""
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
    lib, stream = _cuda_args(x, name="rb_of_chain", reads=blocks)
    b, _, n, h, wd = x.shape
    params = _use_params(params, x, *_rb_of_chain_plan(blocks))
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


def _motion_head_plan(w0, aff0: Affine, w1, aff1: Affine, w2, aff2: Affine, w3, bias3):
    return ((w0, *aff0, w1, *aff1, w2, *aff2, w3, bias3),
            (head_conv0_layout, None, None, mma_conv_layout, None, None,
             mma_conv_layout, None, None, mma_conv_layout, _pad_to_4))


def motion_head_params(x, w0, aff0: Affine, w1, aff1: Affine, w2, aff2: Affine, w3, bias3
                       ) -> torch.Tensor:
    """The fp32 buffer ``csrc/motion_head.cu`` reads, on x's device: w0, s0, b0,
    w1, s1, b1, w2, s2, b2, w3, bias3: w0 in ``head_conv0_layout``, the other
    convs in ``mma_conv_layout`` (w3's 3 output channels padded to 8), bias3
    padded to 4."""
    return _packed(x, *_motion_head_plan(w0, aff0, w1, aff1, w2, aff2, w3, bias3))


def motion_head_conv_chain(x: torch.Tensor, w0: torch.Tensor, aff0: Affine,
                           w1: torch.Tensor, aff1: Affine, w2: torch.Tensor, aff2: Affine,
                           w3: torch.Tensor, bias3: torch.Tensor, *,
                           params: torch.Tensor | None = None) -> torch.Tensor:
    """The eval motion head before its pooling: three (1,3,3) pad-1 conv + BN
    + ReLU and a biased (1,3,3) conv to 3 channels.

    x ``(B, Cin, N, H, W)``; w0 ``(C, Cin, 1, 3, 3)``; w1/w2 ``(C, C, 1, 3,
    3)``; w3 ``(3, C, 1, 3, 3)``; aff = fp32 (scale, shift) ``(C,)``; bias3
    ``(3,)``.  Returns ``(B, 3, N, H, W)``.  The kernel takes (Cin, C) =
    (18, 16), the full-resolution conv3 head, and any B, N, H, W >= 1.
    ``params``: the same weights already packed (``motion_head_params``, kept
    by a ``ParamCache``); without it they are packed on this call."""
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
    lib, stream = _cuda_args(x, name="motion_head_conv_chain",
                             reads=(w0, aff0, w1, aff1, w2, aff2, w3, bias3))
    b, _, n, h, wd = x.shape
    params = _use_params(params, x,
                         *_motion_head_plan(w0, aff0, w1, aff1, w2, aff2, w3, bias3))
    y = torch.empty((b, 3, n, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dffx_motion_head_conv_chain(
            x.data_ptr(), params.data_ptr(), y.data_ptr(),
            b, cin, c, n, h, wd, _DTYPES[x.dtype], stream)
    _raise_on(err, "motion_head_conv_chain")
    launches["motion_head_conv_chain"] += 1
    return y
