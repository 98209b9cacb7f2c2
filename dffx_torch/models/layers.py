"""Building blocks of DFFNet and FlowNetwork as ``nn.Module``s.

Submodule names and indices follow the reference constructors
(`Depth_Estimation_Test/Depth_Estimation_Network.py`,
`End_to_End/End_to_End.py`), so every
``state_dict`` key equals the reference key and the JAX package's param key.
Parameters stay fp32; convs run in the activation dtype (weights are cast at
use, as ``dffx`` casts its kernels).  In eval mode BN normalises with the
running statistics and the full-resolution chains run as the CUDA kernels; in
training mode (``.train()``) BN takes batch statistics and updates the running
ones, and every module runs on stock ops, as ``dffx`` under ``Ctx.train``
(the kernels have no backward).  Activations are ``(B, C, N, H, W)``, laid
out NCDHW, or NDHWC where ``DFFNet`` keeps its 16-bit eval activations so
(``ops/conv.py::activation_format``): every layer keeps the layout it is
given.

Two context variables reach the layers from the caller, as ``dffx``'s
``Ctx`` does: ``data_parallel(group)`` makes every train-mode BatchNorm take
its statistics over the group's ranks (sync BN, set by the train step), and
``spatial_serving(mesh, kernels=...)`` runs the kernels' chains H-sharded over
the mesh's spatial axis (``chain_site``, set by ``TimedForward``).

``init_module_params(Network(), seed)`` reproduces
``dffx.models.init_params(network_specs(), seed)`` bit for bit (and the same
for ``E2ENetwork`` and ``e2e_network_specs``): the same per-kind
distributions drawn from one ``np.random.default_rng(seed)`` in sorted-key
order, in the JAX package's DHWIO weight layout (load it with
``dffx_torch.checkpoint.load_jax_params``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dffx_torch.ops import batch_norm_train, bn_fused_affine, conv3d, deconv3d
from dffx_torch.ops.norm import affine_act
from dffx_torch.ops.conv import is_ndhwc, ndhwc_weight
from dffx_torch.ops.halo import sharded_rows, spatial_ok
from dffx_torch.ops.kernels import (ParamCache, fm_conv_bn_relu, fm_conv_params, rb2d_params,
                                    rb2d_residual, srd_attention_params, srd_attention_residual,
                                    tensor_stamp)


def _weight(m, x: torch.Tensor) -> torch.Tensor:
    """The weight of the conv or deconv ``m`` as it reads ``x``: for an NDHWC
    ``x`` on the card, cast and NDHWC (``ndhwc_weight``), kept in the
    module's ``ParamCache`` until the weight changes, unless autograd records
    it; else the weight itself, which ``conv3d`` casts at each call."""
    w = m.weight
    if not is_ndhwc(x) or (torch.is_grad_enabled() and w.requires_grad):
        return w
    kept = m._kept(x, w)
    return w if kept is None else kept


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that runs in the input's dtype and layout; bias-free
    unless asked."""

    def __init__(self, cin, cout, k, *, stride=1, padding=0, dilation=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         dilation=dilation, bias=bias)
        self._kept = ParamCache(ndhwc_weight)

    def forward(self, x):
        return conv3d(x, _weight(self, x), bias=self.bias, stride=self.stride,
                      padding=self.padding, dilation=self.dilation)


class ConvTranspose3d(nn.ConvTranspose3d):
    """The reference's only deconv: k3, pad 1, stride (1,2,2), output_padding
    (0,1,1), bias-free; doubles H and W.  Runs in the input's layout."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, stride=(1, 2, 2), padding=1,
                         output_padding=(0, 1, 1), bias=False)
        self._kept = ParamCache(ndhwc_weight)

    def forward(self, x):
        return deconv3d(x, _weight(self, x))


#: set while ``torch.utils.checkpoint`` recomputes a stage in the backward
_RECOMPUTING = contextvars.ContextVar("dffx_torch_recomputing", default=False)
#: the process group train-mode BatchNorm takes its statistics over (sync BN)
_DATA_GROUP = contextvars.ContextVar("dffx_torch_data_group", default=None)
#: the spatial mesh the kernels' chains run sharded over (``SpatialServing``)
_SPATIAL = contextvars.ContextVar("dffx_torch_spatial", default=None)


@contextlib.contextmanager
def _setting(var: contextvars.ContextVar, value):
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


def data_parallel(group):
    """Within the block, train-mode ``BatchNorm3d`` takes its batch statistics
    over ``group``'s ranks (``None``: this rank's batch alone)."""
    return _setting(_DATA_GROUP, group)


@dataclasses.dataclass(frozen=True)
class SpatialServing:
    """The spatial mesh and whether the chains run the kernels (``False``:
    their stock layers, ``--spatial-xla``)."""

    mesh: Any
    kernels: bool = True


def spatial_serving(mesh, *, kernels: bool = True):
    """Within the block, eval forwards run the kernels' chains H-sharded over
    ``mesh``'s spatial axis (``chain_site``)."""
    return _setting(_SPATIAL, SpatialServing(mesh, kernels))


def chain_site(x: torch.Tensor, kernel_fn, stock_fn, *, bleed: int) -> torch.Tensor:
    """An eval chain of the kernels: ``kernel_fn(x)``, or under
    ``spatial_serving`` the chain sharded over the spatial axis where its
    height splits (``halo.sharded_rows``: this rank's rows plus halo rows,
    ``stock_fn`` patching the true edges, then one all-gather along H) and
    whole on every rank where it does not.  With ``kernels=False`` the stock
    layers run in place of the kernels, sharded or whole."""
    spatial = _SPATIAL.get()
    if spatial is None:
        return kernel_fn(x)
    fn = kernel_fn if spatial.kernels else stock_fn
    if not spatial_ok(spatial.mesh, x.shape[3]):
        return fn(x)
    return sharded_rows(fn, x, spatial.mesh, edge_fn=stock_fn, bleed=bleed)


@contextlib.contextmanager
def _recomputation(group):
    with _setting(_RECOMPUTING, True), data_parallel(group):
        yield


def _checkpoint_contexts():
    """``context_fn`` of ``ckpt_stage``: nothing around the forward; around
    the recomputation, the recompute flag and the forward's data group
    (the recomputation may run on another thread: autograd's for the device)."""
    return contextlib.nullcontext(), _recomputation(_DATA_GROUP.get())


def ckpt_stage(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` (and autograd recording) under
    ``torch.utils.checkpoint``, so that the stage's internal activations are
    recomputed in the backward instead of kept (``dffx/models/layers.py::
    ckpt_stage``).  The recomputation updates no BN running statistic: the
    forward already did (``BatchNorm3d.forward``)."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    # no op of the model draws random numbers: no RNG state to keep
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=_checkpoint_contexts)


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm3d with the JAX package's numerics (``dffx_torch.ops.norm``),
    and with what follows it where the caller says: ``bn(x, z=r, relu=True)``
    is ``relu(bn(x) + r)``.

    In eval mode ``ops/norm.py::affine_act`` applies the folded affine, the
    add and the ReLU, in one pass where the activation allows.  In training
    mode it normalises with the batch statistics, over the ranks of the
    ``data_parallel`` group where one is set, and writes the new running
    statistics in place, ``num_batches_tracked`` + 1
    (``dffx/models/layers.py::apply_bn``), except while a checkpointed stage
    is recomputed in the backward (``ckpt_stage``); the add and the ReLU
    follow as ops of their own."""

    #: takes ``z`` and ``relu`` (``Seq``)
    takes_act = True

    def forward(self, x, *, z=None, relu: bool = False):
        if not self.training:
            return affine_act(x, *self.fused_affine(x.dtype), z=z, relu=relu)
        y, mean, var = batch_norm_train(x, self.running_mean, self.running_var,
                                        self.weight, self.bias, eps=self.eps,
                                        group=_DATA_GROUP.get())
        if not _RECOMPUTING.get():
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
                self.num_batches_tracked.add_(1)
        if z is not None:
            y = y + z
        return torch.relu(y) if relu else y

    _kept_affines = None

    def fused_affine(self, dtype: torch.dtype | None = None):
        """The fused fp32 (scale, shift) the kernels take, or with ``dtype``
        rounded to it (what eval BN applies to an activation of that dtype):
        the same two tensors from call to call until a statistic or an affine
        parameter changes (``tensor_stamp``), so that a ``ParamCache`` can
        tell.  It folds the running statistics, so it is for eval mode only."""
        if self.training:
            raise RuntimeError("fused_affine folds the running statistics: eval mode only; "
                               "in training mode the BN normalises with batch statistics")
        src = (self.weight, self.bias, self.running_mean, self.running_var)

        def fold():
            scale, shift = bn_fused_affine(*src, self.eps)
            return (scale, shift) if dtype is None else (scale.to(dtype), shift.to(dtype))

        if torch.is_grad_enabled() and any(t.requires_grad for t in src):
            return fold()  # part of a graph: not kept
        if self._kept_affines is None:
            self._kept_affines = {}
        key = tuple(map(tensor_stamp, src))
        kept = self._kept_affines.get(dtype)
        if kept is None or kept[0] != key:
            kept = self._kept_affines[dtype] = (key, fold())
        return kept[1]


class Seq(nn.Sequential):
    """``nn.Sequential`` with the same children, indices and keys, whose
    forward hands each ``BatchNorm3d`` (or a child that ends in one:
    ``takes_act``) the ``nn.ReLU`` right after it, and its last child the
    caller's ``z`` and ``relu``: ``seq(x, z=r, relu=True)`` is ``relu(seq(x)
    + r)``.  In eval mode each such BN then runs as one pass with them
    (``ops/norm.py::affine_act``)."""

    @property
    def takes_act(self) -> bool:
        return getattr(self[-1], "takes_act", False)

    def forward(self, x, *, z=None, relu: bool = False):
        mods = list(self)
        last = len(mods) - 1
        ends_in_bn = self.takes_act
        if (z is not None or relu) and not ends_in_bn:
            raise TypeError(f"{type(mods[last]).__name__} takes no z or relu")
        i = 0
        while i <= last:
            m = mods[i]
            if i == last and ends_in_bn:
                x = m(x, z=z, relu=relu)
            elif getattr(m, "takes_act", False) and isinstance(mods[i + 1], nn.ReLU):
                x = m(x, relu=True)
                i += 1
            else:
                x = m(x)
            i += 1
        return x


class ConvBN3d(Seq):
    """``convbn_3d`` = Sequential(Conv3d(bias=False), BatchNorm3d)."""

    def __init__(self, cin, cout, k, **conv_kw):
        super().__init__(Conv3d(cin, cout, k, **conv_kw), BatchNorm3d(cout))


class DeconvBN3d(Seq):
    """Sequential(ConvTranspose3d(bias=False), BatchNorm3d)."""

    def __init__(self, cin, cout):
        super().__init__(ConvTranspose3d(cin, cout), BatchNorm3d(cout))


def convbn_relu(cin, cout, k, **conv_kw) -> Seq:
    return Seq(ConvBN3d(cin, cout, k, **conv_kw), nn.ReLU())


class ResnetBlock2d(nn.Module):
    """Two (1,3,3) convbn with a residual (`Depth_Estimation_Network.py:295-304`)."""

    def __init__(self, c):
        super().__init__()
        self.conv = Seq(
            ConvBN3d(c, c, (1, 3, 3), padding=(0, 1, 1)), nn.ReLU(),
            ConvBN3d(c, c, (1, 3, 3), padding=(0, 1, 1)))

    def forward(self, x):
        return self.conv(x, z=x, relu=True)


class SRD(nn.Module):
    """Stack-reduction block: spatial residual features plus additive
    focus-axis attention (`Depth_Estimation_Network.py:317-330`)."""

    def __init__(self, c):
        super().__init__()
        self.Focus_Measure = ResnetBlock2d(c)
        self.N_ch_attention = nn.Sequential(
            Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0)), nn.ReLU(),
            Conv3d(c, c, 1), nn.ReLU())

    def forward(self, x):
        f = self.Focus_Measure(x)
        return f + self.N_ch_attention(f)


class EFD(nn.Module):
    """Dual-branch spatial downsampling: strided conv + maxpool-conv, summed
    (`Depth_Estimation_Network.py:306-315`).  Never strides the focus axis."""

    def __init__(self, cin, cout):
        super().__init__()
        self.stride_conv = ConvBN3d(cin, cout, 3, stride=(1, 2, 2), padding=1)
        self.max_pooling = Seq(nn.MaxPool3d((1, 2, 2)), ConvBN3d(cin, cout, 3, padding=1))

    def forward(self, x):
        return self.max_pooling(x, z=self.stride_conv(x), relu=True)


class FMModule(nn.Module):
    """Full-resolution focus-measure extraction: dilated (1,9,9) conv + BN +
    ReLU, then an SRD (`Depth_Estimation_Network.py:131-143`).

    In eval mode it runs as the three kernels, chained channel-first like
    ``dffx/models/layers.py::_fm_fused_chain``: conv -> rb2d -> attention.  On
    CUDA tensors they launch the CUDA kernels; on CPU tensors their plain
    twins run through the same chain.  Under ``spatial_serving`` the chain
    runs H-sharded (``chain_site``, bleed 2: the dilated first conv is linear
    over the zero rows, only the rb2d pair propagates).  In training mode it
    runs its ``Focus_extraction`` on stock ops, as ``fm_module_apply`` takes
    its XLA chain under ``ctx.train``."""

    def __init__(self):
        super().__init__()
        self.Focus_extraction = Seq(
            ConvBN3d(3, 8, (1, 9, 9), padding=(0, 8, 8), dilation=(1, 2, 2)),
            nn.ReLU(),
            SRD(8))
        self._conv_params = ParamCache(fm_conv_params)
        self._rb_params = ParamCache(rb2d_params)
        self._srd_params = ParamCache(srd_attention_params)

    def forward(self, x):
        if self.training:
            return self.Focus_extraction(x)
        return chain_site(x, self._kernel_chain, self.Focus_extraction, bleed=2)

    def _kernel_chain(self, x):
        conv, _, srd = self.Focus_extraction
        args = (conv[0].weight, *conv[1].fused_affine())
        y = fm_conv_bn_relu(x, *args, params=self._conv_params(x, *args))
        rb = srd.Focus_Measure.conv
        args = (rb[0][0].weight, rb[0][1].fused_affine(), rb[2][0].weight, rb[2][1].fused_affine())
        f = rb2d_residual(y, *args, params=self._rb_params(y, *args))
        att = srd.N_ch_attention
        args = (att[0].weight, att[2].weight)
        return srd_attention_residual(f, *args, params=self._srd_params(f, *args))


# ---------------------------------------------------------------------------
# Parameter init, bit-equal to the JAX package's
# ---------------------------------------------------------------------------


def _dhwio(shape, transposed: bool) -> tuple:
    """torch weight shape -> dffx (kd, kh, kw, Cin, Cout)."""
    if transposed:  # (Cin, Cout, d, h, w)
        return (*shape[2:], shape[0], shape[1])
    return (*shape[2:], shape[1], shape[0])  # (Cout, Cin, d, h, w)


def init_module_params(module: nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """Fresh parameters for ``module``'s state_dict keys, in the JAX package's
    layout and draw.  Convs inside a module that sets ``msra_init`` (DFFNet,
    whose reference constructor runs an init loop over its own modules,
    `Depth_Estimation_Network.py:59-73`) draw ``N(0, sqrt(2 / (prod(k) *
    Cout)))``; every other conv keeps torch's default ``U(+-1/sqrt(Cin *
    prod(k)))`` and its bias ``U(+-1/sqrt(Cin * prod(k)))``; deconvs draw
    ``U(+-1/sqrt(Cout * prod(k)))``; BN weight/var 1, bias/mean 0."""
    msra_roots = [f"{name}." if name else "" for name, m in module.named_modules()
                  if getattr(m, "msra_init", False)]
    kinds = {}
    for name, m in module.named_modules():
        pfx = f"{name}." if name else ""
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            tr = isinstance(m, nn.ConvTranspose3d)
            if tr:
                if m.bias is not None:
                    raise ValueError(f"{name}: deconv biases are not part of the model")
                kind = "deconv"
            else:
                kind = ("conv_msra" if any(pfx.startswith(r) for r in msra_roots)
                        else "conv_default")
            kinds[pfx + "weight"] = (kind, _dhwio(m.weight.shape, tr))
            if m.bias is not None:
                fan_in = math.prod(m.weight.shape[1:])
                kinds[pfx + "bias"] = ("bias", tuple(m.bias.shape), fan_in)
        elif isinstance(m, nn.BatchNorm3d):
            c = (m.num_features,)
            kinds.update({pfx + "weight": ("one", c), pfx + "bias": ("zero", c),
                          pfx + "running_mean": ("zero", c),
                          pfx + "running_var": ("one", c),
                          pfx + "num_batches_tracked": ("count", ())})
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for key, (kind, shape, *fan_in) in sorted(kinds.items()):
        if kind == "conv_msra":
            *k, _cin, cout = shape
            v = rng.normal(0.0, math.sqrt(2.0 / (math.prod(k) * cout)), size=shape)
        elif kind == "conv_default":
            *k, cin, _cout = shape
            bound = 1.0 / math.sqrt(cin * math.prod(k))
            v = rng.uniform(-bound, bound, size=shape)
        elif kind == "bias":
            bound = 1.0 / math.sqrt(fan_in[0])
            v = rng.uniform(-bound, bound, size=shape)
        elif kind == "deconv":
            *k, _cin, cout = shape
            bound = 1.0 / math.sqrt(cout * math.prod(k))
            v = rng.uniform(-bound, bound, size=shape)
        elif kind == "count":
            out[key] = np.zeros(shape, dtype=np.int64)
            continue
        else:
            v = (np.ones if kind == "one" else np.zeros)(shape)
        out[key] = v.astype(np.float32)
    return out
