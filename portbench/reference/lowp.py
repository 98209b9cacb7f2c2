"""The control's lower precision: the reference computed in the precision
next below the one a cell states (``control``): fp8 for bf16, TF32 for fp32
with TF32 off.

fp8 comes with a scale a tensor, at every op.  Under ``fp8()`` every op's floating output that
holds a feature volume, a convolution's weight or a gradient of one (the
five-dimensional tensors) is rounded to float8 e4m3 after its largest magnitude is scaled to e4m3's
largest finite value (448), one scale a tensor: the forward and, when the
backward runs under it too, every gradient op; a convolution's operands are
rounded too, weights included, as the program casts its weights to the
activations' dtype.  What the program computes in fp32 stays fp32:
BN's batch statistics, the soft-argmax heads over the focus axis, the loss;
parameters and Adam's state are not touched.  The reference computed this way is the
control that a comparison has to fail.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0


def round_scaled(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale for the whole tensor, back in
    x's dtype."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    # clamped: a quotient a rounding above 448 would cast to NaN (e4m3fn has no inf)
    return (x / scale).clamp(-E4M3_MAX, E4M3_MAX).to(E4M3).to(x.dtype) * scale


def _rounded(t):
    if isinstance(t, torch.Tensor) and t.is_floating_point() and t.dim() == 5 and t.numel():
        return round_scaled(t)
    return t


#: ops whose operands are rounded too (none of them writes an operand in place)
ROUNDED_OPERANDS = ("convolution", "convolution_backward")


class fp8(TorchDispatchMode):
    """Within the block, every op's activation-sized floating output, and a
    convolution's operands, are rounded to scaled e4m3 (``round_scaled``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ROUNDED_OPERANDS:
            args = tree_map(_rounded, args)
        out = func(*args, **(kwargs or {}))
        return out if func.is_view else tree_map(_rounded, out)  # a view stays a view


@contextlib.contextmanager
def tf32():
    """Within the block cuDNN's convolutions and cuBLAS's products run in
    TF32 (as the card does by default for fp32)."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


#: the control of each stated precision
CONTROLS = {"bfloat16": fp8, "float32": tf32}


def control(dtype: str):
    """The context that computes the reference one precision below ``dtype``."""
    return CONTROLS[dtype]()
