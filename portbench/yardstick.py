"""The benchmark's arithmetic, frozen here so that no change to the program
moves the yardstick: the card's published peaks, the bytes and operations of
each of the program's five kernels from its shapes (a copy of
``chip_smoke.py``'s ``WORK`` and ``bound_ms``), the names by which the trace
shows them, and the convolution FLOPs of a stack, counted on the plain
reference.  The kernels a forward launches, and the work and names of any
kernel beyond the five, come from the network's module
(``portbench/networks``), which adds to these tables and replaces nothing.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import networks

#: one NVIDIA H100 SXM at its full power limit of 700 W (NVIDIA's data
#: sheet, dense rates): HBM bytes/s, TF32 and bf16 tensor-core FLOP/s, and
#: fp32 outside the tensor cores (fp32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
#: the peak a step in each stated precision is held to
PEAK_FLOP_PER_S = {"bfloat16": BF16_FLOP_PER_S, "float32": FP32_FLOP_PER_S}

#: substrings of the device-kernel names of the program's own library
#: (``dffx_torch/csrc``: fm_conv.cu, rb2d.cu and rb_of.cu's blocks, srd_attention.cu,
#: rb_of.cu's pair, motion_head.cu)
PORT_KERNELS = ("fm_conv_bn_relu", "res_block_kernel", "srd_attention_kernel", "rb_of_pair",
                "motion_head")
#: substrings of NCCL's device kernels
NCCL_KERNELS = ("nccl",)


def port_kernels(network: str) -> Tuple[str, ...]:
    """The name substrings of the kernels that a cell of ``network`` counts
    as the program's own: the five kernels' and its module's ``KERNELS``.
    Each cell counts by its own network, so that a network that joins moves
    no reading of another's cells."""
    return PORT_KERNELS + tuple(networks.load(network).KERNELS)


def is_port_kernel(name: str, kernels: Tuple[str, ...]) -> bool:
    return any(s in name for s in kernels)


def is_nccl_kernel(name: str) -> bool:
    return any(s in name.lower() for s in NCCL_KERNELS)


def _conv_flop(w: tuple) -> int:
    """FLOP per output pixel of a conv with weight shape (Cout, Cin, kd, kh, kw)."""
    return 2 * math.prod(w)


#: per kernel, from its input's channels and its weights' shapes: (FLOP per
#: pixel of the convs that read the input, FLOP per pixel of the convs that
#: read an intermediate, channels read + written per pixel)
WORK = {
    "fm_conv_bn_relu": lambda c, w: (_conv_flop(w), 0, 3 + 8),
    "rb2d_residual": lambda c, w1, w2: (_conv_flop(w1), _conv_flop(w2), 2 * c),
    "srd_attention_residual": lambda c, wn, w1: (_conv_flop(wn), _conv_flop(w1), 2 * c),
    # blocks: (w1, w_shortcut, w2) of each resnet_block_2d_OF
    "rb_of_chain": lambda c, blocks: (
        _conv_flop(blocks[0][0]) + _conv_flop(blocks[0][1]),
        sum(_conv_flop(w2) for _, _, w2 in blocks)
        + sum(_conv_flop(w1) + _conv_flop(ws) for w1, ws, _ in blocks[1:]),
        c + blocks[-1][0][0]),
    "motion_head_conv_chain": lambda c, w0, w1, w2, w3: (
        _conv_flop(w0), sum(_conv_flop(w) for w in (w1, w2, w3)), c + 3),
}


def work(network: str) -> Dict:
    """``WORK`` with the work of the kernels that ``network``'s module adds;
    a module that names one of the five raises."""
    added = networks.load(network).WORK
    clash = sorted(set(added) & set(WORK))
    if clash:
        raise ValueError(f"network {network!r} redefines the frozen work of {clash}")
    return {**WORK, **added}


def bound_s(name: str, x_shape: tuple, bf16: bool, *weights, table: Dict = WORK) -> float:
    """The least time the card could take for one launch on an input of
    ``x_shape`` (B, C, N, H, W): the larger of its bytes (every input and
    output element moved once, 2 bytes in bf16 and 4 in fp32) over the HBM
    rate and its operations over the tensor cores' rate (bf16: one product a
    multiply-accumulate at the bf16 rate; fp32: three TF32 products)."""
    flop_in, flop_mid, chans = table[name](x_shape[1], *weights)
    pixels = math.prod(x_shape) // x_shape[1]
    by_bytes = pixels * chans * (2 if bf16 else 4) / HBM_BYTES_PER_S
    if bf16:
        by_ops = pixels * (flop_in + flop_mid) / BF16_FLOP_PER_S
    else:
        by_ops = pixels * 3 * (flop_in + flop_mid) / TF32_FLOP_PER_S
    return max(by_bytes, by_ops)


def forward_bound_s(network: str, b: int, stack: tuple, bf16: bool) -> float:
    """Sum of ``bound_s`` over the launches of one eval forward of
    ``network`` at batch ``b`` of ``stack`` (its module's ``launches``)."""
    table = work(network)
    return sum(bound_s(k, x, bf16, *ws, table=table)
               for k, x, ws in networks.load(network).launches(b, stack))


@functools.lru_cache(maxsize=None)
def conv_flops_per_stack(network: str, stack: tuple) -> float:
    """The convolution and deconvolution FLOPs of one stack's forward through
    the plain reference, counted on meta tensors: the work whatever
    implements it (a packed graph's zero taps and the warps' products do not
    count)."""
    net = networks.load(network)
    params = {k: torch.empty(shape, device="meta", dtype=torch.int64 if kind[0] == "count"
                             else torch.float32) for k, (shape, kind) in net.specs().items()}
    counter = FlopCounterMode(display=False)
    with counter:
        net.reference(params, net.probe_inputs(stack, "meta"))
    counts: Dict = counter.get_flop_counts().get("Global", {})
    return float(sum(v for op, v in counts.items() if "convolution" in str(op)))
