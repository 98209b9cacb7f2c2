"""The benchmark's arithmetic, frozen here so that no change to the program
moves the yardstick: the card's published peaks, the bytes and operations of
each of the program's five kernels from its shapes (a copy of
``chip_smoke.py``'s ``WORK`` and ``bound_ms``), the kernels a forward
launches, the names by which the trace shows them, and the convolution FLOPs
of a stack, counted on the plain reference.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets

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


def is_port_kernel(name: str) -> bool:
    return any(s in name for s in PORT_KERNELS)


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


def bound_s(name: str, x_shape: tuple, bf16: bool, *weights) -> float:
    """The least time the card could take for one launch on an input of
    ``x_shape`` (B, C, N, H, W): the larger of its bytes (every input and
    output element moved once, 2 bytes in bf16 and 4 in fp32) over the HBM
    rate and its operations over the tensor cores' rate (bf16: one product a
    multiply-accumulate at the bf16 rate; fp32: three TF32 products)."""
    flop_in, flop_mid, chans = WORK[name](x_shape[1], *weights)
    pixels = math.prod(x_shape) // x_shape[1]
    by_bytes = pixels * chans * (2 if bf16 else 4) / HBM_BYTES_PER_S
    if bf16:
        by_ops = pixels * (flop_in + flop_mid) / BF16_FLOP_PER_S
    else:
        by_ops = pixels * 3 * (flop_in + flop_mid) / TF32_FLOP_PER_S
    return max(by_bytes, by_ops)


def launches(network: str, b: int, stack: tuple) -> List[Tuple[str, tuple, tuple]]:
    """The kernel launches of one eval forward at batch ``b`` of ``stack``
    (N, H, W): (kernel, input shape, weight shapes)."""
    n, h, w = stack
    out = [("fm_conv_bn_relu", (b, 3, n, h, w), ((8, 3, 1, 9, 9),)),
           ("rb2d_residual", (b, 8, n, h, w), ((8, 8, 1, 3, 3), (8, 8, 1, 3, 3))),
           ("srd_attention_residual", (b, 8, n, h, w), ((8, 8, 3, 1, 1), (8, 8, 1, 1, 1)))]
    if network == "e2e":
        def block(cin, cout):
            return ((cout, cin, 1, 3, 3), (cout, cin, 1, 1, 1), (cout, cout, 1, 3, 3))

        out += [("rb_of_chain", (b, 3, n, h, w), ([block(3, 8), block(8, 8)],)),
                ("rb_of_chain", (b, 16, n, h // 2, w // 2), ([block(16, 16)],)),
                ("rb_of_chain", (b, 32, n, h // 4, w // 4), ([block(32, 32)],)),
                ("motion_head_conv_chain", (b, 18, n, h, w),
                 ((16, 18, 1, 3, 3), (16, 16, 1, 3, 3), (16, 16, 1, 3, 3), (3, 16, 1, 3, 3)))]
    return out


def forward_bound_s(network: str, b: int, stack: tuple, bf16: bool) -> float:
    """Sum of ``bound_s`` over one forward's launches."""
    return sum(bound_s(k, x, bf16, *ws) for k, x, ws in launches(network, b, stack))


@functools.lru_cache(maxsize=None)
def conv_flops_per_stack(network: str, stack: tuple) -> float:
    """The convolution and deconvolution FLOPs of one stack's forward through
    the plain reference, counted on meta tensors: the work whatever
    implements it (a packed graph's zero taps and the warps' products do not
    count)."""
    specs = nets.specs(network)
    params = {k: torch.empty(shape, device="meta", dtype=torch.int64 if kind[0] == "count"
                             else torch.float32) for k, (shape, kind) in specs.items()}
    n, h, w = stack
    inputs = [torch.empty((1, n, h, w, 3), device="meta"), torch.empty((1, n), device="meta")]
    if network == "e2e":
        inputs.append(torch.empty((1, n), device="meta"))
    counter = FlopCounterMode(display=False)
    with counter:
        nets.forward(network, params, inputs)
    counts: Dict = counter.get_flop_counts().get("Global", {})
    return float(sum(v for op, v in counts.items() if "convolution" in str(op)))
