#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dffx_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Builds the CUDA kernels from dffx_torch/csrc (``KERNELS``) and holds each of
the five that replace Pallas kernels against its plain PyTorch twin on the
card, in fp32 and bf16, at the shapes its paths give it, at ragged and tiny
ones, at a batch of many tiles and at more than 65,535 slices, each row with
the least time the card could take for the same work (``bound_ms``).  The
sixth, ``bn_act`` (the 16-bit eval BatchNorm's pass, with its residual add
and ReLU; it replaces no Pallas kernel), is held to its twin bit for bit in
bf16 and fp16 (``bn_act_rows``): at the three b32 serving cells' NDHWC
activations (DDFFNet's full-resolution 64 channels at b32 hold 4.53e9 values,
past 2^31) and FlowNetwork's NCDHW ones, with and without the residual, and
at the layouts its general path takes (C % 8 != 0, N * H * W % 8 != 0, a view
not 16-byte aligned), each BN's scale and shift away from the identity, with
its bound (bytes at the HBM rate), its twin's time and ATen's multiply, add,
residual add and ReLU as the comparison.  Then it drives two paths:

* DFFNet (depth only): the goldens, the forward against the same model on
  the CPU, and serving synthetic 10 x 384 x 384 stacks through
  ``TimedForward`` at batch 1 and 4 in fp32 and bf16;
* the end-to-end network (FlowNetwork alignment + DFFNet): the goldens, the
  forward against the CPU at 10 x 192 x 320, bf16 against fp32, and serving
  synthetic 10 x 608 x 1088 stacks (the real-scene shape) at batch 1 in fp32
  and bf16;
* DDFFNet: served through ``TimedForward`` at DDFF-12's 10 x 384 x 576, batch
  1, in fp32 and bf16, every count at 0 just before each: none of the five
  kernels, ``bn_act`` once for each of its 25 eval BNs in bf16 and not at all
  in fp32; finite outputs, and bf16's rms gap to fp32.

Then it trains (``dffx_torch.train``): one step of DFFNet and of the
end-to-end network on the card against the same step on the CPU, remat
against plain on the card, bf16 against fp32, then 2 warm-up and 5 timed steps
at the recipes' size (batch 4 of 10 x 224 x 224 stacks) for DFFNet in fp32
and bf16, plain and remat, and the end-to-end network in fp32 and bf16, with
no kernel launch in any train step; the trained weights in eval mode against
the CPU, and a train-state checkpoint round trip.

Then the port's host library (``host_decode``; ``dffx_torch/data/native.py``
on ``dffx_torch/csrc/host``, built with ``g++`` from the checkout): its
build seconds and units on this machine (a unit whose header is missing is
absent, and ``cv2`` decodes its formats), with ``g++``'s version, the CPU
model and the core count; 720 x 1296 JPEG, PNG (8-bit BGR and gray, 16-bit
gray and BGR, alpha), EXIF-rotated JPEG and, where the TIFF unit is built,
TIFF files, each byte-equal to ``cv2.imread`` (or ``IMREAD_UNCHANGED``) and
read by the route its decode counters must show; the library's decode
against ``cv2.imread`` where it decodes, ``normalize_pad_stack`` against its
numpy version at DDFF-12's and the real scene's stacks, and the real-scenes
reader alone, each ms with the card's name and power limit.

Then it runs the three command lines, each with every launch count at 0
just before it and read just after:

* ``eval_cli``: ``python -m dffx_torch.eval.test --dataset DDFF`` over 120
  DDFF-12-sized stacks (10 x 383 x 552, padded to 384 x 576; the size of
  DDFF-12's test set) at the default
  batch 8 in fp32 and bf16, through ``Loader``, ``device_prefetch`` and
  ``TimedForward``: ``AVG_time``, the wall rate from first batch to last and
  the device's busy share; the predictions against a direct ``Network``
  forward and against ``--batch_size 1``;
* ``real_scenes_cli``: ``python -m dffx_torch.eval.real_scenes`` on one
  scene of ten 720 x 1296 JPEGs (10 x 608 x 1088 after its crop and pad)
  against a direct ``E2ENetwork`` forward, with the host library's decode
  counters at 0 before it: every JPEG read ``native`` where the codec unit
  is built, ``cv2-absent`` where it is not;
* ``train_cli``: ``python -m dffx_torch.train.cli --recipe DDFF`` at batch 4
  (224 x 224 crops), validating 2 full-size stacks, each run in a process of
  its own, without and with ``cudnn.benchmark``; the resume from
  ``models/1.ckpt`` and the validation against the CPU.

Then the simulator and the front door, with every count at 0 just before
each and read just after (neither launches any of the five kernels):

* ``simulate``: ``python -m dffx_torch simulate`` (``dffx_torch.sim``) at its
  defaults (224 x 352, 10 slices, 2,000 planes, ``--seed 0``) over 16
  NYU-v2-shaped scenes (480 x 640 RGB-D from a seed, in the labeled file's
  layout): its ``avg_time`` a scene, each scene's render program on the card
  alone (``profiling.device_loop_time``), the device's busy share over a
  profiled run; the first two scenes against ``--device cpu`` (uint8 within 1
  at more than 99.9 % of the pixels, median 0; depth and defocus to rtol 1e-4
  / atol 1e-3); TF32 off after the command line, and the library's render the
  same bits whatever the flag; then ``SimulatedScenesDataset`` in train and
  val mode and 2 steps of the ``Simulated`` recipe (E2E) on the written
  scenes, and one validation forward;
* ``front_door``: ``python -m dffx_torch doctor`` (which must name the card
  and its power limit), ``--version`` and ``<command> --help`` for the five
  commands, each in a process of its own: all exit 0.

Then several processes, one rank each (``dffx_torch.parallel``; two ranks
share the one card over gloo, which stages every payload through the host),
each path with every count at 0 just before it and read just after:

* ``dp_train``: DFFNet's train step on two ranks, batch 4 (2 a rank) of 10 x
  224 x 224, 3 steps with ``bn_mode="sync"`` and 3 with ``"per_shard"``: the
  same losses, parameters, buffers and Adam moments on both ranks bit for
  bit, ``sync``'s first step against one process on the global batch at the
  train phases' bounds, each step's ms and the bytes each collective moved;
  then two steps at world size 1 over NCCL, the first against the same;
* ``dp_train_cli``: ``python -m dffx_torch.train.cli --recipe DDFF`` as two
  ranks with ``--coordinator 127.0.0.1:<port> --num_processes 2
  --process_id r --bn_mode per_shard``, two steps: only rank 0 writes
  ``models/*.ckpt`` and validates;
* ``spatial``: ``TimedForward(spatial=2)`` (``--spatial 2``) on two ranks,
  each against the same model whole on its rank (fp32 within 1e-4; bf16 by
  the serving phases' bound: finite, pred3 in the focus range), DFFNet at
  10 x 384 x 576 (DDFF-12's padded shape) in fp32 and bf16, every DFFNet kernel once a
  forward a rank on 224 rows (192 and 16 halo rows on each side); E2E at the
  same shape (the full- and half-resolution chains split, the
  quarter-resolution ``rb_of_chain``'s 96 rows run whole) and at 10 x 608 x
  1088 (608 does not split in 64-row steps: every chain whole); DFFNet with
  ``--spatial-xla``: no launch.  Per rank the forward ms of both, and the
  halo, all-gather and host-staged bytes a forward.

Then the headline benchmark (``headline``): ``python3 -m dffx_torch.headline
--budget HEADLINE_BUDGET`` in a process of its own (``dffx_torch/headline.py``,
the port's counterpart of the root ``bench.py``): DFFNet's bf16 forward at 10
x 384 x 384 at b1, b4 and b128 (both graphs at b4 and b128), a kernel gate,
train steps at b128 with remat and at b32 (10 x 224 x 224, bf16), the
end-to-end forward at 10 x 608 x 1088 and the simulator.  It must exit 0 with
every stdout line JSON, the last a complete record of every point and
section with the gate passed and no error; each point's launch counts (its
stderr lines, counts at 0 just before each point) must be exactly its
forwards times a forward's, and none in the train steps and the simulator.

The bf16 forwards are held to the fp32 ones on the card: in
``forward_vs_cpu`` and ``e2e_forward_vs_cpu`` each output's largest gap,
over the fp32 output's largest value, within its bound (``BF16_RTOL``).

The card's installation lacks ``h5py`` and ``imageio``: those phases put
stand-ins in their place (``HOST_GAPS``, printed as ``host_gaps``).  The
command lines return nothing: what they compute is read through the hooks of
``tests/torch_fixtures.py`` (``run_cli``, ``recording_train``,
``recording_forwards``).

Both eval paths run the default graph (``dffx_torch.models.packed.PACKED_DEFAULT``:
DFFNet's EFDs and full-resolution stage packed space-to-depth, or not).  The
packed graph is held against the unpacked one on the card
(``packed_vs_plain``), goes through the goldens whatever the default, and the
graph that is not the default is served for fewer requests, so that both rates
stand in the output.  The kernels a forward launches are the same either way.

Each path's serving run starts with every launch count at 0 and checks the
counts just after it.  Every phase prints one JSON line and raises on
failure.  The second-to-last line lists each kernel with its launches in the
end-to-end serving run (as ``train_launches``, in all train steps: 0, as
``cli_launches``, in each command line's run, as ``spatial_launches``,
in each ``spatial`` case on rank 0, and as ``headline_launches``, over the
headline's serving and end-to-end points),
its error against its twin, both times and the bound at the end-to-end path's
shapes in fp32 and, under ``bf16``, in bf16 (rb_of_chain: the sum over its
three pyramid levels, and each fp32 level under ``levels``), and for
``fm_conv_bn_relu`` the time of the one PyTorch call that computes its function (``torch.cudnn_convolution_relu`` on the BN-folded
weight and shift; fp32, and bf16 under ``library``); the line before it gives the build's
and the whole run's seconds; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository around it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, H, W = 10, 384, 384  # the DFFNet bench shape: DDFF-12-sized 10-slice stacks
EH, EW = 608, 1088  # the end-to-end real-scene shape (bench.py's E2E stacks)
DW = 576  # DDFF-12's padded width: DDFFNet's serving shape is N x H x DW
MH, MW = 192, 320  # end-to-end GPU-vs-CPU shape: a CPU forward stays seconds
FP32_ATOL = 1e-4
GOLDEN_ATOL = 2e-4
WARPED_SUM_ATOL = 2e-3  # e2e_warped_sum: sums over 64 x 96 pixels, values up to about 107
REPS = 25  # timed launches per kernel and per twin (median reported)
#: training: the crop of DDFFTrainval and SimulatedScenesDataset at the recipes' batch
TB, TN, TH, TW = 4, 10, 224, 224
TRAIN_LR = 1e-3
#: a train step's gradients against another device's or graph's (tests/test_torch_train.py):
#: each tensor max|dg| <= GRAD_RTOL max|g| + GRAD_ATOL, all of them a relative L2 gap
GRAD_RTOL, GRAD_ATOL, GRAD_L2 = 0.25, 1e-7, 0.05
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6  # new running statistics
#: bf16 step against the fp32 step, same weights and batch: the loss, and the
#: cosine of the whole gradient vectors.  On an H100 the bf16 gradient lies
#: 64-98 % away from fp32's in L2 while the loss agrees within 0.5 % (PERF.md
#: §6; why is an open question there): the bound asks for the direction only
BF16_LOSS_RTOL, BF16_GRAD_COS = 0.02, 0.25
#: a bf16 forward against the fp32 forward on the card, same weights and
#: input: each output's largest |gap| over the fp32 output's largest |value|,
#: in ``forward_vs_cpu`` (1 x 10 x 384 x 384) and ``e2e_forward_vs_cpu`` (1 x
#: 10 x 192 x 320).  On an H100 the larger of the two gaps was mid 0.072,
#: pred1 0.057, pred2 0.028, pred3 0.025, warped 0.0086, motion 0.0025: each
#: bound is about twice that (PERF.md §2).  The random-weight network
#: amplifies the rounding of its bf16 activations up to the coarse heads.
BF16_RTOL = {"mid": 0.15, "pred1": 0.12, "pred2": 0.06, "pred3": 0.05, "warped": 0.02,
             "motion": 0.005}
#: the CUDA kernels: each one's source and the TPU kernel it replaces
#: (dffx/ops/pallas_kernels.py pallas_call sites), None for ``bn_act``, the
#: 16-bit eval BN's pass: XLA fuses the JAX package's eval BN into the conv
KERNELS = {
    "fm_conv_bn_relu": ("dffx_torch/csrc/fm_conv.cu", "dffx/ops/pallas_kernels.py:144"),
    "rb2d_residual": ("dffx_torch/csrc/rb2d.cu", "dffx/ops/pallas_kernels.py:329"),
    "srd_attention_residual": ("dffx_torch/csrc/srd_attention.cu",
                               "dffx/ops/pallas_kernels.py:823"),
    "rb_of_chain": ("dffx_torch/csrc/rb_of.cu", "dffx/ops/pallas_kernels.py:726"),
    "motion_head_conv_chain": ("dffx_torch/csrc/motion_head.cu",
                               "dffx/ops/pallas_kernels.py:508"),
    "bn_act": ("dffx_torch/csrc/bn_act.cu", None),
}
#: the five that replace a TPU kernel, in fp32 and bf16 against their twins
PORTED = tuple(name for name, (_, tpu) in KERNELS.items() if tpu)
#: Published peaks of one H100 SXM at its full power limit (NVIDIA's data sheet):
#: HBM bytes/s and dense TF32 and bf16 FLOP/s.  In fp32 the kernels' functions
#: are fp32 convs; on the tensor cores an fp32-accurate product costs three TF32
#: products (3xTF32: hi.hi + hi.lo + lo.hi of the operands' two TF32 parts).  In
#: bf16 the functions multiply bf16 by bf16 (the TPU kernels cast their weights
#: to the activation's dtype, dffx/ops/pallas_kernels.py:166, :272-274, and the
#: twins in dffx_torch/ops/kernels.py every intermediate too): one bf16 product
#: a multiply-accumulate.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def _conv_flop(w) -> int:
    """FLOP per output pixel of a conv with weight (Cout, Cin, kd, kh, kw)."""
    return 2 * w.numel()


#: per kernel, from its arguments: (FLOP per pixel of the convs that read the
#: input x, FLOP per pixel of the convs that read an intermediate, channels
#: read + written per pixel)
WORK = {
    "fm_conv_bn_relu": lambda x, w, *_: (_conv_flop(w), 0, 3 + 8),
    "rb2d_residual": lambda x, w1, a1, w2, a2: (_conv_flop(w1), _conv_flop(w2), 2 * x.shape[1]),
    "srd_attention_residual": lambda x, wn, w1: (_conv_flop(wn), _conv_flop(w1),
                                                 2 * x.shape[1]),
    "rb_of_chain": lambda x, blocks: (
        _conv_flop(blocks[0][0]) + _conv_flop(blocks[0][4]),
        sum(_conv_flop(w2) for _, _, w2, _, _ in blocks)
        + sum(_conv_flop(w1) + _conv_flop(ws) for w1, _, _, _, ws in blocks[1:]),
        x.shape[1] + blocks[-1][0].shape[0]),
    "motion_head_conv_chain": lambda x, w0, a0, w1, a1, w2, a2, w3, b3: (
        _conv_flop(w0), sum(_conv_flop(w) for w in (w1, w2, w3)), x.shape[1] + 3),
}


def bound_ms(name: str, x, *args) -> tuple:
    """The least time the card could take for this call, and what sets it: the
    larger of its bytes (every input and output element moved once, in x's
    dtype) over the HBM rate and its operations over the tensor cores' rate:
    in fp32 three TF32 products a multiply-accumulate at the TF32 rate, in
    bf16 one at the bf16 rate.  Of the five functions only ``fm_conv_bn_relu``'s
    is one PyTorch call (``torch.cudnn_convolution_relu`` on the BN-folded
    weight and shift, timed by ``fm_conv_library``); the other four are fused
    chains of convs, BN and ReLU that no single call computes, so their
    library time is null."""
    import torch

    flop_in, flop_mid, chans_px = WORK[name](x, *args)
    pixels = x.numel() // x.shape[1]
    by_bytes = pixels * chans_px * x.element_size() / HBM_BYTES_PER_S * 1e3
    if x.dtype == torch.bfloat16:
        by_ops = pixels * (flop_in + flop_mid) / BF16_FLOP_PER_S * 1e3
    else:
        by_ops = pixels * 3 * (flop_in + flop_mid) / TF32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


#: the function that packs a kernel's weights into the one buffer it reads, for
#: the kernels whose modules keep that buffer between forwards (tk.ParamCache)
PACKERS = {"fm_conv_bn_relu": "fm_conv_params", "rb2d_residual": "rb2d_params",
           "rb_of_chain": "rb_of_chain_params", "motion_head_conv_chain": "motion_head_params",
           "srd_attention_residual": "srd_attention_params"}

#: launches of each of the five kernels in one forward of each network
DFFNET_LAUNCHES = {"fm_conv_bn_relu": 1, "rb2d_residual": 1, "srd_attention_residual": 1}
FLOWNET_LAUNCHES = {"rb_of_chain": 3, "motion_head_conv_chain": 1}
E2E_LAUNCHES = {**DFFNET_LAUNCHES, **FLOWNET_LAUNCHES}
#: ``bn_act`` launches in one bf16 eval forward: every eval BN outside the five
#: kernels (DFFNet 55 in either graph, FlowNetwork's stock layers 10, DDFFNet
#: 25; tests/test_torch_bn_act.py counts them on the CPU); none in fp32 or training
BN_PASSES = {"dffnet": 55, "flownet": 10, "e2e": 65, "ddffnet": 25}
NET_LAUNCHES = {"dffnet": DFFNET_LAUNCHES, "flownet": FLOWNET_LAUNCHES, "e2e": E2E_LAUNCHES,
                "ddffnet": {}}


def want_launches(net: str, dtype, forwards: int = 1) -> dict:
    """Launches of each kernel in ``forwards`` eval forwards of ``net``
    ("dffnet", "flownet", "e2e", "ddffnet") in ``dtype`` (a torch dtype or its name)."""
    bf16 = str(dtype).split(".")[-1] in ("bfloat16", "bf16")
    return {**{k: v * forwards for k, v in NET_LAUNCHES[net].items()},
            "bn_act": BN_PASSES[net] * forwards if bf16 else 0}


def add_launches(*wants: dict) -> dict:
    """The sum of launch counts, kernel by kernel."""
    return {k: sum(w.get(k, 0) for w in wants) for k in KERNELS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, reps: int = REPS) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(rng, torch, tk, dev):
    """(kernel name, shape tag, args); tags "e2e*" are the end-to-end path's shapes."""
    def bn(c):
        g = torch.from_numpy(rng.standard_normal(c).astype("float32"))
        b = torch.from_numpy(rng.standard_normal(c).astype("float32"))
        mu = torch.from_numpy((rng.standard_normal(c) * 0.1).astype("float32"))
        va = torch.from_numpy((rng.random(c) + 0.5).astype("float32"))
        return tuple(t.to(dev) for t in tk.bn_fused_affine(g, b, mu, va))

    def act(shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype("float32")).to(dev)

    def wt(shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype("float32")).to(dev)

    path, b4, ddff, ragged = (1, N, H, W), (4, N, H, W), (1, N, 384, 576), (2, 3, 40, 72)
    e2e = (1, N, EH, EW)
    # the persistent grids: many tiles per block, H and W no multiple of the
    # tile or of 4, less than one tile, more slices than a grid dimension holds
    many, odd, tiny, slices = (2, N, EH, EW), (1, 3, 45, 101), (1, 2, 7, 5), (1, 65537, 2, 3)
    for tag, (b, n, h, w) in [("path", path), ("b4", b4), ("ddff", ddff), ("ragged", ragged),
                              ("e2e", e2e), ("many", many), ("odd", odd), ("tiny", tiny),
                              ("slices", slices)]:
        yield "fm_conv_bn_relu", tag, (act((b, 3, n, h, w)), wt((8, 3, 1, 9, 9)), *bn(8))
    rb_shapes = [("path", path, 8), ("b4", b4, 8), ("ddff", ddff, 8), ("ragged", ragged, 8),
                 ("ragged", ragged, 16), ("ragged", ragged, 32), ("e2e", e2e, 8)]
    grid_shapes = [("many", many, 8), ("odd", odd, 8), ("tiny", tiny, 8), ("slices", slices, 8)]
    for tag, (b, n, h, w), c in rb_shapes + grid_shapes:
        yield "rb2d_residual", f"{tag}_c{c}", (
            act((b, c, n, h, w)), wt((c, c, 1, 3, 3)), bn(c), wt((c, c, 1, 3, 3)), bn(c))
    # the attention's grid splits the focus axis into runs and flattens B into
    # the block index: 65,537 slices and 65,537 stacks both launch
    srd_shapes = rb_shapes + [("n1", (1, 1, H, W), 8), ("slices", slices, 8),
                              ("batches", (65537, 1, 2, 3), 8)]
    for tag, (b, n, h, w), c in srd_shapes:
        yield "srd_attention_residual", f"{tag}_c{c}", (
            act((b, c, n, h, w)), wt((c, c, 3, 1, 1)), wt((c, c, 1, 1, 1)))
    # FlowNetwork's three pyramid chains at their resolutions, then ragged
    chains = [("e2e_fe1", (1, N, EH, EW), ((3, 8), (8, 8))),
              ("e2e_fe2", (1, N, EH // 2, EW // 2), ((16, 16),)),
              ("e2e_fe3", (1, N, EH // 4, EW // 4), ((32, 32),))]
    chains += [(f"ragged_c{ch[-1][1]}", ragged, ch) for _, _, ch in chains]
    chains += [(f"{tag}_fe1", shape, chains[0][2])
               for tag, shape in (("many", many), ("odd", odd), ("tiny", tiny), ("slices", slices))]
    chains += [(f"{tag}_c{ch[-1][1]}", shape, ch) for _, _, ch in chains[1:3]
               for tag, shape in (("odd", odd), ("slices", slices))]
    for tag, (b, n, h, w), ch in chains:
        yield "rb_of_chain", tag, (act((b, ch[0][0], n, h, w)), [
            (wt((co, ci, 1, 3, 3)), bn(co), wt((co, co, 1, 3, 3)), bn(co), wt((co, ci, 1, 1, 1)))
            for ci, co in ch])
    for tag, (b, n, h, w) in [("e2e", e2e), ("many", many), ("ragged", ragged), ("odd", odd),
                              ("tiny", tiny)]:
        yield "motion_head_conv_chain", tag, (
            act((b, 18, n, h, w)), wt((16, 18, 1, 3, 3)), bn(16), wt((16, 16, 1, 3, 3)), bn(16),
            wt((16, 16, 1, 3, 3)), bn(16), wt((3, 16, 1, 3, 3)), wt((3,)))


def phase_kernels(torch, tk, dev) -> dict:
    """Each kernel against its twin, fp32 and bf16; returns, per kernel, its
    rows at the end-to-end path's shapes, by dtype ("float32", "bfloat16").
    The compared call packs the weights itself; the timed calls get them
    packed from a ``ParamCache``, as the modules call the wrappers."""
    import numpy as np

    from dffx_torch.headline import gate_bound

    rng = np.random.default_rng(0)
    path = {name: {"float32": [], "bfloat16": []} for name in PORTED}
    for name, tag, args in kernel_cases(rng, torch, tk, dev):
        kernel, twin = getattr(tk, name), getattr(tk, f"{name}_ref")
        for dtype in (torch.float32, torch.bfloat16):
            x = args[0].to(dtype)
            kargs = (x, *args[1:])
            got = kernel(*kargs)
            torch.cuda.synchronize()
            ref = twin(x.float(), *args[1:])  # fp32 twin on the same rounded inputs
            err = (got.float() - ref).abs().max().item()
            # the kernel keeps every sum and intermediate in fp32 (the
            # attention's bf16 products split each fp32 weight and its fp32
            # intermediate into bf16 hi + lo, so they are fp32-accurate too)
            # and rounds only its output to bf16
            bound = gate_bound(dtype, ref.abs().max().item())
            if name in PACKERS:
                cache = tk.ParamCache(getattr(tk, PACKERS[name]))
                kept = kernel(*kargs, params=cache(*kargs))
                check(torch.equal(kept, got), f"{name} {tag} {dtype}: kept params differ")
                ms = median_ms(lambda: kernel(*kargs, params=cache(*kargs)))
            else:
                ms = median_ms(lambda: kernel(*kargs))
            plain_ms = median_ms(lambda: twin(*kargs))
            least_ms, bound_by = bound_ms(name, *kargs)
            row = {"phase": "kernel", "kernel": name, "shape": tag, "in": list(x.shape),
                   "dtype": str(dtype).split(".")[1], "max_abs_err": err, "bound": bound,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": least_ms, "bound_by": bound_by,
                   "ms_over_bound": ms / least_ms}
            emit(row)
            check(err <= bound, f"{name} {tag} {dtype}: error {err} > {bound}")
            if tag.startswith("e2e"):
                path[name][row["dtype"]].append(row)
    return path


#: ``bn_act`` rows: (tag, shape, layout, residual, dtype).  The three b32
#: serving cells' NDHWC activations at 10 x 384 x 576 (``BN_ACT_CELLS``:
#: DFFNet's 16ch @ 1/2 with the residual, its packed full resolution as 32ch
#: @ 1/2; DFV's 3-D decoder's 32ch @ 1/4 with the residual, its 16ch @ 1/2;
#: DDFFNet's 64ch at full resolution, 4.53e9 values, past 2^31, its 256ch @
#: 1/4 and 512ch @ 1/16, none with a residual),
#: FlowNetwork's NCDHW ones at 608 x 1088 (16ch @ 1/2 with the residual, 8ch
#: at full resolution), then the general path's: NDHWC with C % 8 != 0, NCDHW
#: with N * H * W % 8 != 0 (FlowNetwork at another image size), a view 2 bytes
#: off 16-byte alignment; and fp16
BN_ACT_CASES = (("dffnet_half_z", (32, 16, 10, 192, 288), "ndhwc", True, "bfloat16"),
                ("dffnet_packed", (32, 32, 10, 192, 288), "ndhwc", False, "bfloat16"),
                ("dfv_quarter_z", (32, 32, 10, 96, 144), "ndhwc", True, "bfloat16"),
                ("dfv_half", (32, 16, 10, 192, 288), "ndhwc", False, "bfloat16"),
                ("ddffnet_full", (32, 64, 10, 384, 576), "ndhwc", False, "bfloat16"),
                ("ddffnet_quarter", (32, 256, 10, 96, 144), "ndhwc", False, "bfloat16"),
                ("ddffnet_sixteenth", (32, 512, 10, 24, 36), "ndhwc", False, "bfloat16"),
                ("flownet_half_z", (1, 16, 10, 304, 544), "ncdhw", True, "bfloat16"),
                ("flownet_full", (1, 8, 10, 608, 1088), "ncdhw", False, "bfloat16"),
                ("ndhwc_c12_z", (2, 12, 10, 96, 144), "ndhwc", True, "bfloat16"),
                ("ncdhw_odd_z", (1, 16, 10, 150, 271), "ncdhw", True, "bfloat16"),
                ("misaligned_z", (1, 16, 10, 152, 272), "ncdhw", True, "bfloat16"),
                ("fp16_half_z", (32, 16, 10, 192, 288), "ndhwc", True, "float16"))
BN_ACT_CELLS = ("dffnet_half_z", "dffnet_packed", "dfv_quarter_z", "dfv_half", "ddffnet_full",
                "ddffnet_quarter", "ddffnet_sixteenth")


def bn_act_rows(torch, tk, dev) -> dict:
    """``bn_act`` against its twin on the card per BN_ACT_CASES, ReLU on: x
    and z uniform in [-2, 2), scale and shift a BN folded away from the
    identity (``kernel_cases``' draw), rounded to the activation dtype.  Each
    row must equal the twin bit for bit (the same fp32 arithmetic, one
    rounding) and count one launch; it gives its time, its twin's, ATen's
    multiply, add, residual add and ReLU on the same operands (the path before
    the pass, ``aten_ms``) and its bound: the bytes read and written at the
    HBM rate.  The twin is compared, then dropped before the timings, and the
    largest gap is read only where they differ, so that DDFFNet's 9 GB rows
    fit the card.  Returns the rows at BN_ACT_CELLS under "bfloat16", as
    ``phase_kernels`` does for the five."""
    import numpy as np

    rng = np.random.default_rng(5)
    gen = torch.Generator(dev).manual_seed(5)
    cells = []
    for tag, shape, layout, residual, dtype_name in BN_ACT_CASES:
        dtype = getattr(torch, dtype_name)
        fmt = torch.channels_last_3d if layout == "ndhwc" else torch.contiguous_format

        def draw():
            u = torch.rand(shape, generator=gen, device=dev).mul_(4).sub_(2)
            return u.to(dtype).contiguous(memory_format=fmt)

        x, z = draw(), (draw() if residual else None)
        if tag.startswith("misaligned"):  # x contiguous: the same values 2 bytes on
            flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            flat[1:] = x.flatten()
            x = flat[1:].view(shape)
        g, b, mu, va = (torch.from_numpy(a.astype("float32")) for a in (
            rng.standard_normal(shape[1]), rng.standard_normal(shape[1]),
            rng.standard_normal(shape[1]) * 0.1, rng.random(shape[1]) + 0.5))
        scale, shift = (t.to(dev, dtype) for t in tk.bn_fused_affine(g, b, mu, va))
        check(tk.bn_act_layout(x, z) == layout, f"bn_act {tag}: read as {layout}?")
        before = tk.launches["bn_act"]
        got = tk.bn_act(x, scale, shift, z, True)
        torch.cuda.synchronize()
        check(tk.launches["bn_act"] == before + 1, f"bn_act {tag}: launches")
        ref = tk.bn_act_ref(x, scale, shift, z, True)
        equal = torch.equal(got, ref)
        err = 0.0 if equal else (got.float() - ref.float()).abs().max().item()
        del ref
        view = (1, -1, 1, 1, 1)

        def aten():
            y = x * scale.view(view) + shift.view(view)
            return torch.relu(y if z is None else y + z)

        ms = median_ms(lambda: tk.bn_act(x, scale, shift, z, True))
        least_ms = x.nbytes * (3 if residual else 2) / HBM_BYTES_PER_S * 1e3
        row = {"phase": "kernel", "kernel": "bn_act", "shape": tag, "in": list(shape),
               "layout": layout, "residual": residual, "dtype": dtype_name,
               "equal_to_twin": equal, "max_abs_err": err, "ms": ms,
               "plain_ms": median_ms(lambda: tk.bn_act_ref(x, scale, shift, z, True)),
               "aten_ms": median_ms(aten), "bound_ms": least_ms, "bound_by": "bytes",
               "ms_over_bound": ms / least_ms}
        emit(row)
        check(row["equal_to_twin"], f"bn_act {tag}: not its twin ({row['max_abs_err']})")
        if tag in BN_ACT_CELLS:
            cells.append(row)
        del x, z, got
        torch.cuda.empty_cache()
    return {"float32": [], "bfloat16": cells}


def fm_conv_library(torch, tk, dev) -> dict:
    """``torch.cudnn_convolution_relu`` on the BN-folded weight and shift: the
    one PyTorch call that computes ``fm_conv_bn_relu``'s function, at the
    end-to-end shape against the fp32 twin, in fp32 (``library_ms``) and in
    bf16 (``bf16``: its time, or the error the call gives)."""
    import numpy as np

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, N, EH, EW)).astype("float32")).to(dev)
    w = torch.from_numpy((rng.standard_normal((8, 3, 1, 9, 9)) * 0.1).astype("float32")).to(dev)
    g, b, mu, va = (torch.from_numpy(a.astype("float32")).to(dev) for a in (
        rng.standard_normal(8), rng.standard_normal(8), rng.standard_normal(8) * 0.1,
        rng.random(8) + 0.5))
    scale, shift = tk.bn_fused_affine(g, b, mu, va)
    w_folded = (w * scale.view(-1, 1, 1, 1, 1)).contiguous()
    out = {"call": "torch.cudnn_convolution_relu"}
    for dtype in (torch.float32, torch.bfloat16):
        xd, wd, sd = x.to(dtype), w_folded.to(dtype), shift.to(dtype)

        def call():
            return torch.cudnn_convolution_relu(xd, wd, sd, (1, 1, 1), (0, 8, 8), (1, 2, 2), 1)

        try:
            got = call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            row = {"error": str(e).splitlines()[0], "library_ms": None}
        else:
            ref = tk.fm_conv_bn_relu_ref(xd.float(), w, scale, shift)
            row = {"max_abs_err": (got.float() - ref).abs().max().item(),
                   "library_ms": median_ms(call)}
        if dtype == torch.float32:
            out.update(row)
        else:
            out["bf16"] = row
    return out


def kernel_entry(name: str, rows: dict, launches: int, train_launches: int,
                 cli_launches: dict, library: dict | None = None,
                 spatial_launches: dict | None = None,
                 headline_launches: int | None = None) -> dict:
    """One kernel of the result line: its fp32 rows at the end-to-end path's
    shapes summed (``rows``: those rows by dtype); a kernel with several
    (rb_of_chain's three pyramid levels) also lists each under ``levels``;
    ``bf16``: its bf16 rows there, summed the same way (``bn_act``: no fp32
    rows, and its bf16 rows at the three b32 serving cells' shapes, with ATen's
    time as ``aten_ms``).  ``launches``: in the
    end-to-end serving run; ``train_launches``: in every train step (one process and data
    parallel); ``cli_launches``: in each command line's measured run
    (``train_cli`` and ``dp_train_cli``: their validation forwards);
    ``spatial_launches``: on rank 0 of each ``spatial`` case's timed run;
    ``headline_launches``: over the headline benchmark's serving and
    end-to-end points.
    ``bound_by``: what sets the largest row's bound.  ``library_ms``:
    ``library``'s fp32 time where one PyTorch call computes the function
    (``fm_conv_library``; its bf16 time under ``library``), else null (see
    ``bound_ms``)."""
    bf16, rows = rows["bfloat16"], rows["float32"]
    entry = {"name": name, "route": "cuda", "source": KERNELS[name][0],
             "replaces": KERNELS[name][1], "launches": launches,
             "train_launches": train_launches, "cli_launches": cli_launches,
             "spatial_launches": spatial_launches, "headline_launches": headline_launches,
             "library_ms": None if library is None else library["library_ms"]}
    if rows:  # bn_act has no fp32
        entry.update({"max_abs_err": max(r["max_abs_err"] for r in rows),
                      "ms": sum(r["ms"] for r in rows),
                      "plain_ms": sum(r["plain_ms"] for r in rows),
                      "bound_ms": sum(r["bound_ms"] for r in rows),
                      "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"]})
        entry["ms_over_bound"] = entry["ms"] / entry["bound_ms"]
    if library is not None:
        entry["library"] = library
    entry["bf16"] = {k: sum(r[k] for r in bf16) for k in ("ms", "plain_ms", "bound_ms")
                     + (("aten_ms",) if "aten_ms" in bf16[0] else ())}
    entry["bf16"]["max_abs_err"] = max(r["max_abs_err"] for r in bf16)
    entry["bf16"]["ms_over_bound"] = entry["bf16"]["ms"] / entry["bf16"]["bound_ms"]
    if len(rows) > 1:
        entry["levels"] = {r["shape"].removeprefix("e2e_"): {
            k: r[k] for k in ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")}
            for r in rows}
    return entry


def check_launches(got: dict, want: dict, what: str) -> None:
    """Exactly ``want`` launches of each kernel, 0 of every other."""
    full = {name: want.get(name, 0) for name in KERNELS}
    check(dict(got) == full, f"{what}: launches {dict(got)} != {full}")


def max_errs(names, got, ref) -> dict:
    return {n: float((g.float().cpu() - r.float().cpu()).abs().max())
            for n, g, r in zip(names, got, ref)}


def bf16_gaps(names, bf16, fp32) -> dict:
    """Each output's largest |bf16 - fp32| over fp32's largest |value|."""
    return {n: float((b.float() - f.float()).abs().max() / f.float().abs().max())
            for n, b, f in zip(names, bf16, fp32)}


def check_bf16_gaps(phase: str, gaps: dict, rtol: dict) -> None:
    """Each output's gap (``bf16_gaps``) within its bound."""
    over = {n: (g, rtol[n]) for n, g in gaps.items() if not g <= rtol[n]}
    check(not over, f"{phase}: bf16 against fp32 over the bound (gap, bound): {over}")


def check_depth(torch, outs, fd, dtype, shape, phase, stack, launches) -> None:
    """Finite depth heads of the expected shape, pred3 within the focus range
    (the headline's serving check, ``heads_ok``)."""
    from dffx_torch.headline import heads_ok

    p3 = outs[3].float()
    finite, in_range = heads_ok(outs, fd, dtype)
    emit({"phase": phase, "dtype": str(dtype).split(".")[1], "shape": stack,
          "launches": launches, "finite": finite, "pred3_in_fd_range": in_range,
          "pred3_min": float(p3.min()), "pred3_max": float(p3.max())})
    check(finite and in_range, f"{phase} {dtype}: finite={finite} in_range={in_range}")
    check(all(tuple(t.shape) == shape for t in outs), f"{phase} output shapes")


def packed_vs_plain(torch, tk, net, other, args, names, default_outs, network, shape) -> None:
    """The packed graph against the unpacked one on the card, same weights and
    inputs: fp32 within ``FP32_ATOL`` on every output, bf16 reported.  ``net``
    runs the default graph and ``default_outs`` holds its outputs per dtype
    (on the CPU); ``other`` runs the other graph here, launching what
    ``want_launches(network, dtype)`` says."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tk.reset_launches()
        with torch.inference_mode():
            o = other(args[0].to(dtype), *args[1:])
        torch.cuda.synchronize()
        check_launches(tk.launches, want_launches(network, dtype), f"packed_vs_plain {dtype}")
        errs[dtype] = max_errs(names, o, default_outs[dtype])
    check(net.DFF_net.packed != other.DFF_net.packed, "packed_vs_plain: one graph twice")
    emit({"phase": "packed_vs_plain", "shape": shape, "default_packed": net.DFF_net.packed,
          "fp32_max_abs_err": errs[torch.float32], "atol": FP32_ATOL,
          "bf16_vs_bf16_max_abs_err": errs[torch.bfloat16]})
    check(max(errs[torch.float32].values()) <= FP32_ATOL,
          f"packed against unpacked at {shape}: {errs[torch.float32]}")


def serve(torch, tf, reqs, smi, phase) -> int:
    """Two warm-up requests (cuDNN algorithm choice, allocator), then the timed
    ones; prints the rate and returns the number of forwards."""
    for r in reqs[:2]:
        tf(*r)
    tf.total, tf.count = 0.0, 0
    t0 = time.perf_counter()
    for r in reqs[2:]:
        o = tf(*r)
        check(all(bool(torch.isfinite(t).all()) for t in o), f"{phase} output")
    wall = time.perf_counter() - t0
    emit({"phase": phase, "device": smi, "packed": tf.model.DFF_net.packed,
          "dtype": str(tf.dtype).split(".")[1], "batch": int(reqs[0][0].shape[0]),
          "shape": list(reqs[0][0].shape[1:4]),
          "requests": len(reqs) - 2, "stacks_per_s": 1.0 / tf.avg_time,
          "avg_time_s": tf.avg_time, "wall_stacks_per_s": tf.count / wall})
    return len(reqs)


def train_batch(np, rng, b, n, h, w, e2e: bool, fdt=None) -> dict:
    """A synthetic batch as the train step takes it (numpy): stacks in
    [-1, 1], depth in the focus range, 80 % of the pixels valid; its floats
    in ``fdt`` (default fp32)."""
    fdt = fdt or np.float32
    batch = {"fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32).astype(fdt),
             "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32).astype(fdt),
             "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32).astype(fdt),
                                    (b, 1)),
             "mask": rng.random((b, h, w)) > 0.2}
    if e2e:
        batch["fovs"] = (1.0 + np.linspace(0.0, 0.03, n)
                         + rng.uniform(-0.005, 0.005, (b, n))).astype(np.float32).astype(fdt)
    return batch


def on(torch, batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def new_train_state(torch, seed: int, e2e: bool, dev, dtype=None):
    from dffx_torch.checkpoint import load_jax_params
    from dffx_torch.models import E2ENetwork, Network, e2e_init_params, init_params
    from dffx_torch.train import create_train_state

    net = E2ENetwork() if e2e else Network()
    load_jax_params(net, (e2e_init_params if e2e else init_params)(seed))
    return create_train_state(net.to(device=dev, dtype=dtype), TRAIN_LR)


def grads_of(state) -> dict:
    """Every gradient on the host, in fp32 (float64 where it is)."""
    return {k: p.grad.to(torch_wide(p.grad)).cpu() for k, p in state.model.named_parameters()}


def torch_wide(t):
    """fp32, or float64 for a float64 tensor."""
    import torch

    return torch.promote_types(t.dtype, torch.float32)


def grad_gap(got: dict, want: dict) -> tuple:
    """(worst max|dg| / (GRAD_RTOL max|g| + GRAD_ATOL) over tensors, worst
    max|dg| / max|g|, relative L2 gap over all of them)."""
    over = worst = num = den = 0.0
    for k, w in want.items():
        d = (got[k] - w).abs().max().item()
        scale = w.abs().max().item()
        over = max(over, d / (GRAD_RTOL * scale + GRAD_ATOL))
        worst = max(worst, d / scale if scale else 0.0)
        num += float(((got[k] - w) ** 2).sum())
        den += float((w ** 2).sum())
    return over, worst, (num / den) ** 0.5 if den else 0.0


def grad_cos(got: dict, want: dict) -> float:
    """Cosine between two gradients, all tensors as one vector."""
    dot = sum(float((got[k] * w).sum()) for k, w in want.items())
    norms = [sum(float((g[k] ** 2).sum()) for k in want) ** 0.5 for g in (got, want)]
    return dot / (norms[0] * norms[1])


def stats_of(state) -> dict:
    return {k: v.cpu() for k, v in state.model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def stats_gap(got: dict, want: dict) -> tuple:
    """(worst |d| / (STATS_RTOL |want| + STATS_ATOL), counts all equal)."""
    over, counts = 0.0, True
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            counts &= int(got[k]) == int(w)
        else:
            lim = STATS_RTOL * w.abs() + STATS_ATOL
            over = max(over, ((got[k] - w).abs() / lim).max().item())
    return over, counts


def bf16_vs_fp32(hlogs, hgrads, logs, grads, name, shape) -> None:
    h_loss = abs(float(hlogs["loss"]) - float(logs["loss"])) / abs(float(logs["loss"]))
    _, h_worst, h_l2 = grad_gap(hgrads, grads)
    cos = grad_cos(hgrads, grads)
    emit({"phase": "train_bf16_vs_fp32", "model": name, "shape": shape,
          "loss_rel_err": h_loss, "grad_cos": cos, "grad_worst_over_max": h_worst,
          "grad_rel_l2": h_l2, "bound": {"loss_rtol": BF16_LOSS_RTOL, "grad_cos": BF16_GRAD_COS}})
    check(h_loss <= BF16_LOSS_RTOL and cos >= BF16_GRAD_COS, f"train bf16 {name} {shape}")


def phase_train(torch, np, tk, dev, smi) -> int:
    """Training on the card; raises on a failed check.  Returns the kernel
    launches counted over every train step (all 0)."""
    from dffx_torch import checkpoint as ckpt
    from dffx_torch.train import LossConfig, make_train_step

    rng = np.random.default_rng(11)
    train_launches = 0

    def step_on(state, batch, *, e2e, dtype=torch.float32, remat=False):
        nonlocal train_launches
        tk.reset_launches()
        state, logs = make_train_step(TRAIN_LR, LossConfig(), e2e=e2e, compute_dtype=dtype,
                                      remat=remat)(state, batch)
        if next(state.model.parameters()).is_cuda:
            torch.cuda.synchronize()
            train_launches += sum(tk.launches.values())
            check_launches(tk.launches, {}, "train step")
        return state, logs

    # (a) GPU against CPU, (b) remat against plain on the card, bf16 against fp32
    for name, e2e, b in (("dffnet", False, 2), ("e2e", True, 1)):
        batch = train_batch(np, rng, b, TN, 64, 64, e2e)
        gpu, glogs = step_on(new_train_state(torch, 0, e2e, dev), on(torch, batch, dev), e2e=e2e)
        cpu, clogs = step_on(new_train_state(torch, 0, e2e, "cpu"), on(torch, batch, "cpu"),
                             e2e=e2e)
        loss_rel = abs(float(glogs["loss"]) - float(clogs["loss"])) / abs(float(clogs["loss"]))
        g_over, g_worst, g_l2 = grad_gap(grads_of(gpu), grads_of(cpu))
        s_over, counts = stats_gap(stats_of(gpu), stats_of(cpu))
        emit({"phase": "train_vs_cpu", "model": name, "shape": [b, TN, 64, 64],
              "loss_rel_err": loss_rel, "grad_worst_over_max": g_worst, "grad_rel_l2": g_l2,
              "grad_over_bound": g_over, "stats_over_bound": s_over, "counts_equal": counts,
              "bound": {"loss_rtol": 1e-5, "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL,
                        "grad_l2": GRAD_L2, "stats_rtol": STATS_RTOL,
                        "stats_atol": STATS_ATOL}})
        check(loss_rel <= 1e-5 and g_over <= 1 and g_l2 <= GRAD_L2 and s_over <= 1 and counts,
              f"train step {name}: GPU against CPU")

        rem, rlogs = step_on(new_train_state(torch, 0, e2e, dev), on(torch, batch, dev),
                             e2e=e2e, remat=True)
        r_over, r_worst, r_l2 = grad_gap(grads_of(rem), grads_of(gpu))
        # cuDNN's deconvs (data-gradient kernels) need not give the same bits twice
        rs_over, r_counts = stats_gap(stats_of(rem), stats_of(gpu))
        same_stats = all(torch.equal(a, stats_of(gpu)[k]) for k, a in stats_of(rem).items())
        tracked = {int(v) for k, v in stats_of(rem).items() if k.endswith("num_batches_tracked")
                   and ".pre_conv." not in k and ".redir3." not in k}
        emit({"phase": "train_remat_vs_plain", "model": name, "shape": [b, TN, 64, 64],
              "loss_plain": float(glogs["loss"]), "loss_remat": float(rlogs["loss"]),
              "grad_worst_over_max": r_worst, "grad_rel_l2": r_l2, "grad_over_bound": r_over,
              "stats_over_bound": rs_over, "stats_bit_identical": same_stats,
              "num_batches_tracked": sorted(tracked)})
        check(r_over <= 1 and r_l2 <= GRAD_L2 and rs_over <= 1 and r_counts and tracked == {1},
              f"train step {name}: remat against plain")

        half, hlogs = step_on(new_train_state(torch, 0, e2e, dev), on(torch, batch, dev),
                              e2e=e2e, dtype=torch.bfloat16)
        bf16_vs_fp32(hlogs, grads_of(half), glogs, grads_of(gpu), name, [b, TN, 64, 64])

    # (c) the recipes' size: 2 warm-up and 5 timed steps a configuration
    evals = {}
    for e2e in (False, True):
        batches = [on(torch, train_batch(np, rng, TB, TN, TH, TW, e2e), dev) for _ in range(7)]
        configs = [(torch.float32, False), (torch.bfloat16, False)]
        if not e2e:
            configs += [(torch.float32, True), (torch.bfloat16, True)]
        first = {}  # the first step's loss and gradients, fp32 and bf16 without remat
        for dtype, remat in configs:
            state = new_train_state(torch, 0, e2e, dev)
            probe = on(torch, train_batch(np, rng, 1, TN, TH, TW, e2e), dev)
            args = (probe["fs"], probe["focus_dists"]) + ((probe["fovs"],) if e2e else ())
            if dtype == torch.float32 and not remat:
                with torch.inference_mode():  # fills the kept kernel weights before training
                    state.model.eval()(*args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            times, losses = [], []
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                state, logs = step_on(state, batch, e2e=e2e, dtype=dtype, remat=remat)
                losses.append(float(logs["loss"]))
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
                elif i == 0 and not remat:
                    first[dtype] = (logs, grads_of(state))
            ms = statistics.median(times)
            emit({"phase": "train_steps", "device": smi, "model": "e2e" if e2e else "dffnet",
                  "dtype": str(dtype).split(".")[1], "remat": remat, "batch": TB,
                  "shape": [TN, TH, TW], "ms_per_step": ms, "ms_steps": times,
                  "stacks_per_s": TB * 1e3 / ms,
                  "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "losses": losses})
            check(all(np.isfinite(losses)), f"train steps: loss {losses}")
            if dtype == torch.float32 and not remat:
                evals[e2e] = (state, args, batches[0])
        bf16_vs_fp32(*first[torch.bfloat16], *first[torch.float32], "e2e" if e2e else "dffnet",
                     [TB, TN, TH, TW])

    # (d) the trained weights in eval mode: the card against the CPU
    for e2e, (state, args, _) in evals.items():
        net = state.model.eval()
        cpu = new_train_state(torch, 1, e2e, "cpu").model.eval()
        cpu.load_state_dict(net.state_dict())
        tk.reset_launches()
        with torch.inference_mode():
            got = net(*args)
        torch.cuda.synchronize()
        launches = dict(tk.launches)
        check_launches(launches, E2E_LAUNCHES if e2e else DFFNET_LAUNCHES, "trained eval")
        with torch.inference_mode():
            want = cpu(*(a.cpu() for a in args))
        errs = max_errs(["mid", "pred1", "pred2", "pred3", "warped"], got, want)
        emit({"phase": "trained_eval_vs_cpu", "model": "e2e" if e2e else "dffnet",
              "shape": list(args[0].shape[:4]), "fp32_max_abs_err": errs, "atol": FP32_ATOL,
              "launches": launches})
        check(max(errs.values()) <= FP32_ATOL, f"trained eval forward: {errs}")

    # (e) a train-state checkpoint round trip, then one more step from each: the
    # restored state is bit-equal; the next steps agree as remat and plain do,
    # since cuDNN's backward need not give the same bits twice
    state, _, batch = evals[False]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "8.ckpt")
        ckpt.save(path, state)
        resumed = ckpt.restore(path, new_train_state(torch, 1, False, dev))
    a, b = state.model.state_dict(), resumed.model.state_dict()
    same = all(torch.equal(a[k], b[k]) for k in a) and resumed.step == state.step
    for p, q in zip(state.model.parameters(), resumed.model.parameters()):
        sa, sb = state.optimizer.state[p], resumed.optimizer.state[q]
        same &= all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in ("step", "exp_avg",
                                                                    "exp_avg_sq"))
    state, logs = step_on(state, batch, e2e=False)
    resumed, rlogs = step_on(resumed, batch, e2e=False)
    loss_rel = abs(float(logs["loss"]) - float(rlogs["loss"])) / abs(float(logs["loss"]))
    g_over, _, g_l2 = grad_gap(grads_of(resumed), grads_of(state))
    s_over, counts = stats_gap(stats_of(resumed), stats_of(state))
    gap = max((p - q).abs().max().item()
              for p, q in zip(state.model.parameters(), resumed.model.parameters()))
    emit({"phase": "train_checkpoint", "restored_identical": same, "step": resumed.step,
          "loss_rel_err": loss_rel, "grad_over_bound": g_over, "grad_rel_l2": g_l2,
          "stats_over_bound": s_over, "counts_equal": counts,
          "param_max_abs_gap_after_step": gap})
    check(same and loss_rel <= 1e-6 and g_over <= 1 and g_l2 <= GRAD_L2 and s_over <= 1
          and counts and resumed.step == state.step, "train checkpoint round trip")
    return train_launches


#: what the card's installation lacks of the command lines' host packages
#: (listed on the card: PERF.md §7).  The phases below always put a stand-in
#: module in their place while they run: the readers' and writers' own code
#: runs on it, and only the file format is skipped.
HOST_GAPS = {
    "h5py": "DDFFBenchmark and DDFFTrainval read no h5 file: their files are dicts of "
            "in-memory arrays (the readers' code runs on them)",
    "imageio": "save_jet writes no depth JPEG: jet_colormap's images are kept in memory",
}
#: the eval command line's stacks (DDFF-12's test set) and its default batch
DDFF_STACKS, DDFF_SHAPE, EVAL_BATCH = 120, (10, 383, 552), 8
EVAL_DTYPES = ("fp32", "bf16")
#: the real-scenes command line: one hand-held scene whose 1/12 border crop pads
#: to 10 x 608 x 1088
SCENE_SHAPE = (10, 720, 1296)
#: the train command line's DDFF run: 20 train stacks (5 steps of batch 4) and 2 to validate
TRAIN_STACKS, VAL_STACKS, TRAIN_STEPS = 20, 2, 5


@contextlib.contextmanager
def stand_ins(h5_files: dict, jpegs: list):
    """``h5py`` whose ``File(path)`` is ``h5_files[path]`` (a dict of arrays)
    and ``imageio`` whose ``imwrite`` appends (path, the image's shape) to
    ``jpegs``, in ``sys.modules`` for the block (``HOST_GAPS``)."""
    import types

    h5py = types.ModuleType("h5py")
    h5py.File = lambda path, mode="r": h5_files[str(path)]
    imageio = types.ModuleType("imageio")
    imageio.imwrite = lambda path, image, **kw: jpegs.append((str(path), image.shape))
    saved = {name: sys.modules.get(name) for name in ("h5py", "imageio")}
    sys.modules.update(h5py=h5py, imageio=imageio)
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def printed(out: str, key: str) -> float:
    return float(next(ln.split(":", 1)[1] for ln in out.splitlines() if ln.startswith(key)))


def device_seconds(torch, fn) -> tuple:
    """Run ``fn()`` under ``torch.profiler``; returns the device seconds of
    its kernels and of its copies and sets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels, copies and sets only: a range the program's spans annotate
    # (a user annotation on the device) covers its kernels again
    rows = [(e.key, e.self_device_time_total / 1e6) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    copies = sum(s for k, s in rows if k.startswith(("Memcpy", "Memset")))
    return sum(s for _, s in rows) - copies, copies


def phase_eval_cli(torch, np, tk, dev, smi) -> dict:
    """``python -m dffx_torch.eval.test --dataset DDFF`` at the default batch
    8 in fp32 and bf16: ``Loader`` -> ``device_prefetch`` -> ``TimedForward``
    over the 120 DDFF-12-sized stacks of its test set, against a direct
    ``Network`` forward of the same padded stacks (fp32, 1e-4) and against
    ``--batch_size 1``.  Between forwards the command line either waits for
    the next batch (``loader_wait_s``, the host path) or works on the last
    one (``consumer_s``).  Returns the launches of the measured fp32 b8 run."""
    from dffx_torch.data import DDFFBenchmark, Loader, ddff_focus_dists, device_prefetch
    from dffx_torch.data.native import normalize_pad_stack
    from dffx_torch.eval import jet_colormap, load_params_auto
    from dffx_torch.eval import test as cli
    from torch_fixtures import run_cli

    rng = np.random.default_rng(21)
    stacks = rng.integers(0, 256, (DDFF_STACKS, *DDFF_SHAPE, 3), dtype=np.uint8)
    net = load_params_auto(0, device=dev)  # the command line's --allow-random-init weights
    spans = []  # (start, end) of every forward the command line makes
    waits = []  # seconds the command line waits for each batch

    class Spanned(cli.TimedForward):
        def __call__(self, *args):
            t0 = time.perf_counter()
            outs = super().__call__(*args)  # synchronises
            spans.append((t0, time.perf_counter()))
            return outs

    def waited_prefetch(*args, **kw):
        batches = device_prefetch(*args, **kw)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(batches)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t0)
                yield item
        finally:
            batches.close()

    fd = torch.from_numpy(ddff_focus_dists()[None].repeat(EVAL_BATCH, 0)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        h5 = str(Path(tmp) / "DDFF" / "ddff-dataset-test.h5")
        jpegs, launched, preds = [], {}, {}

        def run(dtype, batch, tag):
            tk.reset_launches()
            spans.clear()
            waits.clear()
            out = run_cli(cli.main, [
                "--dataset", "DDFF", "--data-root", tmp, "--results-root", f"{tmp}/{tag}/",
                "--allow-random-init", "--dtype", dtype, "--batch_size", str(batch)])
            torch.cuda.synchronize()
            forwards = -(-DDFF_STACKS // batch)
            check_launches(tk.launches, want_launches("dffnet", dtype, forwards),
                           f"eval_cli {dtype} b{batch}")
            launched[tag] = dict(tk.launches)
            preds[tag] = np.load(f"{tmp}/{tag}/DDFF/predictions.npy")
            return out

        def loader_rate(path) -> float:
            """Stacks/s of the command line's host path alone: the reader,
            ``Loader`` (4 threads, batch 8) and ``device_prefetch`` to the card,
            from the first batch on the card to the last."""
            loader = Loader(cli.DDFFBenchmark(path), EVAL_BATCH, num_threads=4)
            arrived = []
            for _ in device_prefetch(iter(loader), dev, ("fs", "focus_dists")):
                torch.cuda.synchronize()
                arrived.append(time.perf_counter())
            return EVAL_BATCH * (len(arrived) - 1) / (arrived[-1] - arrived[0])

        def jet_seconds() -> float:
            """Host seconds to colour one batch's depth maps (``jet_colormap``)."""
            maps = np.random.default_rng(0).random((EVAL_BATCH, *DDFF_SHAPE[1:]))
            t0 = time.perf_counter()
            for m in maps:
                jet_colormap(m)
            return time.perf_counter() - t0

        cli_forward = cli.TimedForward
        cli.TimedForward, cli.device_prefetch = Spanned, waited_prefetch
        try:
            with stand_ins({h5: {"stack_test": stacks}}, jpegs):
                for dtype in EVAL_DTYPES:
                    run(dtype, EVAL_BATCH, f"{dtype}_warm")
                    out = run(dtype, EVAL_BATCH, f"{dtype}_b8")
                    wall = spans[-1][1] - spans[0][0]  # first batch to last
                    in_forwards = sum(end - start for start, end in spans)
                    loader_wait = sum(waits[1:])  # the first batch comes before the clock
                    busy, copies = device_seconds(
                        torch, lambda: run(dtype, EVAL_BATCH, f"{dtype}_profiled"))
                    pwall = spans[-1][1] - spans[0][0]
                    run(dtype, 1, f"{dtype}_b1")
                    emit({"phase": "eval_cli", "device": smi, "dtype": dtype,
                          "batch": EVAL_BATCH, "stacks": DDFF_STACKS,
                          "shape": list(DDFF_SHAPE), "predictions": list(preds[f"{dtype}_b8"].shape),
                          "avg_time_s": printed(out, "AVG_time"),
                          "avg_time_stacks_per_s": 1.0 / printed(out, "AVG_time"),
                          "wall_stacks_per_s": DDFF_STACKS / wall,
                          "between_forwards_s": wall - in_forwards,
                          "loader_wait_s": loader_wait,
                          "consumer_s": wall - in_forwards - loader_wait,
                          "loader_alone_stacks_per_s": loader_rate(h5),
                          "jet_one_batch_s": jet_seconds(),
                          "profiled_loop_s": pwall, "device_busy_share": busy / pwall,
                          "copy_share": copies / pwall,
                          "launches": launched[f"{dtype}_b8"],
                          "b1_vs_b8_max_abs_err": float(np.abs(
                              preds[f"{dtype}_b1"] - preds[f"{dtype}_b8"]).max()),
                          "jpegs": len(jpegs)})
        finally:
            cli.TimedForward, cli.device_prefetch = cli_forward, device_prefetch
    # the same padded stacks through Network directly, batch 8, fp32
    direct = []
    with torch.inference_mode():
        for i in range(0, DDFF_STACKS, EVAL_BATCH):
            fs = np.stack([normalize_pad_stack(s) for s in stacks[i:i + EVAL_BATCH]])
            p3 = net(torch.from_numpy(fs).to(dev), fd[:len(fs)])[3]
            # the command line's crop (DDFFBenchmark's 383 x 552)
            direct.append(p3.float().cpu().numpy()[:, :DDFFBenchmark.HEIGHT, :DDFFBenchmark.WIDTH])
    direct = np.concatenate(direct)
    errs = {tag: float(np.abs(preds[tag] - direct).max()) for tag in ("fp32_b8", "fp32_b1")}
    bf16 = {tag: float(np.abs(preds[tag] - direct).max()) for tag in ("bf16_b8", "bf16_b1")
            if tag in preds}
    finite = all(bool(np.isfinite(p).all()) for p in preds.values())
    emit({"phase": "eval_cli_vs_network", "fp32_max_abs_err": errs, "atol": FP32_ATOL,
          "bf16_vs_fp32_max_abs_err": bf16, "finite": finite,
          "jpeg_images": sorted({tuple(shape) for _, shape in jpegs})})
    check(finite and max(errs.values()) <= FP32_ATOL, f"eval_cli predictions: {errs}")
    runs = 4 * len(EVAL_DTYPES)  # warm-up, measured, profiled and batch 1
    check(len(jpegs) == runs * DDFF_STACKS, f"eval_cli wrote {len(jpegs)} depth images")
    return launched["fp32_b8"]


#: the host library's image cases at the real scene's image size: (file, what
#: it holds, read unchanged, a file dffx's decoder hands to cv2)
HOST_IMAGES = (("c8.jpg", "8-bit BGR JPEG", False, False),
               ("c8.png", "8-bit BGR PNG", False, False),
               ("g8.png", "8-bit gray PNG", True, False),
               ("g16.png", "16-bit gray PNG", True, False),
               ("c16.png", "16-bit BGR PNG", True, False),
               ("a8.png", "8-bit BGRA PNG", False, True),
               ("exif6.jpg", "JPEG with EXIF orientation 6", False, True),
               ("c8.tif", "8-bit RGB TIFF", False, False),
               ("g8.tif", "8-bit gray TIFF", False, False))
HOST_REPS = 7  # timed reads or normalisations a case (median reported)
#: normalize_pad_stack's stacks: DDFF-12's and the real scene's after its crop
NORMALIZE_SHAPES = {"ddff": (10, 383, 552, 3), "real_scene": (10, 600, 1080, 3)}


def host_ms(fn, reps: int = HOST_REPS) -> float:
    """Median host milliseconds of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def routes(native) -> dict:
    """The host library's decode counters as ``{"format/route": reads}``."""
    return {f"{fmt}/{route}": n for (fmt, route), n in sorted(native.decodes.items())}


def host_machine() -> dict:
    """The host's CPU model, cores and ``g++``."""
    import os
    import platform

    from dffx_torch.data import _host_build

    model = None
    for cmd in (["lscpu"], ["cat", "/proc/cpuinfo"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout
        except OSError:
            continue
        fields = {ln.split(":", 1)[0].strip().lower(): ln.split(":", 1)[1].strip()
                  for ln in out.splitlines() if ":" in ln}
        if fields.get("model name", "unknown") not in ("", "unknown"):
            model = fields["model name"]
        elif "vendor id" in fields:  # a virtual machine may hide the name
            model = (f"{fields['vendor id']} family {fields.get('cpu family', '?')} "
                     f"model {fields.get('model', '?')}")
        if model:
            break
    gxx = subprocess.run([_host_build.find_cxx(), "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    return {"cpu": model or platform.processor() or "not reported", "nproc": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "gxx": gxx}


def phase_host_decode(np, smi) -> None:
    """The port's host library (``dffx_torch/data/native.py`` on
    ``dffx_torch/csrc/host``): its build and units on this machine; at
    ``SCENE_SHAPE``'s image size each of ``HOST_IMAGES`` (TIFFs where the
    TIFF unit is built) byte-equal to ``cv2.imread`` (or ``IMREAD_UNCHANGED``)
    with the route the counters show, and the library's decode against
    ``cv2.imread`` where it decodes; ``normalize_pad_stack`` against its
    numpy version at ``NORMALIZE_SHAPES`` (bit-equal, ms a stack); the
    real-scenes reader alone on one scene (ms a stack)."""
    import cv2

    from dffx_torch.data import RealScenesDataset, _host_build, native
    from torch_fixtures import exif_oriented

    t0 = time.perf_counter()
    built = native.library().build
    emit({"phase": "host_build", "device": smi, "seconds": time.perf_counter() - t0,
          "compile_seconds": built.seconds, "library": built.path.name, "units": built.units,
          "absent": {u: f"no {', '.join(h)}: cv2 decodes "
                        f"{', '.join(_host_build.UNITS[u].formats)}"
                     for u, h in built.absent.items()},
          "formats": sorted(native.formats()), **host_machine()})
    _, h, w = SCENE_SHAPE
    rng = np.random.default_rng(23)
    base = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 3)
    noisy = np.clip(base.astype(np.int16) + rng.integers(-6, 7, (h, w, 3)), 0, 255)
    images = {"c8": noisy.astype(np.uint8), "g8": cv2.cvtColor(noisy.astype(np.uint8),
                                                               cv2.COLOR_BGR2GRAY)}
    images["g16"] = images["g8"].astype(np.uint16) * 257 + rng.integers(0, 257, (h, w),
                                                                          dtype=np.uint16)
    images["c16"] = images["c8"].astype(np.uint16) * 257
    images["a8"] = np.dstack([images["c8"], images["g8"]])
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, what, unchanged, punt in HOST_IMAGES:
            fmt = {"jpg": "jpeg", "png": "png", "tif": "tiff"}[name.rsplit(".", 1)[1]]
            if fmt == "tiff" and fmt not in native.formats():
                emit({"phase": "host_decode", "device": smi, "file": name, "holds": what,
                      "skipped": f"the tiff unit is not built: {built.absent.get('tiff')}"})
                continue
            path = f"{tmp}/{name}"
            stem = name.split(".")[0]
            if stem == "exif6":
                jpeg = cv2.imencode(".jpg", images["c8"])[1].tobytes()
                Path(path).write_bytes(exif_oriented(jpeg, 6))
            else:
                check(cv2.imwrite(path, images[stem]), f"cv2 wrote no {name}")
            flag = cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR
            read = native.imread_unchanged if unchanged else native.imread
            compat = native.imread_unchanged_compat if unchanged else native.imread_compat
            native.reset_decodes()
            got, want = compat(path, "chip_smoke host_decode"), cv2.imread(path, flag)
            counted = routes(native)
            route = ("cv2-absent" if fmt not in native.formats() else
                     "cv2-punt" if punt else "native")
            equal = got.dtype == want.dtype and got.shape == want.shape and bool(
                np.array_equal(got, want))
            row = {"phase": "host_decode", "device": smi, "file": name, "holds": what,
                   "shape": list(got.shape), "dtype": str(got.dtype),
                   "bytes": Path(path).stat().st_size, "unchanged": unchanged,
                   "equal_to_cv2": equal, "routes": counted, "expected_route": route,
                   "cv2_ms": host_ms(lambda: cv2.imread(path, flag))}
            row["native_ms"] = host_ms(lambda: read(path)) if route == "native" else (
                f"not measured: {route}")
            emit(row)
            if not (equal and counted == {f"{fmt}/{route}": 1}):
                failed.append(name)
        native.reset_decodes()
        for tag, shape in NORMALIZE_SHAPES.items():
            stack = rng.integers(0, 256, shape, dtype=np.uint8)
            same = bool(np.array_equal(native.normalize_pad_stack(stack),
                                       native.normalize_pad_stack_plain(stack)))
            lib_ms = host_ms(lambda: native.normalize_pad_stack(stack))
            plain_ms = host_ms(lambda: native.normalize_pad_stack_plain(stack))
            emit({"phase": "host_normalize", "device": smi, "stack": tag, "in": list(shape),
                  "out": list(native.normalize_pad_stack(stack).shape), "bit_equal": same,
                  "ms": lib_ms, "plain_ms": plain_ms, "speedup": plain_ms / lib_ms,
                  "threads": 4})
            if not same:
                failed.append(f"normalize {tag}")
        write_scene(np, Path(tmp) / "scenes")
        reader = RealScenesDataset(f"{tmp}/scenes")
        fs = list(reader[0]["fs"].shape)
        native.reset_decodes()
        ms = host_ms(lambda: reader[0], reps=3)
        # 4 reads of the stack, each its 10 JPEGs and the first once more
        want = {("jpeg", "native" if "jpeg" in native.formats() else "cv2-absent"): 4 * 11}
        emit({"phase": "host_reader", "device": smi, "reader": "RealScenesDataset",
              "scene": list(SCENE_SHAPE), "fs": fs, "ms_a_stack": ms,
              "stacks_per_s": 1e3 / ms, "routes": routes(native)})
        if native.decodes != want:
            failed.append("RealScenesDataset routes")
    native.reset_decodes()
    check(not failed, f"host_decode: {failed}")


def write_scene(np, root: Path) -> None:
    """One hand-held scene of ``SCENE_SHAPE`` JPEGs (smooth random content with
    per-slice noise), ``focus_distance.txt`` and ``focal_length.txt``."""
    import cv2

    n, h, w = SCENE_SHAPE
    rng = np.random.default_rng(22)
    scene = root / "scene0"
    scene.mkdir(parents=True)
    base = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 6)
    for i in range(n):
        noisy = np.clip(base.astype(np.int16) + rng.integers(-6, 7, (h, w, 3)), 0, 255)
        cv2.imwrite(str(scene / f"{i:02d}.jpg"), noisy.astype(np.uint8))
    (scene / "focus_distance.txt").write_text(
        "\n".join(f"{d:.6f}" for d in np.linspace(0.12, 0.9, n)) + "\n")
    (scene / "focal_length.txt").write_text("0.00444\n")


def phase_real_scenes_cli(torch, np, tk, dev, smi) -> dict:
    """``python -m dffx_torch.eval.real_scenes`` on one scene that pads to
    10 x 608 x 1088, fp32: depth and warped stack against a direct
    ``E2ENetwork`` forward of the reader's sample (1e-4).  Returns the
    launches."""
    from dffx_torch.data import RealScenesDataset, native
    from dffx_torch.eval import load_params_auto
    from dffx_torch.eval import real_scenes as cli
    from torch_fixtures import recording_forwards, run_cli

    with tempfile.TemporaryDirectory() as tmp:
        write_scene(np, Path(tmp) / "scenes")
        jpegs = []
        with stand_ins({}, jpegs), recording_forwards(cli) as kept:
            tk.reset_launches()
            native.reset_decodes()
            out = run_cli(cli.main, ["--data-root", f"{tmp}/scenes", "--out", f"{tmp}/out/",
                                     "--allow-random-init"])
            torch.cuda.synchronize()
            launched = dict(tk.launches)
            decoded = routes(native)
            # the scene's 10 JPEGs, the first read twice (its size, then its slice)
            want = {("jpeg", "native" if "jpeg" in native.formats() else "cv2-absent"): 11}
            check(native.decodes == want, f"real_scenes_cli decodes {decoded} != {want}")
        pngs = sorted(p.name for p in (Path(tmp) / "out" / "warped_result" / "0").iterdir())
        sample = RealScenesDataset(f"{tmp}/scenes")[0]
    check_launches(launched, E2E_LAUNCHES, "real_scenes_cli")
    net = load_params_auto(0, device=dev, arch="e2e")
    with torch.inference_mode():
        o = net(*(torch.from_numpy(sample[k][None]).to(dev)
                  for k in ("fs", "focus_dists", "fovs")))
    h, w = sample["unpadded"]
    (got,) = [{"depth": outs[3][0, :h, :w], "warped": outs[4][0, :, :h, :w]} for outs in kept]
    depth = o[3].float().cpu().numpy()[0, :h, :w]
    warped = o[4].float().cpu().numpy()[0, :, :h, :w]
    errs = {k: float(np.abs(got[k] - want).max())
            for k, want in (("depth", depth), ("warped", warped))}
    finite = all(bool(np.isfinite(got[k]).all()) for k in ("depth", "warped"))
    emit({"phase": "real_scenes_cli", "device": smi, "dtype": "fp32",
          "shape": list(sample["fs"].shape), "unpadded": [h, w],
          "avg_time_s": printed(out, "AVG_time"), "launches": launched, "decodes": decoded,
          "fp32_max_abs_err": errs, "atol": FP32_ATOL, "finite": finite, "pngs": len(pngs),
          "jpegs": [list(shape) for _, shape in jpegs]})
    check(finite and max(errs.values()) <= FP32_ATOL, f"real_scenes_cli against E2E: {errs}")
    check(len(pngs) == SCENE_SHAPE[0] and len(jpegs) == 1, "real_scenes_cli outputs")
    return launched


def train_cli_data(np) -> dict:
    """The DDFF-12 trainval file of the train command line's runs, as the dict
    of arrays that stands in for it: ``TRAIN_STACKS`` and ``VAL_STACKS`` uint8
    stacks of ``DDFF_SHAPE`` and disparities in the focus range (a tenth of
    the pixels without ground truth)."""
    rng = np.random.default_rng(23)
    n, h, w = DDFF_SHAPE
    split = {}
    for name, count in (("train", TRAIN_STACKS), ("val", VAL_STACKS)):
        split[f"stack_{name}"] = rng.integers(0, 256, (count, n, h, w, 3), dtype=np.uint8)
        disp = rng.uniform(0.021, 0.28, (count, h, w)).astype(np.float32)
        disp[rng.random((count, h, w)) < 0.1] = 0.0
        split[f"disp_{name}"] = disp
    return split


def train_cli_argv(data_root: str, root: str, steps: int = TRAIN_STEPS) -> list:
    return ["--recipe", "DDFF", "--lr", "1e-4", "--saveroot", root, "--batch_size", "4",
            "--cpus", "8", "--max_epoch", "1", "--steps-per-epoch", str(steps),
            "--data-root", data_root]


def train_cli_child(spec: str) -> int:
    """One run of the train command line in a process of its own (``--train-cli-
    child``): cuDNN keeps the plans it chose per convolution for the life of a
    process, whether it searched for them or not, so a run with
    ``cudnn.benchmark`` measures its search only where no convolution of its
    shapes ran before, as in a user's fresh process.  ``spec`` is JSON
    ``{"data_root", "root", "benchmark", "resume"}``; the run's launches,
    losses, times, validation outputs and the train state at the save of
    ``models/1.ckpt`` (or, resuming, just after its restore) go to
    ``root/run.pt``."""
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from dffx_torch.ops import kernels as tk
    from dffx_torch.train import cli
    from torch_fixtures import recording_train, run_cli

    spec = json.loads(spec)
    torch.cuda.init()
    snapshot = {}

    def keep(state):
        snapshot.update({k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()})
        for i, p in enumerate(state.model.parameters()):
            for slot, v in state.optimizer.state.get(p, {}).items():
                snapshot[f"adam.{i}.{slot}"] = v.detach().cpu().clone()
        snapshot["step"] = torch.tensor(state.step)

    save_async, restore = cli.ckpt.save_async, cli.ckpt.restore

    def kept_save(path, state):
        if Path(path).name == "1.ckpt":
            keep(state)
        return save_async(path, state)

    def kept_restore(path, state):
        keep(restore(path, state))
        return state

    cli.ckpt.save_async, cli.ckpt.restore = kept_save, kept_restore
    cli.CUDNN_BENCHMARK = spec["benchmark"]
    argv = train_cli_argv(spec["data_root"], spec["root"], spec.get("steps", TRAIN_STEPS))
    argv += ["--load_epoch", "-1"] if spec["resume"] else []
    argv += spec.get("flags", [])
    h5 = str(Path(spec["data_root"]) / "DDFF" / "ddff-dataset-trainval.h5")
    tk.reset_launches()
    with stand_ins({h5: train_cli_data(np)}, []), recording_train(cli) as ran:
        out = run_cli(cli.main, argv)
    torch.cuda.synchronize()
    torch.save({"out": out, "launches": dict(tk.launches), "losses": ran["losses"],
                "step_seconds": ran["step_seconds"], "val_seconds": ran["val_seconds"],
                "val_pred3": ran["val_pred3"], "step": ran["state"].step, "snapshot": snapshot,
                "params": {k: v.detach().cpu() for k, v in ran["state"].model.state_dict().items()}},
               Path(spec["root"]) / "run.pt")
    return 0


def phase_train_cli(torch, np, tk, dev, smi) -> dict:
    """``python -m dffx_torch.train.cli --recipe DDFF`` at batch 4 on
    DDFF-12-sized stacks that ``DDFFTrainval`` crops to 224 x 224, one epoch
    of 5 steps and a second of 5, validating 2 full-size stacks at epochs 0
    and 1.  Four runs, each in a process of its own (``train_cli_child``), in
    turns without, with, with and without ``cudnn.benchmark``, then the last
    run resumed.  Checks finite losses, ``models/1.ckpt``, that
    ``--load_epoch -1`` restores the state of its save bit for bit, that epoch
    1's validation equals the CPU's forward of the same weights (1e-4), and
    the launches: one of each DFFNet kernel a validation forward, none in
    train steps.  Returns the launches of the last run."""
    from dffx_torch.data import ddff_focus_dists
    from dffx_torch.eval import load_params_auto

    n, h, w = DDFF_SHAPE
    val_forwards = 2 * VAL_STACKS  # epochs 0 and 1
    want = {k: v * val_forwards for k, v in DFFNET_LAUNCHES.items()}

    def child(spec: dict) -> dict:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--train-cli-child",
                        json.dumps(spec)], check=True, timeout=600)
        return torch.load(Path(spec["root"]) / "run.pt", weights_only=False)

    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for i, bench in enumerate((False, True, True, False)):
            root = f"{tmp}/run{i}/"
            ran = child({"data_root": tmp, "root": root, "benchmark": bench, "resume": False})
            check_launches(ran["launches"], want, f"train_cli run {i}")
            steps_ms = [s * 1e3 for s in ran["step_seconds"]]
            val_ms = [s * 1e3 for e in sorted(ran["val_seconds"]) for s in ran["val_seconds"][e]]
            ckpt_file = Path(root) / "models" / "1.ckpt"
            emit({"phase": "train_cli", "device": smi, "run": i, "cudnn_benchmark": bench,
                  "batch": 4, "crop": [n, 224, 224], "val_shape": [n, h, w],
                  "first_step_ms": steps_ms[0],
                  "ms_per_step": statistics.median(steps_ms[1:]), "steps_ms": steps_ms,
                  "first_val_forward_ms": val_ms[0],
                  "val_forward_ms": statistics.median(val_ms[1:]), "val_ms": val_ms,
                  "losses": ran["losses"], "launches": ran["launches"],
                  "train_step_launches": sum(ran["launches"].values())
                  - val_forwards * sum(DFFNET_LAUNCHES.values()),
                  "ckpt_written": ckpt_file.exists()})
            check(all(np.isfinite(ran["losses"])) and len(ran["losses"]) == 2 * TRAIN_STEPS,
                  f"train_cli losses {ran['losses']}")
            check(ckpt_file.exists(), "train_cli: no models/1.ckpt")
            runs[i] = ran
        root = f"{tmp}/run3/"
        resumed = child({"data_root": tmp, "root": root, "benchmark": False, "resume": True})
        cpu_net = load_params_auto(str(Path(root) / "models" / "1.ckpt"), device="cpu")
    saved, back = runs[3]["snapshot"], resumed["snapshot"]
    same = sorted(saved) == sorted(back) and all(torch.equal(saved[k], back[k]) for k in saved)
    val_gap = max(float(np.abs(a - b).max())
                  for a, b in zip(resumed["val_pred3"][1], runs[3]["val_pred3"][1]))
    check_launches(resumed["launches"], {k: v * VAL_STACKS for k, v in DFFNET_LAUNCHES.items()},
                   "train_cli resumed")
    # epoch 1's validation on the card against the CPU's forward of 1.ckpt
    split = train_cli_data(np)
    fd = ddff_focus_dists()
    fd = (fd - fd.min()) / (fd.max() - fd.min())  # DDFFTrainval's normalised distances
    errs = []
    with torch.inference_mode():
        for s in range(VAL_STACKS):
            fs = split["stack_val"][s].astype(np.float32) / 127.5 - 1.0
            fs = np.pad(fs, ((0, 0), (0, -h % 32), (0, -w % 32), (0, 0)), constant_values=-1.0)
            p3 = cpu_net(torch.from_numpy(fs[None]), torch.from_numpy(fd[None]))[3]
            errs.append(float(np.abs(runs[3]["val_pred3"][1][s][:h, :w]
                                     - p3.numpy()[0, :h, :w]).max()))
    emit({"phase": "train_cli_resume_and_validation", "epoch": 1,
          "fp32_max_abs_err_vs_cpu": max(errs), "atol": FP32_ATOL,
          "restored_bit_equal": same, "tensors_compared": len(saved),
          "resumed_auto": "auto-resume from epoch 1" in resumed["out"],
          "resumed_step": resumed["step"], "resumed_val_max_abs_gap": val_gap,
          "resumed_launches": resumed["launches"]})
    check(same and "auto-resume from epoch 1" in resumed["out"]
          and resumed["step"] == 2 * TRAIN_STEPS, "train_cli resume")
    check(max(errs) <= FP32_ATOL and val_gap <= FP32_ATOL,
          f"train_cli validation: {errs} against the CPU, {val_gap} resumed")
    return runs[3]["launches"]


#: the simulate phase: NYU-v2's labeled scenes (480 x 640 RGB-D) made from a
#: seed, rendered by the simulator's command line at its defaults (224 x 352,
#: 10 slices, 2,000 planes); the first SIM_CPU_SCENES again on the card's host
SIM_SCENES, NYU_SHAPE, SIM_CPU_SCENES, SIM_SLICES = 16, (480, 640), 2, 10
#: the simulator's bounds (tests/test_torch_sim.py): uint8 |d| <= 1 at more than
#: 99.9 % of the pixels with a median of 0; disparity and depth to rtol / atol
SIM_U8_SHARE, SIM_RTOL, SIM_ATOL = 0.999, 1e-4, 1e-3
#: the Simulated recipe's train steps on the simulator's output
SIM_TRAIN_BATCH, SIM_TRAIN_STEPS = 4, 2


class H5File(dict):
    """A stand-in h5 file (``HOST_GAPS``): a dict of arrays that also opens
    as a context, as ``load_nyu_v2`` opens it."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def nyu_mat(np) -> H5File:
    """``SIM_SCENES`` scenes of NYU-v2's labeled file in its v7.3 layout
    (``images (B, 3, W, H)`` uint8, ``depths (B, W, H)`` metres), made from a
    seed: smooth textured images; depths of 0.7-4 m, smooth, with a step edge
    and a tilted plane."""
    import cv2

    rng = np.random.default_rng(31)
    h, w = NYU_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    images, depths = [], []
    for _ in range(SIM_SCENES):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 4)
        images.append(cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX))
        base = cv2.GaussianBlur(rng.uniform(0.7, 4.0, (h // 8, w // 8)), (0, 0), 2)
        depth = cv2.resize(base, (w, h)) + (xx > rng.uniform(0.3, 0.7) * w) * rng.uniform(0.5, 1.5)
        depths.append(depth + 0.5 * yy / h)
    return H5File(images=np.stack(images).transpose(0, 3, 2, 1),
                  depths=np.stack(depths).transpose(0, 2, 1).astype(np.float32))


def sim_gap(np, got, want) -> dict:
    """The bounds' numbers for two scenes' files: uint8 share within 1 and
    median, and the worst relative excess of depth and defocus over rtol /
    atol (<= 1 passes; ``inf`` where the warped depth is 0 must match)."""
    d = np.abs(got["imgs"].astype(int) - want["imgs"].astype(int))
    over = {}
    for key in ("depth", "defocus"):
        a, b = got[key], want[key]
        same_inf = np.array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(b)
        over[key] = float((np.abs(a[fin] - b[fin]) / (SIM_ATOL + SIM_RTOL * np.abs(b[fin])))
                          .max()) if same_inf else float("inf")
    return {"u8_max": int(d.max()), "u8_share_within_1": float((d <= 1).mean()),
            "u8_median": float(np.median(d)), "depth_over_bound": over["depth"],
            "defocus_over_bound": over["defocus"]}


def read_sim_scene(np, root: str, idx: int) -> dict:
    import cv2
    import scipy.io as sio

    path = Path(root) / str(idx)
    mats = sio.loadmat(str(path / "depth.mat"))
    cam = sio.loadmat(str(path / "camera_param.mat"))
    return {"imgs": np.stack([cv2.imread(str(path / f"img{i}.png")) for i in range(SIM_SLICES)]),
            "depth": mats["depth"], "defocus": mats["defocus"],
            "camera": {k: v for k, v in cam.items() if not k.startswith("__")}}


def phase_simulate(torch, np, tk, dev, smi) -> None:
    """``python -m dffx_torch simulate`` (``dffx_torch.sim.simulator.main``)
    on the card at its defaults over ``SIM_SCENES`` NYU-shaped scenes: its
    ``avg_time`` (wall seconds a scene), the device seconds a scene of each
    scene's render program (``profiling.device_loop_time``), the device's
    busy share over a profiled run; the first scenes against ``--device
    cpu``; TF32 off; then 2 steps of the ``Simulated`` recipe (E2E) on the
    written scenes through ``SimulatedScenesDataset`` and ``Loader``, and one
    validation forward.  No kernel launches in the render or the steps."""
    from dffx_torch.data import Loader, SimulatedScenesDataset
    from dffx_torch.sim import simulator as sim
    from dffx_torch.train import make_train_step
    from dffx_torch.train.loop import make_eval_fn
    from dffx_torch.train.recipes import RECIPES
    from dffx_torch.utils.profiling import device_loop_time
    from torch_fixtures import run_cli

    rendered = []  # (device, (image, depth, depth_px, slice_params)) of each scene
    operands = sim.scene_operands

    def kept(image, depth, depth_px, slice_params, device):
        rendered.append((torch.device(device), (image, depth, depth_px, slice_params)))
        return operands(image, depth, depth_px, slice_params, device)

    with tempfile.TemporaryDirectory() as tmp:
        mat = f"{tmp}/nyu_depth_v2_labeled.mat"
        gpu_dir, cpu_dir, prof_dir = f"{tmp}/NYU_move_out_0_1/", f"{tmp}/cpu/", f"{tmp}/prof/"
        argv = ["--nyu-mat", mat, "--seed", "0"]
        # PyTorch's default for cuDNN is TF32 on: the command line turns it off
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        sim.scene_operands = kept
        try:
            with stand_ins({mat: nyu_mat(np)}, []):
                tk.reset_launches()
                t0 = time.perf_counter()
                out = run_cli(sim.main, argv + ["--dataset", gpu_dir])
                wall = time.perf_counter() - t0
                launched = dict(tk.launches)
                tf32 = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
                t0 = time.perf_counter()
                busy, copies = device_seconds(torch, lambda: run_cli(
                    sim.main, argv + ["--dataset", prof_dir, "--limit", "4"]))
                pwall = time.perf_counter() - t0
                cpu_out = run_cli(sim.main, argv + ["--dataset", cpu_dir, "--device", "cpu",
                                                    "--limit", str(SIM_CPU_SCENES)])
        finally:
            sim.scene_operands = operands
        check_launches(launched, {}, "simulate")
        check(tf32 == [False, False], f"simulate left TF32 on: {tf32}")
        scenes = [sc for d, sc in rendered if d.type == "cuda"]
        check(len(scenes) == SIM_SCENES + 4, f"simulate rendered {len(scenes)} scenes")
        # each scene's render program alone on the card, operands in place
        with torch.inference_mode(), sim._fp32_exact(dev):
            device_s = [device_loop_time(sim.render_program,
                                         *sim.scene_operands(*sc, dev), iters=3)
                        for sc in scenes[:SIM_SCENES]]
        # the library's render under TF32 on gives the same bits, and restores the flag
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        on = sim.render_scene_fused(*scenes[0], device=dev)
        restored = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        off = sim.render_scene_fused(*scenes[0], device=dev)
        immune = bool(np.array_equal(on[0], off[0]) and np.array_equal(on[1], off[1]))
        # the card's files against the CPU's
        gaps, cams_equal = [], True
        for i in range(SIM_CPU_SCENES):
            got, want = read_sim_scene(np, gpu_dir, i), read_sim_scene(np, cpu_dir, i)
            gaps.append(sim_gap(np, got, want))
            cams_equal &= all(np.array_equal(got["camera"][k], want["camera"][k])
                              for k in want["camera"])
        files = sorted(p.name for p in (Path(gpu_dir) / "0").iterdir())
        plans = [sc[3] for sc in scenes[:SIM_SCENES]]
        emit({"phase": "simulate", "device": smi, "scenes": SIM_SCENES,
              "shape": [SIM_SLICES, 224, 352], "planes": 2000, "nyu_shape": list(NYU_SHAPE),
              "avg_time_s_per_scene": printed(out, "avg_time"),
              "wall_s_per_scene": wall / SIM_SCENES,
              "device_s_per_scene": statistics.mean(device_s),
              "device_s_per_scene_each": device_s,
              "profiled_scenes": 4, "profiled_wall_s": pwall,
              "device_busy_share": busy / pwall, "copy_share": copies / pwall,
              "cpu_avg_time_s_per_scene": printed(cpu_out, "avg_time"),
              "layers_max": max(len(p["layers"]) for plan in plans for p in plan),
              "coc_max": max(abs(c) for plan in plans for p in plan for c, _, _ in p["layers"]),
              "tf32_after_cli": tf32, "tf32_flag_restored": restored,
              "render_same_bits_under_tf32_flag": immune, "launches": launched,
              "gpu_vs_cpu": gaps, "camera_equal": bool(cams_equal), "files": files,
              "bound": {"u8_share": SIM_U8_SHARE, "rtol": SIM_RTOL, "atol": SIM_ATOL}})
        check(immune and restored == [True, True], "simulate: the render follows the TF32 flag")
        check(cams_equal and all(g["u8_share_within_1"] > SIM_U8_SHARE and g["u8_median"] == 0
                                 and g["depth_over_bound"] <= 1 and g["defocus_over_bound"] <= 1
                                 for g in gaps), f"simulate on the card against the CPU: {gaps}")
        check(len(files) == SIM_SLICES + 2, f"simulate wrote {files}")

        # the port's reader and E2E trainer on the port's simulator output
        recipe = RECIPES["Simulated"]
        train = SimulatedScenesDataset(gpu_dir, mode="train", seed=0)
        val = SimulatedScenesDataset(gpu_dir, mode="val")
        check(len(train) == len(val) == SIM_SCENES, "SimulatedScenesDataset scenes")
        state = new_train_state(torch, 0, True, dev)
        step = make_train_step(TRAIN_LR, recipe.loss, e2e=True)
        keys = ("fs", "depth", "focus_dists", "mask", "fovs")
        losses, shapes = [], None
        tk.reset_launches()
        for i, batch in enumerate(Loader(train, SIM_TRAIN_BATCH, shuffle=True, drop_last=True)):
            if i == SIM_TRAIN_STEPS:
                break
            shapes = {k: list(batch[k].shape) for k in keys}
            state, logs = step(state, {k: torch.from_numpy(batch[k]).to(dev) for k in keys})
            losses.append(float(logs["loss"]))
        torch.cuda.synchronize()
        step_launches = dict(tk.launches)
        sample = val[0]
        outs = make_eval_fn(e2e=True)(state.model, {
            k: torch.from_numpy(np.asarray(sample[k])[None]).to(dev)
            for k in ("fs", "focus_dists", "fovs")})
        torch.cuda.synchronize()
        val_launches = {k: v - step_launches[k] for k, v in tk.launches.items()}
        finite = all(bool(torch.isfinite(t).all()) for t in outs)
    emit({"phase": "simulate_train", "device": smi, "recipe": recipe.name,
          "batch_shapes": shapes, "val_fs": list(sample["fs"].shape), "losses": losses,
          "step_launches": step_launches, "val_launches": val_launches,
          "val_outputs_finite": finite})
    check(len(losses) == SIM_TRAIN_STEPS and all(np.isfinite(losses)),
          f"Simulated recipe on the simulator's scenes: losses {losses}")
    check_launches(step_launches, {}, "simulate_train steps")
    check_launches(val_launches, E2E_LAUNCHES, "simulate_train validation")
    check(finite and list(sample["fs"].shape) == [SIM_SLICES, 224, 352, 3],
          "simulate_train validation forward")


FRONT_DOOR = ("eval", "real-scenes", "train", "simulate", "doctor")


def phase_front_door(kind: str, smi: str) -> None:
    """``python -m dffx_torch doctor``, ``--version`` and ``<cmd> --help`` for
    the five commands, each a process of its own, all started together:
    every one exits 0, and ``doctor`` names the card and its power limit."""
    argvs = [["doctor"], ["--version"]] + [[cmd, "--help"] for cmd in FRONT_DOOR]
    procs = [(argv, subprocess.Popen([sys.executable, "-m", "dffx_torch", *argv], cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for argv in argvs]
    rcs, outs = {}, {}
    for argv, proc in procs:
        out, err = proc.communicate(timeout=300)
        rcs[" ".join(argv)], outs[" ".join(argv)] = proc.returncode, out + err
    doctor = outs["doctor"].splitlines()
    power = smi.split(",")[-1].strip()
    emit({"phase": "front_door", "rcs": rcs, "doctor": doctor})
    check(all(rc == 0 for rc in rcs.values()), f"front door exit codes {rcs}: {outs}")
    check(any(kind in ln and power in ln for ln in doctor if "cuda device" in ln),
          f"doctor does not name {kind} at {power}")
    check(doctor[-1] == "doctor: environment healthy", "doctor: core checks")


# ---------------------------------------------------------------------------
# several processes: data-parallel training and spatial serving
# ---------------------------------------------------------------------------

#: data-parallel training: the global batch over 2 ranks that share the card
#: (gloo, host-staged), DP_STEPS steps in each BatchNorm mode
DP_RANKS, DP_STEPS, DP_SEED = 2, 3, 41
#: spatial serving over 2 ranks on the card: (name, E2E?, H x W, dtypes, kernels);
#: DDFF-12's padded test shape, then the real-scene shape, then --spatial-xla
SPATIAL_RANKS, SPATIAL_REPS, SPATIAL_SEED = 2, 5, 43
SPATIAL_CASES = (("dffnet", False, (384, 576), ("float32", "bfloat16"), True),
                 ("e2e", True, (384, 576), ("float32", "bfloat16"), True),
                 ("e2e", True, (EH, EW), ("float32",), True),
                 ("dffnet_spatial_xla", False, (384, 576), ("float32",), False))
#: the kernels' chains and the height each one runs at in an H x W forward
CHAIN_HEIGHTS = {"fm_conv_bn_relu": (1,), "rb2d_residual": (1,), "srd_attention_residual": (1,),
                 "rb_of_chain": (1, 2, 4), "motion_head_conv_chain": (1,)}
HALO_ROWS = 16  # dffx_torch.ops.halo.HALO
#: ``bn_act`` launches a rank in one bf16 forward with the kernels at 384 rows
#: over SPATIAL_RANKS: the whole forward's (BN_PASSES) and the stock layers'
#: at the edge rows of each chain that splits, 3 in DFFNet and 12 in E2E (the
#: same on every rank, and on the CPU under ``profiling.collect()``)
SPATIAL_BN_PASSES = {"dffnet": 58, "e2e": 77}
#: a sharded chain against the same chain whole on the same input, and the
#: sharded forward against the whole forward with the same edge rows patched
#: in: a share of the largest value (bf16 keeps 8 bits)
SITE_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
#: bf16: the sharded forward's RMS gap to the whole fp32 forward, at most this
#: many times the whole bf16 forward's
RMS_RATIO = 1.1


def shard_rows(h: int, s: int) -> int:
    """The rows a kernel launches on for a chain of height h over s ranks: a
    shard and its halo rows where h divides by 32 s, else the whole height."""
    return h // s + 2 * HALO_ROWS if h % (32 * s) == 0 else h


def split_sites(h: int, e2e: bool) -> int:
    """The chain sites of an H x W forward whose height splits over
    SPATIAL_RANKS: the FM chain, and in E2E also the three ``rb_of_chain``
    levels (H, H/2, H/4) and the motion head."""
    heights = [h] + ([h, h // 2, h // 4, h] if e2e else [])
    return sum(x % (32 * SPATIAL_RANKS) == 0 for x in heights)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(task: str, world: int, tmp: str, timeout: float = 600, **spec) -> list:
    """``task`` on ``world`` ranks, each a process of its own on the card
    (``--rank-child``), all started together; returns each rank's result.
    Every rank's group times out well before ``timeout``."""
    procs = []
    for rank in range(world):
        child = {"task": task, "world": world, "rank": rank, "out": tmp,
                 "coordinator": f"file://{tmp}/rdv_{task}_{world}", **spec}
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--rank-child", json.dumps(child)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(all(p.returncode == 0 for p in procs),
          f"{task} ranks: " + "\n".join(f"rank {r} rc {p.returncode}: {o[-3000:]}"
                                        for r, (p, o) in enumerate(zip(procs, outs))))
    import torch

    return [torch.load(Path(tmp) / f"{task}_{world}_{r}.pt", weights_only=False)
            for r in range(world)]


def watch_kernel_rows(tk) -> dict:
    """Each kernel's input heights, launch by launch, from the module sites that
    call the wrappers (``layers``, ``alignnet``); clear the lists to start."""
    from dffx_torch.models import alignnet, layers

    rows = {name: [] for name in PORTED}
    for module in (layers, alignnet):
        for name in PORTED:
            fn = getattr(module, name, None)
            if fn is None:
                continue

            def watched(x, *args, _fn=fn, _name=name, **kw):
                rows[_name].append(int(x.shape[3]))
                return _fn(x, *args, **kw)

            setattr(module, name, watched)
    return rows


def rank_child(spec: str) -> int:
    """One rank (``--rank-child``): joins the group of ``spec["coordinator"]``
    on the card, runs ``RANK_TASKS[spec["task"]]`` and saves its result."""
    import datetime

    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from dffx_torch.parallel import distributed

    spec = json.loads(spec)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.initialize(spec["coordinator"], spec["world"], spec["rank"],
                                 timeout=datetime.timedelta(seconds=300))
    try:
        result = RANK_TASKS[spec["task"]](torch, np, dev, spec)
        result["backend"] = torch.distributed.get_backend()
    finally:
        distributed.shutdown()
    torch.save(result, Path(spec["out"]) / f"{spec['task']}_{spec['world']}_{spec['rank']}.pt")
    return 0


def rank_dp_train(torch, np, dev, spec) -> dict:
    """DFFNet's train step on this rank's rows of a global batch of DP_BATCH
    (``shard_batch``), for each ``(mode, steps)`` of ``spec["modes"]``: a
    ``bn_mode``, or ``sync_deterministic`` (``sync`` with cuDNN's
    deterministic algorithms), or ``sync_float64`` (``sync`` with the model,
    the batch and the compute in float64).  Per step the host ms
    (synchronised), the logs and the bytes each collective moved; the first
    step's gradients and statistics; the state after the last."""
    from dffx_torch.ops import kernels as tk
    from dffx_torch.parallel import distributed, make_mesh, shard_batch
    from dffx_torch.train import LossConfig, make_train_step

    mesh = make_mesh()
    runs = {}
    for mode, n_steps in spec["modes"]:
        torch.backends.cudnn.deterministic = mode.endswith("_deterministic")
        dtype = torch.float64 if mode.endswith("_float64") else torch.float32
        state = new_train_state(torch, 0, False, dev, dtype)
        step = make_train_step(TRAIN_LR, LossConfig(), compute_dtype=dtype, mesh=mesh,
                               bn_mode=mode.split("_deterministic")[0].split("_float64")[0])
        rng = np.random.default_rng(DP_SEED)
        steps = []
        tk.reset_launches()
        for i in range(n_steps):
            local = shard_batch(train_batch(np, rng, TB, TN, TH, TW, False,
                                            np.float64 if dtype == torch.float64 else None),
                                mesh, dev)
            distributed.reset_traffic()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, logs = step(state, local)
            logs = {k: float(v) for k, v in logs.items()}
            torch.cuda.synchronize(dev)
            rec = {"ms": (time.perf_counter() - t0) * 1e3, "logs": logs,
                   "traffic": dict(distributed.traffic)}
            if i == 0:  # copies: on the CPU .cpu() would hand back the live tensors
                rec.update(grads={k: v.clone() for k, v in grads_of(state).items()},
                           stats={k: v.clone() for k, v in stats_of(state).items()})
            steps.append(rec)
        runs[mode] = {"steps": steps, "launches": dict(tk.launches),
                      "state": {k: v.cpu() for k, v in state.model.state_dict().items()},
                      "adam": [{k: v.cpu() for k, v in state.optimizer.state[p].items()}
                               for p in state.model.parameters()]}
    torch.backends.cudnn.deterministic = False
    # the collectives alone, on this rank's card: the step's gradient
    # all-reduce and one BN layer's statistics (2 x 32 sums and the count, fp32)
    group = mesh.group("data")
    sizes = {"grads": sum(p.numel() for p in state.model.parameters()), "bn_stats": 65}
    runs["collective_ms"] = {}
    for what, n in sizes.items():
        buf = torch.zeros(n, device=dev)
        times = []
        for _ in range(6):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            distributed.all_reduce_(buf, group)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        runs["collective_ms"][what] = statistics.median(times[1:])
    return runs


def probe_chain_sites(torch) -> dict:
    """Wraps ``chain_site`` (in ``layers`` and ``alignnet``) for the probe
    forwards that follow the counted ones.  ``probe["mode"]`` None passes
    through.  ``"compare"`` (under a sharded forward) records, at each chain
    whose height splits, the sharded output against the same chain run whole
    on the same input (the kernels, or with ``kernels=False`` the stock
    layers): the largest gap in the edge rows (``bleed + EDGE_MARGIN`` at each
    true edge, which the stock layers patch), in the other rows, and against
    the whole output with those edge rows patched.  ``"patch"`` (under a whole
    forward) gives each such chain's output the stock layers' edge rows,
    computed on the strips ``halo_sharded_chain`` uses: the whole forward then
    does at every row what the sharded one does."""
    from dffx_torch.models import alignnet, layers
    from dffx_torch.ops.halo import EDGE_MARGIN, HALO

    probe = {"mode": None, "kernels": True, "sites": []}
    site = layers.chain_site

    def probed(x, kernel_fn, stock_fn, *, bleed):
        y = site(x, kernel_fn, stock_fn, bleed=bleed)
        h = x.shape[3]
        if probe["mode"] is None or h % (32 * SPATIAL_RANKS):
            return y
        e = bleed + EDGE_MARGIN
        strip = -(-(e + HALO) // 32) * 32

        def patched(t):
            t = t.clone()
            t[:, :, :, :e] = stock_fn(x[:, :, :, :strip])[:, :, :, :e]
            t[:, :, :, h - e:] = stock_fn(x[:, :, :, h - strip:])[:, :, :, strip - e:]
            return t

        if probe["mode"] == "patch":
            return patched(y)
        whole = (kernel_fn if probe["kernels"] else stock_fn)(x)
        gap = (y.float() - whole.float()).abs().amax(dim=(0, 1, 2, 4))  # a row each
        probe["sites"].append({
            "site": f"{kernel_fn.__qualname__.split('.')[0]}_{h}", "bleed": bleed,
            "edge_gap": float(torch.cat([gap[:e], gap[h - e:]]).max()),
            "interior_gap": float(gap[e:h - e].max()),
            "patched_gap": float((y.float() - patched(whole).float()).abs().max()),
            "whole_abs_max": float(whole.float().abs().max())})
        return y

    layers.chain_site = alignnet.chain_site = probed
    return probe


def rank_spatial(torch, np, dev, spec) -> dict:
    """The SPATIAL_CASES through ``TimedForward(spatial=2)`` against the same
    model whole (``TimedForward()``) on this rank: per case and dtype the
    forward ms of both (CUDA events, SPATIAL_REPS after one each), the
    sharded run's launches, kernel input heights and bytes moved a forward,
    and the largest gap to the whole forward on each output.  Then, outside
    the counts, the probe forwards (``probe_chain_sites``): each chain's
    sharded output against the chain whole on the same input, and the
    outputs against the whole forward with the same edge rows patched in,
    and against the whole forward run again; for bf16 the RMS gap of the
    sharded and of the whole forward to the whole fp32 forward."""
    from dffx_torch.eval import TimedForward, load_params_auto
    from dffx_torch.headline import heads_ok
    from dffx_torch.ops import kernels as tk
    from dffx_torch.parallel import distributed

    rows = watch_kernel_rows(tk)
    probe = probe_chain_sites(torch)
    rng = np.random.default_rng(SPATIAL_SEED)
    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    fovs = np.linspace(1.0, 1.02, 10, dtype=np.float32)[None]

    def rms(a, b):
        return float((a - b).square().mean().sqrt())

    cases = []
    for name, e2e, (h, w), dtypes, kernels in SPATIAL_CASES:
        model = load_params_auto(0, device=dev, arch="e2e" if e2e else "dffnet")
        args = [rng.uniform(-1, 1, (1, 10, h, w, 3)).astype(np.float32), fd]
        args += [fovs] if e2e else []
        ref32 = None
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            whole = TimedForward(model, dtype=dt)
            sharded = TimedForward(model, dtype=dt, spatial=SPATIAL_RANKS, spatial_pallas=kernels)
            ref = [o.float() for o in whole(*args)]
            ref32 = ref if dtype == "float32" else ref32
            sharded(*args)
            whole.total = whole.count = 0
            for _ in range(SPATIAL_REPS):
                whole(*args)
            sharded.total = sharded.count = 0
            tk.reset_launches()
            distributed.reset_traffic()
            for v in rows.values():
                v.clear()
            for _ in range(SPATIAL_REPS):
                got = sharded(*args)
            torch.cuda.synchronize(dev)
            got = [o.float() for o in got]
            # the serving phases' check: finite, pred3 in the focus range
            finite, in_range = heads_ok(got, torch.from_numpy(fd), dt)
            case = {
                "finite": finite, "pred3_in_fd_range": in_range,
                "case": name, "e2e": e2e, "shape": [1, 10, h, w], "dtype": dtype,
                "kernels": kernels, "whole_ms": whole.avg_time * 1e3,
                "sharded_ms": sharded.avg_time * 1e3, "launches": dict(tk.launches),
                "rows": {k: sorted(set(v)) for k, v in rows.items() if v},
                "bytes_a_forward": {k: v / SPATIAL_REPS for k, v in distributed.traffic.items()},
                "max_abs_err": [float((g - r).abs().max()) for g, r in zip(got, ref)],
                "ref_abs_max": [float(r.abs().max()) for r in ref]}
            probe.update(mode="compare", kernels=kernels, sites=[])
            sharded(*args)
            case["sites"] = probe["sites"]
            if kernels:
                probe["mode"] = "patch"
                patched = [o.float() for o in whole(*args)]
                case["vs_patched_max_abs_err"] = [float((g - p).abs().max())
                                                  for g, p in zip(got, patched)]
            probe["mode"] = None
            case["whole_again_max_abs_err"] = [float((o.float() - r).abs().max())
                                               for o, r in zip(whole(*args), ref)]
            if dtype != "float32":
                case["rms_vs_fp32"] = {"whole": [rms(r, r32) for r, r32 in zip(ref, ref32)],
                                       "sharded": [rms(g, r32) for g, r32 in zip(got, ref32)]}
            cases.append(case)
    return {"cases": cases, "collective_ms": spatial_collectives(torch, dev)}


def spatial_collectives(torch, dev) -> dict:
    """The FM chain's two collectives alone at 10 x 384 x 576 fp32 over the
    spatial group: its halo exchange (16 rows of the 3-channel input with
    each neighbour) and its all-gather (this rank's 192 rows of the 8-channel
    output); median ms of 5 after one."""
    from dffx_torch.ops.halo import HALO, halo_rows
    from dffx_torch.parallel import distributed, make_mesh

    mesh = make_mesh(data=1, spatial=SPATIAL_RANKS)
    group = mesh.group("spatial")
    x = torch.zeros(1, 3, 10, 384 // SPATIAL_RANKS, 576, device=dev)
    y = torch.zeros(1, 8, 10, 384 // SPATIAL_RANKS, 576, device=dev)
    calls = {"halo_fm_input": lambda: halo_rows(x, mesh, HALO),
             "all_gather_fm_output": lambda: distributed.all_gather_cat(y, 3, group)}
    out = {}
    for name, call in calls.items():
        times = []
        for _ in range(6):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times[1:])
    return out


RANK_TASKS = {"dp_train": rank_dp_train, "spatial": rank_spatial}


#: the data-parallel step against one process in float64, where the order of
#: the sums costs ~1e-16 a sum: the 1e-5 the fp32 step cannot hold on the card
DP_F64_RTOL = 1e-5


def phase_dp_train(torch, np, tk, dev, smi) -> int:
    """``make_train_step(bn_mode=..., mesh=make_mesh())`` on DP_RANKS ranks
    that share the card (gloo; the payloads staged through the host): DFFNet
    at batch 4 (2 a rank) of 10 x 224 x 224, DP_STEPS steps in ``sync``, in
    ``per_shard`` and in ``sync`` with cuDNN's deterministic algorithms, one
    ``sync`` step in float64; then two ``sync`` steps at world size 1, over
    NCCL.  Checks: every rank logs the same losses and ends with the same
    parameters, buffers and Adam moments, bit for bit; the first ``sync``
    step (and NCCL's, and the deterministic one) against one process on the
    global batch in the same mode at the train phases' bounds; the float64
    step against one process in float64 within DP_F64_RTOL (loss,
    statistics, each gradient against its tensor's largest element, L2); no
    kernel launches.  Also reported: one process against itself, run again
    on the same state and batch, with cuDNN's default algorithms and with
    its deterministic ones.  Returns the launches (0)."""
    from dffx_torch.train import LossConfig, make_train_step

    modes = [("sync", DP_STEPS), ("per_shard", DP_STEPS), ("sync_deterministic", DP_STEPS),
             ("sync_float64", 1)]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = start_ranks("dp_train", DP_RANKS, tmp, modes=modes)
        (nccl,) = start_ranks("dp_train", 1, tmp, modes=[("sync", 2)])
    launches = 0

    def one_process(deterministic: bool = False, dtype=torch.float32) -> dict:
        """One step in one process on the global batch from the fresh state."""
        nonlocal launches
        rng = np.random.default_rng(DP_SEED)
        fdt = np.float64 if dtype == torch.float64 else None
        batch = on(torch, train_batch(np, rng, TB, TN, TH, TW, False, fdt), dev)
        torch.backends.cudnn.deterministic = deterministic
        one = new_train_state(torch, 0, False, dev, dtype)
        tk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one, logs = make_train_step(TRAIN_LR, LossConfig(), compute_dtype=dtype)(one, batch)
        loss = float(logs["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        torch.backends.cudnn.deterministic = False
        launches += sum(tk.launches.values())
        return {"logs": {"loss": loss}, "grads": grads_of(one), "stats": stats_of(one), "ms": ms}

    ones = {"sync": [one_process(), one_process()],
            "sync_deterministic": [one_process(True), one_process(True)],
            "sync_float64": [one_process(dtype=torch.float64)]}

    def against(first: dict, want: dict) -> dict:
        g_over, g_worst, g_l2 = grad_gap(first["grads"], want["grads"])
        s_over, counts = stats_gap(first["stats"], want["stats"])
        s_rel = max(float((first["stats"][k] - w).abs().max() / w.abs().max().clamp(min=1e-30))
                    for k, w in want["stats"].items() if not k.endswith("num_batches_tracked"))
        loss = want["logs"]["loss"]
        return {"loss_rel_err": abs(first["logs"]["loss"] - loss) / abs(loss),
                "grad_over_bound": g_over, "grad_worst_over_max": g_worst, "grad_rel_l2": g_l2,
                "stats_over_bound": s_over, "stats_worst_rel": s_rel, "counts_equal": counts}

    def agree(ok: dict) -> bool:
        return (ok["loss_rel_err"] <= 1e-5 and ok["grad_over_bound"] <= 1
                and ok["grad_rel_l2"] <= GRAD_L2 and ok["stats_over_bound"] <= 1
                and ok["counts_equal"])

    def agree_f64(ok: dict) -> bool:
        return (max(ok["loss_rel_err"], ok["grad_worst_over_max"], ok["grad_rel_l2"],
                    ok["stats_worst_rel"]) <= DP_F64_RTOL and ok["counts_equal"])

    gaps = {"one_process_again": against(ones["sync"][1], ones["sync"][0]),
            "one_process_again_deterministic": against(ones["sync_deterministic"][1],
                                                       ones["sync_deterministic"][0])}
    for mode, _ in modes:
        runs = [r[mode] for r in ranks]
        same_logs = all(a["logs"] == b["logs"] for a, b in zip(runs[0]["steps"], runs[1]["steps"]))
        same_state = all(torch.equal(runs[0]["state"][k], runs[1]["state"][k])
                         for k in runs[0]["state"])
        same_adam = all(torch.equal(a[k], b[k]) for a, b in zip(runs[0]["adam"], runs[1]["adam"])
                        for k in a)
        launches += sum(sum(r["launches"].values()) for r in runs)
        row = {"phase": "dp_train", "device": smi, "mode": mode, "ranks": DP_RANKS,
               "backend": ranks[0]["backend"], "batch": TB, "batch_a_rank": TB // DP_RANKS,
               "shape": [TN, TH, TW], "ms_steps": [[s["ms"] for s in r["steps"]] for r in runs],
               "ms_per_step": statistics.median(s["ms"] for r in runs
                                                for s in r["steps"][1:] or r["steps"]),
               "losses": [s["logs"]["loss"] for s in runs[0]["steps"]],
               "bytes_a_step": runs[0]["steps"][-1]["traffic"],
               "collective_alone_ms": ranks[0]["collective_ms"], "same_logs": same_logs,
               "same_state": same_state, "same_adam": same_adam,
               "launches": [r["launches"] for r in runs]}
        if mode in ones:
            row["one_process_ms"] = ones[mode][0]["ms"]
            row["vs_one_process"] = gaps[mode] = against(runs[0]["steps"][0], ones[mode][0])
        emit(row)
        check(same_logs and same_state and same_adam, f"dp_train {mode}: ranks differ")
        check(ranks[0]["backend"] == "gloo", "dp_train: two ranks on one card need gloo")
        check(all(np.isfinite(row["losses"])), f"dp_train {mode} losses {row['losses']}")
        if mode in ones:
            check((agree_f64 if mode == "sync_float64" else agree)(row["vs_one_process"]),
                  f"dp_train {mode} against one process: {row}")
    emit({"phase": "dp_train_gaps", "device": smi, "batch": TB, "shape": [TN, TH, TW],
          "f64_rtol": DP_F64_RTOL, "gaps": gaps})
    ok = against(nccl["sync"]["steps"][0], ones["sync"][0])
    emit({"phase": "dp_train_nccl", "device": smi, "backend": nccl["backend"], "world": 1,
          "batch": TB, "ms_steps": [st["ms"] for st in nccl["sync"]["steps"]], "vs_one_process": ok,
          "bytes_a_step": nccl["sync"]["steps"][0]["traffic"],
          "collective_alone_ms": nccl["collective_ms"]})
    check(nccl["backend"] == "nccl" and agree(ok), f"dp_train at world size 1 over NCCL: {ok}")
    check(launches == 0, f"dp_train: {launches} kernel launches in train steps")
    return launches


def phase_dp_train_cli(torch, np, tk, dev, smi) -> dict:
    """``python -m dffx_torch.train.cli --recipe DDFF`` as DP_RANKS ranks on
    the card with ``dffx``'s flags (``--coordinator 127.0.0.1:<port>
    --num_processes 2 --process_id r --bn_mode per_shard``), batch 4 (2 a
    rank), two epochs of one step, each rank with its own ``--saveroot``:
    only rank 0 writes ``models/*.ckpt`` and validates (one launch of each
    DFFNet kernel a validation forward, 4 of them); both ranks log the same
    losses and end with the same weights.  Returns rank 0's launches."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(DP_RANKS):
            flags = ["--coordinator", f"127.0.0.1:{port}", "--num_processes", str(DP_RANKS),
                     "--process_id", str(rank), "--bn_mode", "per_shard"]
            spec = {"data_root": tmp, "root": f"{tmp}/rank{rank}/", "benchmark": True,
                    "resume": False, "steps": 1, "flags": flags}
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           "--train-cli-child", json.dumps(spec)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        outs = []
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        check(all(p.returncode == 0 for p in procs),
              "dp_train_cli: " + "\n".join(o[-3000:] for o in outs))
        runs = [torch.load(Path(tmp) / f"rank{r}" / "run.pt", weights_only=False)
                for r in range(DP_RANKS)]
        ckpts = [sorted(p.name for p in (Path(tmp) / f"rank{r}" / "models").glob("*"))
                 for r in range(DP_RANKS)]
    same = all(torch.equal(runs[0]["params"][k], runs[1]["params"][k]) for k in runs[0]["params"])
    want = {k: v * 2 * VAL_STACKS for k, v in DFFNET_LAUNCHES.items()}
    emit({"phase": "dp_train_cli", "device": smi, "ranks": DP_RANKS, "bn_mode": "per_shard",
          "batch": 4, "models": ckpts, "losses": [r["losses"] for r in runs],
          "ms_steps": [[s * 1e3 for s in r["step_seconds"]] for r in runs],
          "same_params": same, "launches": [r["launches"] for r in runs],
          "rank0_prints": runs[0]["out"].splitlines()[:3], "rank1_prints": runs[1]["out"]})
    check(ckpts[0] == ["1.ckpt"] and ckpts[1] == [], f"dp_train_cli checkpoints {ckpts}")
    check(runs[0]["losses"] == runs[1]["losses"] and len(runs[0]["losses"]) == 2
          and all(np.isfinite(runs[0]["losses"])) and same, "dp_train_cli: ranks differ")
    check(runs[1]["out"] == "" and "backend gloo" in runs[0]["out"], "dp_train_cli prints")
    check_launches(runs[0]["launches"], want, "dp_train_cli rank 0")
    check_launches(runs[1]["launches"], {}, "dp_train_cli rank 1")
    return runs[0]["launches"]


def phase_spatial(torch, np, tk, dev, smi) -> dict:
    """``TimedForward(spatial=2)`` (``--spatial 2``) on SPATIAL_RANKS ranks that
    share the card, per SPATIAL_CASES.  Checks, on every rank, after every
    case's row is printed: each of the five kernels launched once a forward a
    rank (``rb_of_chain`` three times) on the rows ``shard_rows`` gives, none
    under ``--spatial-xla``, and ``bn_act`` SPATIAL_BN_PASSES times a bf16
    forward, never in fp32; the outputs finite, pred3 in the focus range (the
    serving phases' ``check_depth``); each chain whose height splits, against
    the same chain whole on the same input, within SITE_RTOL of its largest
    value in its edge rows and in the rest (the edge rows are the stock
    layers', the rest the kernels'); the outputs against the whole forward
    with the same edge rows patched in within SITE_RTOL of each output's
    largest value (the sharding adds nothing else); in fp32 the outputs
    against the whole forward within 1e-5 of each output's largest value
    (``--spatial-xla``, whose chains are the stock layers, within FP32_ATOL,
    the port's kernels-to-stock bound); in bf16 the outputs' RMS gap to the
    whole fp32 forward within RMS_RATIO of the whole bf16 forward's.  Each
    output's bound adds the whole forward's gap to itself, run again.
    Returns, per kernel, its launches on rank 0 per case and dtype."""
    with tempfile.TemporaryDirectory() as tmp:
        ranks = start_ranks("spatial", SPATIAL_RANKS, tmp)
    per_kernel = {name: {} for name in KERNELS}
    for i, case in enumerate(ranks[0]["cases"]):
        emit({"phase": "spatial", "device": smi, "case": case["case"], "shape": case["shape"],
              "dtype": case["dtype"], "ranks": SPATIAL_RANKS, "backend": ranks[0]["backend"],
              "kernels": case["kernels"], "whole_ms": [r["cases"][i]["whole_ms"] for r in ranks],
              "sharded_ms": [r["cases"][i]["sharded_ms"] for r in ranks],
              "launches_a_rank": case["launches"], "rows": case["rows"],
              "bytes_a_forward": case["bytes_a_forward"],
              "max_abs_err": [r["cases"][i]["max_abs_err"] for r in ranks],
              "ref_abs_max": case["ref_abs_max"],
              "vs_patched_max_abs_err": [r["cases"][i].get("vs_patched_max_abs_err")
                                         for r in ranks],
              "whole_again_max_abs_err": [r["cases"][i]["whole_again_max_abs_err"]
                                          for r in ranks],
              "rms_vs_fp32": [r["cases"][i].get("rms_vs_fp32") for r in ranks],
              "sites": [r["cases"][i]["sites"] for r in ranks],
              "site_rtol": SITE_RTOL[case["dtype"]],
              "atol": FP32_ATOL if case["dtype"] == "float32" else None,
              "finite": case["finite"], "pred3_in_fd_range": case["pred3_in_fd_range"]})
    emit({"phase": "spatial_collectives", "device": smi, "ranks": SPATIAL_RANKS,
          "backend": ranks[0]["backend"], "shape": [1, 10, 384, 576], "dtype": "float32",
          "ms_alone": [r["collective_ms"] for r in ranks]})
    for i, case in enumerate(ranks[0]["cases"]):
        h = case["shape"][2]
        network = "e2e" if case["e2e"] else "dffnet"
        want = NET_LAUNCHES[network] if case["kernels"] else {}
        want_rows = {k: sorted({shard_rows(h // f, SPATIAL_RANKS) for f in CHAIN_HEIGHTS[k]})
                     for k in want}
        check(case["kernels"] or case["dtype"] == "float32", "spatial: bf16 runs the kernels")
        passes = SPATIAL_BN_PASSES[network] if case["dtype"] == "bfloat16" else 0
        rtol = SITE_RTOL[case["dtype"]]
        for r, rank in enumerate(ranks):
            c = rank["cases"][i]
            what = f"spatial {c['case']} {c['dtype']} rank {r}"
            check_launches(c["launches"], {**{k: v * SPATIAL_REPS for k, v in want.items()},
                                           "bn_act": passes * SPATIAL_REPS}, what)
            check(c["rows"] == want_rows, f"{what}: rows {c['rows']} != {want_rows}")
            check(c["finite"] and c["pred3_in_fd_range"], f"{what}: not finite or out of range")
            check(len(c["sites"]) == split_sites(h, c["e2e"]),
                  f"{what}: sites {[s['site'] for s in c['sites']]}")
            for site in c["sites"]:
                lim = rtol * site["whole_abs_max"]
                check(max(site["edge_gap"], site["interior_gap"], site["patched_gap"]) <= lim,
                      f"{what}: chain {site} beyond {lim}")
            # an output's bound: a share of its largest value beyond the gap
            # of the whole forward to itself, run again (fp32 cuDNN is not
            # deterministic; bf16 repeats itself bit for bit)
            lims = [rtol * m + a for m, a in zip(c["ref_abs_max"], c["whole_again_max_abs_err"])]
            if case["kernels"]:
                check(all(g <= lim for g, lim in zip(c["vs_patched_max_abs_err"], lims)),
                      f"{what}: against the patched whole forward {c['vs_patched_max_abs_err']}")
            if c["dtype"] == "float32":
                # the kernels' sharded forward against the whole one within
                # those bounds; --spatial-xla's stock chains against the
                # kernels' whole forward at the port's kernels-to-stock bound
                lims = lims if c["kernels"] else [FP32_ATOL] * len(lims)
                check(all(g <= lim for g, lim in zip(c["max_abs_err"], lims)),
                      f"{what}: {c['max_abs_err']} beyond {lims}")
            else:
                rms = c["rms_vs_fp32"]
                check(all(s <= RMS_RATIO * w for s, w in zip(rms["sharded"], rms["whole"])),
                      f"{what}: further from fp32 than the whole forward: {rms}")
        key = f"{case['case']}_{'x'.join(map(str, case['shape'][2:]))}_{case['dtype']}"
        for name in KERNELS:
            per_kernel[name][key] = case["launches"][name]
    check(all(any(v.values()) for v in per_kernel.values()), "spatial: a kernel never launched")
    return per_kernel


#: ``python3 -m dffx_torch.headline --budget HEADLINE_BUDGET`` as a child, killed
#: after HEADLINE_TIMEOUT seconds.  On an H100 the phases before it took 434 s
#: of the script's 1,200, and the child 223 s: its serving points 105 s, its
#: sections 107 s of the 190 s their estimates add up to
HEADLINE_BUDGET, HEADLINE_TIMEOUT = 360, 450
HEADLINE_SECTIONS = ("kernel_gate", "train_b128", "e2e", "train_b32", "simulator")
#: the headline's serving and end-to-end points and the network each forwards
HEADLINE_FORWARDS = {"b1": "dffnet", "b4": "dffnet", "b128": "dffnet", "e2e": "e2e"}
HEADLINE_RESULTS = ("b1_stacks_per_sec", "b4_stacks_per_sec", "b128_stacks_per_sec",
                    "train_b32_stacks_per_sec", "train_b128_remat_stacks_per_sec",
                    "e2e_ms_per_stack", "simulator_scenes_per_sec")


def phase_headline(torch, smi) -> dict:
    """The port's headline benchmark (``dffx_torch/headline.py``) as a child
    process: exit 0; every stdout line JSON and the last one complete, with
    every point and section, a value, the kernel gate passed and no error;
    per point (stderr) the launches of each kernel exactly its forwards times
    a forward's, and none in the train steps and the simulator.  Returns the
    launches of each kernel over its points."""
    torch.cuda.empty_cache()  # this process's cached blocks: the child needs the card
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dffx_torch.headline",
                           "--budget", str(HEADLINE_BUDGET)], cwd=ROOT, capture_output=True,
                          text=True, timeout=HEADLINE_TIMEOUT)
    seconds = time.perf_counter() - t0
    details = [json.loads(ln) for ln in proc.stderr.splitlines() if ln.startswith('{"detail"')]
    try:
        records = [json.loads(ln) for ln in proc.stdout.splitlines()]
    except json.JSONDecodeError as e:
        records = [{"not_json": str(e)}]
    last = records[-1] if records else {}
    emit({"phase": "headline", "device": smi, "rc": proc.returncode, "seconds": seconds,
          "budget": HEADLINE_BUDGET, "stdout_lines": len(records), "record": last,
          "details": details, "stderr_tail": proc.stderr[-3000:] if proc.returncode else ""})
    check(proc.returncode == 0, f"headline: exit {proc.returncode}")
    check(all("not_json" not in r for r in records), "headline: a stdout line is not JSON")
    check(not last.get("partial") and last.get("platform") == "gpu",
          "headline: the last line is not a complete record")
    missing = [k for k in HEADLINE_RESULTS if k not in last]
    check(not missing and last["value"] > 0, f"headline: value {last.get('value')}, "
                                             f"missing {missing}")
    check(last.get("kernel_gate") == "pass", f"headline: kernel gate {last.get('kernel_gate')}")
    check(not [k for k in last if k.endswith("_error")] and "skipped_sections" not in last,
          "headline: a section failed or was skipped")
    by_name = {d["detail"]: d for d in details}
    launches = dict.fromkeys(KERNELS, 0)
    for point, network in HEADLINE_FORWARDS.items():
        d = by_name[point]
        check_launches(d["launches"], want_launches(network, d["dtype"], d["forwards"]),
                       f"headline {point}")
        for k in KERNELS:
            launches[k] += d["launches"][k]
    for point in ("train_b128_remat", "train_b32", "simulator"):
        check_launches(by_name[point]["launches"], {}, f"headline {point}")
    check(sum(d["detail"] == "section" for d in details) == len(HEADLINE_SECTIONS),
          "headline: not every section ran")
    return launches


def golden_inputs(np):
    """tests/test_golden_regression.py's inputs (seed 7 params, rng 42)."""
    rng = np.random.default_rng(42)
    fs = rng.uniform(-1, 1, (1, 10, 64, 96, 3)).astype(np.float32)
    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    return fs, fd


def main() -> int:
    import numpy as np
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from dffx_torch.eval import TimedForward, load_params_auto
    from dffx_torch.models.packed import PACKED_DEFAULT
    from dffx_torch.ops import _build
    from dffx_torch.ops import kernels as tk

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "tf32": "off for cuDNN convs and matmuls (fp32 numerics phases)"})

    # 2. build
    lib_path, seconds, log = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "library": lib_path.name, "ptxas": ptxas})

    # 3. each kernel against its twin on the card
    path_rows = phase_kernels(torch, tk, dev)
    path_rows["bn_act"] = bn_act_rows(torch, tk, dev)

    # 4. DFFNet: goldens through the GPU forward, kernels included; on the
    # default graph, and through the packed one whatever the default
    fs_np, fd_np = golden_inputs(np)
    gold = np.load(ROOT / "tests" / "goldens" / "forward_v1.npz")
    golden_graphs = sorted({PACKED_DEFAULT, True})
    for packed in golden_graphs:
        net = load_params_auto(7, device=dev, packed=packed)
        tk.reset_launches()
        with torch.inference_mode():
            mid, _, _, pred3 = net(torch.from_numpy(fs_np).to(dev),
                                   torch.from_numpy(fd_np).to(dev))
        torch.cuda.synchronize()
        errs = {"mid": float(np.abs(mid.cpu().numpy() - gold["mid"]).max()),
                "pred3": float(np.abs(pred3.cpu().numpy() - gold["pred3"]).max())}
        emit({"phase": "goldens", "packed": packed, "max_abs_err": errs, "atol": GOLDEN_ATOL,
              "launches": dict(tk.launches)})
        check(max(errs.values()) <= GOLDEN_ATOL, f"goldens packed={packed}: {errs}")
        check_launches(tk.launches, DFFNET_LAUNCHES, "goldens")

    # 5. DFFNet at the bench shape, fp32 and bf16, against the CPU twins
    net = load_params_auto(0, device=dev)
    other = load_params_auto(0, device=dev, packed=not PACKED_DEFAULT)
    rng = np.random.default_rng(1)
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, N, H, W, 3)).astype(np.float32))
    fd = torch.from_numpy((1 / np.linspace(0.2, 3.0, N, dtype=np.float32))[None])
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tk.reset_launches()
        with torch.inference_mode():
            o = net(fs.to(dev, dtype), fd.to(dev))
        torch.cuda.synchronize()
        check_launches(tk.launches, want_launches("dffnet", dtype), f"forward {dtype}")
        check_depth(torch, o, fd, dtype, (1, H, W), "forward", [1, N, H, W], dict(tk.launches))
        outs[dtype] = [t.float().cpu() for t in o]
    cpu_net = load_params_auto(0, device="cpu")
    with torch.inference_mode():
        cpu_outs = cpu_net(fs, fd)
    heads = ["mid", "pred1", "pred2", "pred3"]
    cpu_err = max_errs(heads, outs[torch.float32], cpu_outs)
    bf16_err = max_errs(heads, outs[torch.bfloat16], outs[torch.float32])
    bf16_rel = bf16_gaps(heads, outs[torch.bfloat16], outs[torch.float32])
    emit({"phase": "forward_vs_cpu", "packed": PACKED_DEFAULT, "fp32_max_abs_err": cpu_err,
          "atol": FP32_ATOL, "bf16_vs_fp32_max_abs_err": bf16_err,
          "bf16_vs_fp32_rel": bf16_rel, "bf16_rtol": BF16_RTOL})
    check(max(cpu_err.values()) <= FP32_ATOL, f"GPU vs CPU forward: {cpu_err}")
    check_bf16_gaps("forward_vs_cpu", bf16_rel, BF16_RTOL)
    packed_vs_plain(torch, tk, net, other, (fs.to(dev), fd.to(dev)), heads, outs,
                    "dffnet", [1, N, H, W])

    # 6. DFFNet serving through TimedForward; counts from this run only.  The
    # default graph at full depth, then the other graph for fewer requests.
    for model, depth in ((net, ((1, 10), (4, 5))), (other, ((1, 4), (4, 2)))):
        tk.reset_launches()
        want = []
        for dtype in (torch.float32, torch.bfloat16):
            for batch, requests in depth:
                reqs = [(rng.uniform(-1, 1, (batch, N, H, W, 3)).astype(np.float32),
                         np.tile(fd.numpy(), (batch, 1))) for _ in range(requests + 2)]
                forwards = serve(torch, TimedForward(model, dtype=dtype), reqs, smi, "serving")
                want.append(want_launches("dffnet", dtype, forwards))
        check_launches(tk.launches, add_launches(*want), "serving")
    del other

    # 7. end-to-end: goldens (seed 7, tests/test_golden_regression.py's fovs)
    fovs_np = np.linspace(1.0, 1.02, 10, dtype=np.float32)[None]
    for packed in golden_graphs:
        e2e = load_params_auto(7, device=dev, packed=packed, arch="e2e")
        tk.reset_launches()
        with torch.inference_mode():
            o = e2e(*(torch.from_numpy(a).to(dev) for a in (fs_np, fd_np, fovs_np)))
        torch.cuda.synchronize()
        errs = {"e2e_pred3": float(np.abs(o[3].cpu().numpy() - gold["e2e_pred3"]).max()),
                "e2e_warped_sum": float(np.abs(o[4].sum(dim=(2, 3)).cpu().numpy()
                                               - gold["e2e_warped_sum"]).max())}
        emit({"phase": "e2e_goldens", "packed": packed, "max_abs_err": errs,
              "atol": {"e2e_pred3": GOLDEN_ATOL, "e2e_warped_sum": WARPED_SUM_ATOL},
              "launches": dict(tk.launches)})
        check(errs["e2e_pred3"] <= GOLDEN_ATOL and errs["e2e_warped_sum"] <= WARPED_SUM_ATOL,
              f"e2e goldens packed={packed}: {errs}")
        check_launches(tk.launches, E2E_LAUNCHES, "e2e goldens")

    # 8. end-to-end forward against the CPU at a medium shape; bf16 against fp32
    e2e = load_params_auto(0, device=dev, arch="e2e")
    other = load_params_auto(0, device=dev, packed=not PACKED_DEFAULT, arch="e2e")
    cpu_e2e = load_params_auto(0, device="cpu", arch="e2e")
    fd10 = torch.from_numpy((1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None])
    fovs = torch.from_numpy((1.0 + np.linspace(0.0, 0.03, 10)
                             + rng.uniform(-0.005, 0.005, 10)).astype(np.float32)[None])
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, MH, MW, 3)).astype(np.float32))
    names = ["mid", "pred1", "pred2", "pred3", "warped", "motion"]
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tk.reset_launches()
        with torch.inference_mode():
            o = e2e(fs.to(dev, dtype), fd10.to(dev), fovs.to(dev))
            motion = e2e.optical_flow_aggregation(fs.to(dev, dtype), fovs.to(dev))[1]
        torch.cuda.synchronize()
        check_launches(tk.launches, add_launches(want_launches("e2e", dtype),
                                                 want_launches("flownet", dtype)), f"e2e {dtype}")
        check_depth(torch, o[:4], fd10, dtype, (1, MH, MW), "e2e_forward", [1, 10, MH, MW],
                    dict(tk.launches))
        outs[dtype] = [t.float().cpu() for t in (*o, motion)]
    with torch.inference_mode():
        cpu_o = cpu_e2e(fs, fd10, fovs)
        cpu_motion = cpu_e2e.optical_flow_aggregation(fs, fovs)[1]
    cpu_err = max_errs(names, outs[torch.float32], (*cpu_o, cpu_motion))
    bf16_err = max_errs(names, outs[torch.bfloat16], outs[torch.float32])
    bf16_rel = bf16_gaps(names, outs[torch.bfloat16], outs[torch.float32])
    emit({"phase": "e2e_forward_vs_cpu", "packed": PACKED_DEFAULT, "shape": [1, 10, MH, MW],
          "fp32_max_abs_err": cpu_err,
          "atol": FP32_ATOL, "bf16_vs_fp32_max_abs_err": bf16_err,
          "bf16_vs_fp32_rel": bf16_rel, "bf16_rtol": BF16_RTOL,
          "motion_abs_max_fp32": outs[torch.float32][5].abs().amax(dim=(0, 1)).tolist()})
    check(max(cpu_err.values()) <= FP32_ATOL, f"e2e GPU vs CPU forward: {cpu_err}")
    check_bf16_gaps("e2e_forward_vs_cpu", bf16_rel, BF16_RTOL)
    packed_vs_plain(torch, tk, e2e, other, (fs.to(dev), fd10.to(dev), fovs.to(dev)),
                    names[:5], {k: v[:5] for k, v in outs.items()}, "e2e",
                    [1, 10, MH, MW])

    # 9. end-to-end serving at the real-scene shape; counts from this run only.
    # The other graph first, for fewer requests; then the default graph, whose
    # counts go into the kernels line.
    for model, requests in ((other, 2), (e2e, 5)):
        tk.reset_launches()
        want = []
        for dtype in (torch.float32, torch.bfloat16):
            reqs = [(rng.uniform(-1, 1, (1, 10, EH, EW, 3)).astype(np.float32), fd10.numpy(),
                     fovs.numpy()) for _ in range(requests + 2)]
            forwards = serve(torch, TimedForward(model, dtype=dtype), reqs, smi, "e2e_serving")
            want.append(want_launches("e2e", dtype, forwards))
        served = dict(tk.launches)
        check_launches(served, add_launches(*want), "e2e serving")

    # 10. DDFFNet served at DDFF-12's padded shape, b1, fp32 then bf16, each
    # with every count at 0 just before it: bf16 applies its 25 eval BNs
    # through bn_act, and no forward launches any of the five kernels
    ddff = load_params_auto(0, device=dev, arch="ddffnet")
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, H, DW, 3)).astype(np.float32))
    preds, launched = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tk.reset_launches()
        pred, maps = TimedForward(ddff, dtype=dtype)(fs, fd10)
        torch.cuda.synchronize()
        launched[str(dtype)] = dict(tk.launches)
        check_launches(tk.launches, want_launches("ddffnet", dtype), f"ddffnet {dtype}")
        check(bool(pred.isfinite().all() and maps.isfinite().all()), f"ddffnet {dtype}: finite")
        preds[dtype] = pred.double()
    gap = ((preds[torch.bfloat16] - preds[torch.float32]).square().mean().sqrt()
           / preds[torch.float32].square().mean().sqrt()).item()
    emit({"phase": "ddffnet_serving", "shape": [1, 10, H, DW], "launches": launched,
          "bf16_vs_fp32_pred_rms": gap})
    del ddff, preds

    # 11. training: no kernel launches in any train step
    train_launches = phase_train(torch, np, tk, dev, smi)
    library = fm_conv_library(torch, tk, dev)
    emit({"phase": "fm_conv_library", **library})

    # 12. the command lines, each run with every count at 0 just before it
    emit({"phase": "host_gaps", "not_run_on_card": [
        {"package": pkg, "missing": True, "instead": what} for pkg, what in HOST_GAPS.items()]})
    phase_host_decode(np, smi)
    cli_runs = {"eval_cli": phase_eval_cli(torch, np, tk, dev, smi),
                "real_scenes_cli": phase_real_scenes_cli(torch, np, tk, dev, smi),
                "train_cli_validation": phase_train_cli(torch, np, tk, dev, smi)}

    # 13. the simulator's command line, its output through the reader and the
    # E2E trainer, then the front door; no kernel of the port on either path
    phase_simulate(torch, np, tk, dev, smi)
    phase_front_door(kind, smi)

    # 14. several processes on the card, each path with every count at 0 just
    # before it and read just after: data-parallel steps (no kernel), the
    # train command line as two ranks, and spatial serving (all five kernels
    # on each rank's rows)
    dp_launches = phase_dp_train(torch, np, tk, dev, smi)
    cli_runs["dp_train_cli_validation"] = phase_dp_train_cli(torch, np, tk, dev, smi)
    spatial = phase_spatial(torch, np, tk, dev, smi)

    # 15. the headline benchmark (dffx_torch/headline.py) in a process of its
    # own, each point's counts at 0 just before it and read just after
    headline = phase_headline(torch, smi)

    emit({"phase": "time", "build_seconds": seconds,
          "run_seconds": time.perf_counter() - t_start, "limit_seconds": 1200})
    emit({"kernels": [kernel_entry(name, path_rows[name], served[name],
                                   train_launches + dp_launches,
                                   {path: got[name] for path, got in cli_runs.items()},
                                   library if name == "fm_conv_bn_relu" else None,
                                   spatial[name], headline[name])
                      for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-cli-child"]:
        sys.exit(train_cli_child(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2]))
    sys.exit(main())
