#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dffx_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Builds the five CUDA kernels from dffx_torch/csrc and holds each against its
plain PyTorch twin on the card, in fp32 and bf16, at the shapes its paths
give it, at ragged and tiny ones, at a batch of many tiles and at more than
65,535 slices, each row with the least time the card could take for the same
work (``bound_ms``).  Then it drives two paths:

* DFFNet (depth only): the goldens, the forward against the same model on
  the CPU, and serving synthetic 10 x 384 x 384 stacks through
  ``TimedForward`` at batch 1 and 4 in fp32 and bf16;
* the end-to-end network (FlowNetwork alignment + DFFNet): the goldens, the
  forward against the CPU at 10 x 192 x 320, bf16 against fp32, and serving
  synthetic 10 x 608 x 1088 stacks (the real-scene shape) at batch 1 in fp32
  and bf16.

Then it trains (``dffx_torch.train``): one step of DFFNet and of the
end-to-end network on the card against the same step on the CPU, remat
against plain on the card, bf16 against fp32, then 2 warm-up and 5 timed steps
at the recipes' size (batch 4 of 10 x 224 x 224 stacks) for DFFNet in fp32
and bf16, plain and remat, and the end-to-end network in fp32 and bf16, with
no kernel launch in any train step; the trained weights in eval mode against
the CPU, and a train-state checkpoint round trip.

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
  against a direct ``E2ENetwork`` forward;
* ``train_cli``: ``python -m dffx_torch.train.cli --recipe DDFF`` at batch 4
  (224 x 224 crops), validating 2 full-size stacks, each run in a process of
  its own, without and with ``cudnn.benchmark``; the resume from
  ``models/1.ckpt`` and the validation against the CPU.

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
end-to-end serving run (as ``train_launches``, in all train steps: 0, and
as ``cli_launches``, in each command line's run),
its error against its twin, both times and the bound at the end-to-end path's
shapes (rb_of_chain: the sum over its three pyramid levels, and each level
under ``levels``), and for ``fm_conv_bn_relu`` the time of the one PyTorch call
that computes its function (``torch.cudnn_convolution_relu`` on the BN-folded
weight and shift); the line before it gives the build's
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
#: TPU kernels the CUDA kernels replace (dffx/ops/pallas_kernels.py pallas_call sites)
REPLACES = {
    "fm_conv_bn_relu": ("dffx_torch/csrc/fm_conv.cu", "dffx/ops/pallas_kernels.py:144"),
    "rb2d_residual": ("dffx_torch/csrc/rb2d.cu", "dffx/ops/pallas_kernels.py:329"),
    "srd_attention_residual": ("dffx_torch/csrc/srd_attention.cu",
                               "dffx/ops/pallas_kernels.py:823"),
    "rb_of_chain": ("dffx_torch/csrc/rb_of.cu", "dffx/ops/pallas_kernels.py:726"),
    "motion_head_conv_chain": ("dffx_torch/csrc/motion_head.cu",
                               "dffx/ops/pallas_kernels.py:508"),
}
#: Published peaks of one H100 SXM at its full power limit (NVIDIA's data sheet):
#: HBM bytes/s and dense TF32 FLOP/s.  The kernels' functions are fp32 convs; on
#: the tensor cores an fp32-accurate product costs three TF32 products (3xTF32:
#: hi.hi + hi.lo + lo.hi of the operands' two TF32 parts).  A bf16 activation is
#: a TF32 already and has no low part: a product of it with an fp32 weight costs
#: two.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12


def _conv_flop(w) -> int:
    """FLOP per output pixel of a conv with weight (Cout, Cin, kd, kh, kw)."""
    return 2 * w.numel()


#: per kernel, from its arguments: (FLOP per pixel of the convs that read the
#: input x, FLOP per pixel of the convs that read an fp32 intermediate, channels
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
    dtype) over the HBM rate and its operations over the TF32 rate, three TF32
    products for one of fp32 values and two where the activation is a bf16
    input.  No single PyTorch call computes any of the five functions (each is
    a fused chain of convs, BN and ReLU), so no row has a library time."""
    import torch

    flop_in, flop_mid, chans_px = WORK[name](x, *args)
    pixels = x.numel() // x.shape[1]
    by_bytes = pixels * chans_px * x.element_size() / HBM_BYTES_PER_S * 1e3
    tf32_flop = (2 if x.dtype == torch.bfloat16 else 3) * flop_in + 3 * flop_mid
    by_ops = pixels * tf32_flop / TF32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


#: the function that packs a kernel's weights into the one buffer it reads, for
#: the kernels whose modules keep that buffer between forwards (tk.ParamCache)
PACKERS = {"fm_conv_bn_relu": "fm_conv_params", "rb2d_residual": "rb2d_params",
           "rb_of_chain": "rb_of_chain_params", "motion_head_conv_chain": "motion_head_params"}

#: launches of each kernel in one forward of each network
DFFNET_LAUNCHES = {"fm_conv_bn_relu": 1, "rb2d_residual": 1, "srd_attention_residual": 1}
FLOWNET_LAUNCHES = {"rb_of_chain": 3, "motion_head_conv_chain": 1}
E2E_LAUNCHES = {**DFFNET_LAUNCHES, **FLOWNET_LAUNCHES}


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
    # the attention walks N inside a thread and has B in its block index
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
    fp32 rows at the end-to-end path's shapes.  The compared call packs the
    weights itself; the timed calls get them packed from a ``ParamCache``, as
    the modules call the wrappers."""
    import numpy as np

    rng = np.random.default_rng(0)
    path = {name: [] for name in REPLACES}
    for name, tag, args in kernel_cases(rng, torch, tk, dev):
        kernel, twin = getattr(tk, name), getattr(tk, f"{name}_ref")
        for dtype in (torch.float32, torch.bfloat16):
            x = args[0].to(dtype)
            kargs = (x, *args[1:])
            got = kernel(*kargs)
            torch.cuda.synchronize()
            ref = twin(x.float(), *args[1:])  # fp32 twin on the same rounded inputs
            err = (got.float() - ref).abs().max().item()
            if dtype == torch.float32:
                bound = FP32_ATOL
            else:
                # the kernel keeps every sum and intermediate in fp32 and rounds
                # only its output to bf16: at most half an ulp, which is below
                # 2^-8 of the largest |value|; 1e-4 covers fp32 summation order
                bound = 2.0 ** -8 * ref.abs().max().item() + FP32_ATOL
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
            if tag.startswith("e2e") and dtype == torch.float32:
                path[name].append(row)
    return path


def fm_conv_library(torch, tk, dev) -> dict:
    """``torch.cudnn_convolution_relu`` on the BN-folded weight and shift: the
    one PyTorch call that computes ``fm_conv_bn_relu``'s function, at the
    end-to-end shape in fp32, against the twin; or the error the call gives."""
    import numpy as np

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, N, EH, EW)).astype("float32")).to(dev)
    w = torch.from_numpy((rng.standard_normal((8, 3, 1, 9, 9)) * 0.1).astype("float32")).to(dev)
    g, b, mu, va = (torch.from_numpy(a.astype("float32")).to(dev) for a in (
        rng.standard_normal(8), rng.standard_normal(8), rng.standard_normal(8) * 0.1,
        rng.random(8) + 0.5))
    scale, shift = tk.bn_fused_affine(g, b, mu, va)
    w_folded = (w * scale.view(-1, 1, 1, 1, 1)).contiguous()

    def call():
        return torch.cudnn_convolution_relu(x, w_folded, shift, (1, 1, 1), (0, 8, 8),
                                            (1, 2, 2), 1)

    try:
        got = call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return {"call": "torch.cudnn_convolution_relu", "error": str(e).splitlines()[0],
                "library_ms": None}
    err = (got - tk.fm_conv_bn_relu_ref(x, w, scale, shift)).abs().max().item()
    return {"call": "torch.cudnn_convolution_relu", "max_abs_err": err,
            "library_ms": median_ms(call)}


def kernel_entry(name: str, rows: list, launches: int, train_launches: int,
                 cli_launches: dict, library: dict | None = None) -> dict:
    """One kernel of the result line: its fp32 rows at the end-to-end path's
    shapes summed; a kernel with several (rb_of_chain's three pyramid levels)
    also lists each under ``levels``.  ``launches``: in the end-to-end serving
    run; ``train_launches``: in every train step; ``cli_launches``: in each
    command line's measured run (``train_cli``: its validation forwards).  ``bound_by``: what sets the largest
    row's bound.  ``library_ms``: ``library``'s time where one PyTorch call
    computes the function (``fm_conv_library``), else null (see
    ``bound_ms``)."""
    entry = {"name": name, "route": "cuda", "source": REPLACES[name][0],
             "replaces": REPLACES[name][1], "launches": launches,
             "train_launches": train_launches, "cli_launches": cli_launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
             "bound_ms": sum(r["bound_ms"] for r in rows),
             "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
             "library_ms": None if library is None else library["library_ms"]}
    if library is not None:
        entry["library"] = library
    entry["ms_over_bound"] = entry["ms"] / entry["bound_ms"]
    if len(rows) > 1:
        entry["levels"] = {r["shape"].removeprefix("e2e_"): {
            k: r[k] for k in ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")}
            for r in rows}
    return entry


def check_launches(got: dict, want: dict, what: str) -> None:
    """Exactly ``want`` launches of each kernel, 0 of every other."""
    full = {name: want.get(name, 0) for name in REPLACES}
    check(dict(got) == full, f"{what}: launches {dict(got)} != {full}")


def max_errs(names, got, ref) -> dict:
    return {n: float((g.float().cpu() - r.float().cpu()).abs().max())
            for n, g, r in zip(names, got, ref)}


def check_depth(torch, outs, fd, dtype, shape, phase, stack, launches) -> None:
    """Finite depth heads of the expected shape, pred3 within the focus range."""
    p3 = outs[3].float()
    slack = (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6) * float(fd.max())
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    in_range = bool((p3 >= fd.min() - slack).all() and (p3 <= fd.max() + slack).all())
    emit({"phase": phase, "dtype": str(dtype).split(".")[1], "shape": stack,
          "launches": launches, "finite": finite, "pred3_in_fd_range": in_range,
          "pred3_min": float(p3.min()), "pred3_max": float(p3.max())})
    check(finite and in_range, f"{phase} {dtype}: finite={finite} in_range={in_range}")
    check(all(tuple(t.shape) == shape for t in outs), f"{phase} output shapes")


def packed_vs_plain(torch, tk, net, other, args, names, default_outs, launches, shape) -> None:
    """The packed graph against the unpacked one on the card, same weights and
    inputs: fp32 within ``FP32_ATOL`` on every output, bf16 reported.  ``net``
    runs the default graph and ``default_outs`` holds its outputs per dtype
    (on the CPU); ``other`` runs the other graph here."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tk.reset_launches()
        with torch.inference_mode():
            o = other(args[0].to(dtype), *args[1:])
        torch.cuda.synchronize()
        check_launches(tk.launches, launches, f"packed_vs_plain {dtype}")
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


def train_batch(np, rng, b, n, h, w, e2e: bool) -> dict:
    """A synthetic batch as the train step takes it (numpy): stacks in
    [-1, 1], depth in the focus range, 80 % of the pixels valid."""
    batch = {"fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
             "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32),
             "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32), (b, 1)),
             "mask": rng.random((b, h, w)) > 0.2}
    if e2e:
        batch["fovs"] = (1.0 + np.linspace(0.0, 0.03, n)
                         + rng.uniform(-0.005, 0.005, (b, n))).astype(np.float32)
    return batch


def on(torch, batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def new_train_state(torch, seed: int, e2e: bool, dev):
    from dffx_torch.checkpoint import load_jax_params
    from dffx_torch.models import E2ENetwork, Network, e2e_init_params, init_params
    from dffx_torch.train import create_train_state

    net = E2ENetwork() if e2e else Network()
    load_jax_params(net, (e2e_init_params if e2e else init_params)(seed))
    return create_train_state(net.to(dev), TRAIN_LR)


def grads_of(state) -> dict:
    return {k: p.grad.float().cpu() for k, p in state.model.named_parameters()}


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
    rows = [(e.key, e.self_device_time_total / 1e6) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
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
            check_launches(tk.launches, {k: v * forwards for k, v in DFFNET_LAUNCHES.items()},
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
    from dffx_torch.data import RealScenesDataset
    from dffx_torch.eval import load_params_auto
    from dffx_torch.eval import real_scenes as cli
    from torch_fixtures import recording_forwards, run_cli

    with tempfile.TemporaryDirectory() as tmp:
        write_scene(np, Path(tmp) / "scenes")
        jpegs = []
        with stand_ins({}, jpegs), recording_forwards(cli) as kept:
            tk.reset_launches()
            out = run_cli(cli.main, ["--data-root", f"{tmp}/scenes", "--out", f"{tmp}/out/",
                                     "--allow-random-init"])
            torch.cuda.synchronize()
            launched = dict(tk.launches)
        pngs = sorted(p.name for p in (Path(tmp) / "out" / "warped_result" / "0").iterdir())
        sample = RealScenesDataset(f"{tmp}/scenes")[0]
    check_launches(launched, E2E_LAUNCHES, "real_scenes_cli")
    net = load_params_auto(0, device=dev, e2e=True)
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
          "avg_time_s": printed(out, "AVG_time"), "launches": launched,
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


def train_cli_argv(data_root: str, root: str) -> list:
    return ["--recipe", "DDFF", "--lr", "1e-4", "--saveroot", root, "--batch_size", "4",
            "--cpus", "8", "--max_epoch", "1", "--steps-per-epoch", str(TRAIN_STEPS),
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
    argv = train_cli_argv(spec["data_root"], spec["root"])
    argv += ["--load_epoch", "-1"] if spec["resume"] else []
    h5 = str(Path(spec["data_root"]) / "DDFF" / "ddff-dataset-trainval.h5")
    tk.reset_launches()
    with stand_ins({h5: train_cli_data(np)}, []), recording_train(cli) as ran:
        out = run_cli(cli.main, argv)
    torch.cuda.synchronize()
    torch.save({"out": out, "launches": dict(tk.launches), "losses": ran["losses"],
                "step_seconds": ran["step_seconds"], "val_seconds": ran["val_seconds"],
                "val_pred3": ran["val_pred3"], "step": ran["state"].step, "snapshot": snapshot},
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
        check_launches(tk.launches, DFFNET_LAUNCHES, f"forward {dtype}")
        check_depth(torch, o, fd, dtype, (1, H, W), "forward", [1, N, H, W], dict(tk.launches))
        outs[dtype] = [t.float().cpu() for t in o]
    cpu_net = load_params_auto(0, device="cpu")
    with torch.inference_mode():
        cpu_outs = cpu_net(fs, fd)
    heads = ["mid", "pred1", "pred2", "pred3"]
    cpu_err = max_errs(heads, outs[torch.float32], cpu_outs)
    bf16_err = max_errs(heads, outs[torch.bfloat16], outs[torch.float32])
    emit({"phase": "forward_vs_cpu", "packed": PACKED_DEFAULT, "fp32_max_abs_err": cpu_err,
          "atol": FP32_ATOL, "bf16_vs_fp32_max_abs_err": bf16_err})
    check(max(cpu_err.values()) <= FP32_ATOL, f"GPU vs CPU forward: {cpu_err}")
    packed_vs_plain(torch, tk, net, other, (fs.to(dev), fd.to(dev)), heads, outs,
                    DFFNET_LAUNCHES, [1, N, H, W])

    # 6. DFFNet serving through TimedForward; counts from this run only.  The
    # default graph at full depth, then the other graph for fewer requests.
    for model, depth in ((net, ((1, 10), (4, 5))), (other, ((1, 4), (4, 2)))):
        tk.reset_launches()
        forwards = 0
        for dtype in (torch.float32, torch.bfloat16):
            for batch, requests in depth:
                reqs = [(rng.uniform(-1, 1, (batch, N, H, W, 3)).astype(np.float32),
                         np.tile(fd.numpy(), (batch, 1))) for _ in range(requests + 2)]
                forwards += serve(torch, TimedForward(model, dtype=dtype), reqs, smi, "serving")
        check_launches(tk.launches, {k: v * forwards for k, v in DFFNET_LAUNCHES.items()},
                       "serving")
    del other

    # 7. end-to-end: goldens (seed 7, tests/test_golden_regression.py's fovs)
    fovs_np = np.linspace(1.0, 1.02, 10, dtype=np.float32)[None]
    for packed in golden_graphs:
        e2e = load_params_auto(7, device=dev, e2e=True, packed=packed)
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
    e2e = load_params_auto(0, device=dev, e2e=True)
    other = load_params_auto(0, device=dev, e2e=True, packed=not PACKED_DEFAULT)
    cpu_e2e = load_params_auto(0, device="cpu", e2e=True)
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
        check_launches(tk.launches, {k: v + FLOWNET_LAUNCHES.get(k, 0)
                                     for k, v in E2E_LAUNCHES.items()}, f"e2e {dtype}")
        check_depth(torch, o[:4], fd10, dtype, (1, MH, MW), "e2e_forward", [1, 10, MH, MW],
                    dict(tk.launches))
        outs[dtype] = [t.float().cpu() for t in (*o, motion)]
    with torch.inference_mode():
        cpu_o = cpu_e2e(fs, fd10, fovs)
        cpu_motion = cpu_e2e.optical_flow_aggregation(fs, fovs)[1]
    cpu_err = max_errs(names, outs[torch.float32], (*cpu_o, cpu_motion))
    bf16_err = max_errs(names, outs[torch.bfloat16], outs[torch.float32])
    emit({"phase": "e2e_forward_vs_cpu", "packed": PACKED_DEFAULT, "shape": [1, 10, MH, MW],
          "fp32_max_abs_err": cpu_err,
          "atol": FP32_ATOL, "bf16_vs_fp32_max_abs_err": bf16_err,
          "motion_abs_max_fp32": outs[torch.float32][5].abs().amax(dim=(0, 1)).tolist()})
    check(max(cpu_err.values()) <= FP32_ATOL, f"e2e GPU vs CPU forward: {cpu_err}")
    packed_vs_plain(torch, tk, e2e, other, (fs.to(dev), fd10.to(dev), fovs.to(dev)),
                    names[:5], {k: v[:5] for k, v in outs.items()}, E2E_LAUNCHES,
                    [1, 10, MH, MW])

    # 9. end-to-end serving at the real-scene shape; counts from this run only.
    # The other graph first, for fewer requests; then the default graph, whose
    # counts go into the kernels line.
    for model, requests in ((other, 2), (e2e, 5)):
        tk.reset_launches()
        forwards = 0
        for dtype in (torch.float32, torch.bfloat16):
            reqs = [(rng.uniform(-1, 1, (1, 10, EH, EW, 3)).astype(np.float32), fd10.numpy(),
                     fovs.numpy()) for _ in range(requests + 2)]
            forwards += serve(torch, TimedForward(model, dtype=dtype), reqs, smi, "e2e_serving")
        served = dict(tk.launches)
        check_launches(served, {k: v * forwards for k, v in E2E_LAUNCHES.items()},
                       "e2e serving")

    # 10. training: no kernel launches in any train step
    train_launches = phase_train(torch, np, tk, dev, smi)
    library = fm_conv_library(torch, tk, dev)
    emit({"phase": "fm_conv_library", **library})

    # 11. the command lines, each run with every count at 0 just before it
    emit({"phase": "host_gaps", "not_run_on_card": [
        {"package": pkg, "missing": True, "instead": what} for pkg, what in HOST_GAPS.items()]})
    cli_runs = {"eval_cli": phase_eval_cli(torch, np, tk, dev, smi),
                "real_scenes_cli": phase_real_scenes_cli(torch, np, tk, dev, smi),
                "train_cli_validation": phase_train_cli(torch, np, tk, dev, smi)}

    emit({"phase": "time", "build_seconds": seconds,
          "run_seconds": time.perf_counter() - t_start, "limit_seconds": 1200})
    emit({"kernels": [kernel_entry(name, path_rows[name], served[name], train_launches,
                                   {path: got[name] for path, got in cli_runs.items()},
                                   library if name == "fm_conv_bn_relu" else None)
                      for name in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-cli-child"]:
        sys.exit(train_cli_child(sys.argv[2]))
    sys.exit(main())
