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

Both run the default graph (``dffx_torch.models.packed.PACKED_DEFAULT``:
DFFNet's EFDs and full-resolution stage packed space-to-depth, or not).  The
packed graph is held against the unpacked one on the card
(``packed_vs_plain``), goes through the goldens whatever the default, and the
graph that is not the default is served for fewer requests, so that both rates
stand in the output.  The kernels a forward launches are the same either way.

Each path's serving run starts with every launch count at 0 and checks the
counts just after it.  Every phase prints one JSON line and raises on
failure.  The second-to-last line lists each kernel with its launches in the
end-to-end serving run, its error against its twin, both times and the bound
at the end-to-end path's shapes (rb_of_chain: the sum over its three pyramid
levels, and each level under ``levels``); the line before it gives the build's
and the whole run's seconds; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository around it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def kernel_entry(name: str, rows: list, launches: int) -> dict:
    """One kernel of the result line: its fp32 rows at the end-to-end path's
    shapes summed; a kernel with several (rb_of_chain's three pyramid levels)
    also lists each under ``levels``.  ``bound_by``: what sets the largest
    row's bound.  ``library_ms`` is null: no single PyTorch call computes the
    function (see ``bound_ms``)."""
    entry = {"name": name, "route": "cuda", "source": REPLACES[name][0],
             "replaces": REPLACES[name][1], "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
             "bound_ms": sum(r["bound_ms"] for r in rows),
             "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
             "library_ms": None}
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
    sys.path.insert(0, str(ROOT))
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

    emit({"phase": "time", "build_seconds": seconds,
          "run_seconds": time.perf_counter() - t_start, "limit_seconds": 1200})
    emit({"kernels": [kernel_entry(name, path_rows[name], served[name]) for name in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
