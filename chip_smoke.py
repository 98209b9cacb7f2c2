#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dffx_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Builds the three CUDA kernels of DFFNet's eval path from dffx_torch/csrc,
holds each against its plain PyTorch twin on the card, checks the forward
against the stored goldens and against the same model on the CPU, and serves
synthetic 10 x 384 x 384 focal stacks through ``TimedForward`` at batch 1
and 4 in fp32 and bf16.  Every phase prints one JSON line and raises on
failure.  The second-to-last line lists each kernel with its launches in the
serving run, its error against its twin and both times; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, H, W = 10, 384, 384  # the bench shape: DDFF-12-sized 10-slice stacks
FP32_ATOL = 1e-4
GOLDEN_ATOL = 2e-4
REPS = 25  # timed launches per kernel and per twin (median reported)
#: TPU kernels the CUDA kernels replace (dffx/ops/pallas_kernels.py pallas_call sites)
REPLACES = {
    "fm_conv_bn_relu": ("dffx_torch/csrc/fm_conv.cu", "dffx/ops/pallas_kernels.py:144"),
    "rb2d_residual": ("dffx_torch/csrc/rb2d.cu", "dffx/ops/pallas_kernels.py:329"),
    "srd_attention_residual": ("dffx_torch/csrc/srd_attention.cu",
                               "dffx/ops/pallas_kernels.py:823"),
}


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
    """(kernel name, shape tag, dtype, kernel fn, twin fn on fp32 inputs, args)."""
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
    for tag, (b, n, h, w) in [("path", path), ("b4", b4), ("ddff", ddff), ("ragged", ragged)]:
        yield "fm_conv_bn_relu", tag, (act((b, 3, n, h, w)), wt((8, 3, 1, 9, 9)), *bn(8))
    rb_shapes = [("path", path, 8), ("b4", b4, 8), ("ddff", ddff, 8), ("ragged", ragged, 8),
                 ("ragged", ragged, 16), ("ragged", ragged, 32)]
    for tag, (b, n, h, w), c in rb_shapes:
        yield "rb2d_residual", f"{tag}_c{c}", (
            act((b, c, n, h, w)), wt((c, c, 1, 3, 3)), bn(c), wt((c, c, 1, 3, 3)), bn(c))
    for tag, (b, n, h, w), c in rb_shapes + [("n1", (1, 1, H, W), 8)]:
        yield "srd_attention_residual", f"{tag}_c{c}", (
            act((b, c, n, h, w)), wt((c, c, 3, 1, 1)), wt((c, c, 1, 1, 1)))


def phase_kernels(torch, tk, dev) -> dict:
    """Each kernel against its twin, fp32 and bf16; returns the path-shape record."""
    import numpy as np

    rng = np.random.default_rng(0)
    path = {}
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
            ms = median_ms(lambda: kernel(*kargs))
            plain_ms = median_ms(lambda: twin(*kargs))
            row = {"phase": "kernel", "kernel": name, "shape": tag, "in": list(x.shape),
                   "dtype": str(dtype).split(".")[1], "max_abs_err": err, "bound": bound,
                   "ms": ms, "plain_ms": plain_ms}
            emit(row)
            check(err <= bound, f"{name} {tag} {dtype}: error {err} > {bound}")
            if tag.startswith("path") and dtype == torch.float32:
                path[name] = row
    return path


def golden_inputs(np):
    """tests/test_golden_regression.py's inputs (seed 7 params, rng 42)."""
    rng = np.random.default_rng(42)
    fs = rng.uniform(-1, 1, (1, 10, 64, 96, 3)).astype(np.float32)
    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    return fs, fd


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dffx_torch.eval import TimedForward, load_params_auto
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

    # 4. goldens through the GPU forward, kernels included
    fs_np, fd_np = golden_inputs(np)
    net = load_params_auto(7, device=dev)
    tk.reset_launches()
    with torch.inference_mode():
        mid, _, _, pred3 = net(torch.from_numpy(fs_np).to(dev), torch.from_numpy(fd_np).to(dev))
    torch.cuda.synchronize()
    gold = np.load(ROOT / "tests" / "goldens" / "forward_v1.npz")
    errs = {"mid": float(np.abs(mid.cpu().numpy() - gold["mid"]).max()),
            "pred3": float(np.abs(pred3.cpu().numpy() - gold["pred3"]).max())}
    emit({"phase": "goldens", "max_abs_err": errs, "atol": GOLDEN_ATOL,
          "launches": dict(tk.launches)})
    check(max(errs.values()) <= GOLDEN_ATOL, f"goldens: {errs}")
    check(all(v == 1 for v in tk.launches.values()), f"goldens launches {tk.launches}")

    # 5. the forward at the bench shape, fp32 and bf16, against the CPU twins
    net = load_params_auto(0, device=dev)
    rng = np.random.default_rng(1)
    fs = torch.from_numpy(rng.uniform(-1, 1, (1, N, H, W, 3)).astype(np.float32))
    fd = torch.from_numpy((1 / np.linspace(0.2, 3.0, N, dtype=np.float32))[None])
    outs = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16), start=1):
        tk.reset_launches()
        with torch.inference_mode():
            o = net(fs.to(dev, dtype), fd.to(dev))
        torch.cuda.synchronize()
        check(all(v == 1 for v in tk.launches.values()), f"{dtype} launches {tk.launches}")
        p3 = o[3].float()
        slack = (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6) * float(fd.max())
        finite = all(bool(torch.isfinite(t).all()) for t in o)
        in_range = bool((p3 >= fd.min() - slack).all() and (p3 <= fd.max() + slack).all())
        emit({"phase": "forward", "dtype": str(dtype).split(".")[1], "shape": [1, N, H, W],
              "launches": dict(tk.launches), "finite": finite, "pred3_in_fd_range": in_range,
              "pred3_min": float(p3.min()), "pred3_max": float(p3.max())})
        check(finite and in_range, f"forward {dtype}: finite={finite} in_range={in_range}")
        check(all(tuple(t.shape) == (1, H, W) for t in o), "forward output shapes")
        outs[dtype] = [t.float().cpu() for t in o]
    cpu_net = load_params_auto(0)
    with torch.inference_mode():
        cpu_outs = cpu_net(fs, fd)
    heads = ["mid", "pred1", "pred2", "pred3"]
    cpu_err = {h: float((g - c).abs().max()) for h, g, c in zip(heads, outs[torch.float32],
                                                                cpu_outs)}
    bf16_err = {h: float((g - c).abs().max()) for h, g, c in zip(heads, outs[torch.bfloat16],
                                                                 outs[torch.float32])}
    emit({"phase": "forward_vs_cpu", "fp32_max_abs_err": cpu_err, "atol": FP32_ATOL,
          "bf16_vs_fp32_max_abs_err": bf16_err})
    check(max(cpu_err.values()) <= FP32_ATOL, f"GPU vs CPU forward: {cpu_err}")

    # 6. serving: the main path, through TimedForward; counts from this run only
    tk.reset_launches()
    forwards = 0
    for dtype in (torch.float32, torch.bfloat16):
        for batch, requests in ((1, 10), (4, 5)):
            tf = TimedForward(net, dtype=dtype)
            reqs = [(rng.uniform(-1, 1, (batch, N, H, W, 3)).astype(np.float32),
                     np.tile(fd.numpy(), (batch, 1))) for _ in range(requests + 2)]
            for r in reqs[:2]:  # warm-up: cuDNN algorithm choice, allocator
                tf(*r)
            tf.total, tf.count = 0.0, 0
            t0 = time.perf_counter()
            for r in reqs[2:]:
                o = tf(*r)
                check(all(bool(torch.isfinite(t).all()) for t in o), "serving output")
            wall = time.perf_counter() - t0
            forwards += len(reqs)
            emit({"phase": "serving", "device": smi, "dtype": str(dtype).split(".")[1],
                  "batch": batch, "requests": requests, "stacks_per_s": 1.0 / tf.avg_time,
                  "avg_time_s": tf.avg_time, "wall_stacks_per_s": tf.count / wall})
    served = dict(tk.launches)
    check(all(v == forwards for v in served.values()), f"serving launches {served} != {forwards}")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "launches": served[name],
         "max_abs_err": path_rows[name]["max_abs_err"], "ms": path_rows[name]["ms"],
         "plain_ms": path_rows[name]["plain_ms"]} for name in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
