#!/usr/bin/env python3
"""Timings of dffx_torch's CUDA kernels and forwards on one NVIDIA GPU.

    python3 dffx_torch/bench.py [--root TREE] [--what kernels,mma,stages,serving]

Every line it prints is one JSON object with the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``).  ``--root`` names the tree whose
``dffx_torch`` is imported and built (default: the tree this file is in), so two
trees can be measured in turns by one command; for that the script itself
takes both C signatures of ``fm_conv_bn_relu`` (separate weight pointers in the
tree before its redesign, one packed buffer now).

* ``kernels``   each kernel against its fp32 twin, fp32 and bf16: the median of
                single calls through the wrapper and, for the kernels whose
                wrapper packs the weights, through the wrapper with the packed
                buffer kept by a ``ParamCache`` (as the modules call it), of
                single launches of the C entry point alone (weights packed
                beforehand) and the mean of 20 such launches back to back,
                CUDA events;
* ``mma``       what ``mma.sync`` m16n8k8 TF32 reaches on this card with nothing
                around it (a kernel of independent MMAs, built here with nvcc);
* ``stages``    the end-to-end forward at 1 x 10 x 608 x 1088 by stage (CUDA
                events at module boundaries), then ``torch.profiler``'s device
                time by kernel name and the device's busy share;
* ``serving``   ``TimedForward`` at the two serving shapes, fp32 and bf16.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

N, H, W = 10, 384, 384
EH, EW = 608, 1088


#: the function that packs each kernel's weights, where the wrapper packs them
PACKERS = {"fm_conv_bn_relu": "fm_conv_params", "rb_of_chain": "rb_of_chain_params",
           "motion_head_conv_chain": "motion_head_params"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(torch, fn, reps: int) -> float:
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


class Inputs:
    """Activations, weights and folded BN from one seeded numpy generator."""

    def __init__(self, np, torch, tk, dev):
        self.rng, self.torch, self.tk, self.dev = np.random.default_rng(0), torch, tk, dev

    def act(self, *shape):
        return self.torch.from_numpy(self.rng.uniform(-1, 1, shape).astype("float32")).to(self.dev)

    def wt(self, *shape):
        return self.torch.from_numpy(
            (self.rng.standard_normal(shape) * 0.1).astype("float32")).to(self.dev)

    def bn(self, c):
        g, b, mu = (self.rng.standard_normal(c) * s for s in (1, 1, 0.1))
        va = self.rng.random(c) + 0.5
        return tuple(t.to(self.dev) for t in self.tk.bn_fused_affine(
            *(self.torch.from_numpy(a.astype("float32")) for a in (g, b, mu, va))))

    def fm_conv(self, b, n, h, w):
        return (self.act(b, 3, n, h, w), self.wt(8, 3, 1, 9, 9), *self.bn(8))

    def head(self, b, n, h, w):
        return (self.act(b, 18, n, h, w), self.wt(16, 18, 1, 3, 3), self.bn(16),
                self.wt(16, 16, 1, 3, 3), self.bn(16), self.wt(16, 16, 1, 3, 3), self.bn(16),
                self.wt(3, 16, 1, 3, 3), self.wt(3))

    def rb2d(self, b, n, h, w, c=8):
        return (self.act(b, c, n, h, w), self.wt(c, c, 1, 3, 3), self.bn(c),
                self.wt(c, c, 1, 3, 3), self.bn(c))

    def srd(self, b, n, h, w, c=8):
        return (self.act(b, c, n, h, w), self.wt(c, c, 3, 1, 1), self.wt(c, c, 1, 1, 1))

    def chain(self, b, n, h, w, chans):
        return (self.act(b, chans[0][0], n, h, w), [
            (self.wt(co, ci, 1, 3, 3), self.bn(co), self.wt(co, co, 1, 3, 3), self.bn(co),
             self.wt(co, ci, 1, 1, 1)) for ci, co in chans])


def raw_launch(torch, tk, lib, name, x, args):
    """A closure that launches the C entry point alone on x (weights packed
    or made contiguous here, once), and the output it writes."""
    b, _, n, h, w = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    dt = tk._DTYPES[x.dtype]
    if name == "fm_conv_bn_relu":
        fn = lib.dffx_fm_conv_bn_relu
        y = torch.empty((b, 8, n, h, w), dtype=x.dtype, device=x.device)
        if len(fn.argtypes) == 9:  # x, params, y, ...
            keep = [tk.fm_conv_params(x, *args)]
        else:  # the tree before the redesign: x, w, scale, shift, y, ...
            keep = [t.float().contiguous() for t in args]
        ptrs = [x.data_ptr(), *(t.data_ptr() for t in keep), y.data_ptr()]
        return (lambda: fn(*ptrs, b, n, h, w, dt, stream)), y
    if name == "motion_head_conv_chain":
        fn = lib.dffx_motion_head_conv_chain
        y = torch.empty((b, 3, n, h, w), dtype=x.dtype, device=x.device)
        params = tk.motion_head_params(x, *args)
        ptrs = (x.data_ptr(), params.data_ptr(), y.data_ptr())
        return (lambda: fn(*ptrs, b, 18, 16, n, h, w, dt, stream)), y
    if name == "rb_of_chain":
        blocks = args[0]
        cout = blocks[-1][0].shape[0]
        y = torch.empty((b, cout, n, h, w), dtype=x.dtype, device=x.device)
        params = tk.rb_of_chain_params(x, blocks)
        ptrs = (x.data_ptr(), params.data_ptr(), y.data_ptr())
        return (lambda: lib.dffx_rb_of_chain(*ptrs, b, x.shape[1], cout, len(blocks), n, h, w,
                                             dt, stream)), y
    return None, None  # separate weight pointers: the wrapper adds no packing to time apart


def back_to_back_ms(torch, fn, n: int = 20) -> float:
    """Mean of n launches between two events: no idle gaps between them."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bench_kernels(np, torch, tk, lib, dev, smi, reps, only=()):
    mk = Inputs(np, torch, tk, dev)
    e2e, path, ragged, odd = (1, N, EH, EW), (1, N, H, W), (2, 3, 40, 72), (1, 3, 45, 101)
    cases = [("fm_conv_bn_relu", "e2e", mk.fm_conv(*e2e)),
             ("fm_conv_bn_relu", "path", mk.fm_conv(*path)),
             ("fm_conv_bn_relu", "b2_e2e", mk.fm_conv(2, N, EH, EW)),
             ("fm_conv_bn_relu", "ragged", mk.fm_conv(*ragged)),
             ("fm_conv_bn_relu", "odd", mk.fm_conv(*odd)),
             ("motion_head_conv_chain", "e2e", mk.head(*e2e)),
             ("motion_head_conv_chain", "b2_e2e", mk.head(2, N, EH, EW)),
             ("motion_head_conv_chain", "ragged", mk.head(*ragged)),
             ("motion_head_conv_chain", "odd", mk.head(*odd)),
             ("rb2d_residual", "e2e_c8", mk.rb2d(*e2e)),
             ("srd_attention_residual", "e2e_c8", mk.srd(*e2e)),
             ("rb_of_chain", "e2e_fe1", mk.chain(*e2e, ((3, 8), (8, 8)))),
             ("rb_of_chain", "e2e_fe2", mk.chain(1, N, EH // 2, EW // 2, ((16, 16),))),
             ("rb_of_chain", "e2e_fe3", mk.chain(1, N, EH // 4, EW // 4, ((32, 32),)))]
    for name, tag, args in cases:
        if only and name not in only:
            continue
        kernel, twin = getattr(tk, name), getattr(tk, f"{name}_ref")
        for dtype in (torch.float32, torch.bfloat16):
            x = args[0].to(dtype)
            ref = twin(x.float(), *args[1:])
            got = kernel(x, *args[1:])
            torch.cuda.synchronize()
            row = {"what": "kernel", "device": smi, "kernel": name, "shape": tag,
                   "in": list(x.shape), "dtype": str(dtype).split(".")[1],
                   "max_abs_err": (got.float() - ref).abs().max().item(),
                   "ms": median_ms(torch, lambda: kernel(x, *args[1:]), reps)}
            launch, y = raw_launch(torch, tk, lib, name, x, args[1:])
            if launch is not None:
                if hasattr(tk, "ParamCache"):
                    cache = tk.ParamCache(getattr(tk, PACKERS[name]))
                    row["cached_ms"] = median_ms(
                        torch, lambda: kernel(x, *args[1:], params=cache(x, *args[1:])), reps)
                if launch() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                row["kernel_only_err"] = (y.float() - ref).abs().max().item()
                row["kernel_only_ms"] = median_ms(torch, launch, reps)
                row["kernel_only_back_to_back_ms"] = back_to_back_ms(torch, launch)
            if tag in ("e2e", "path") or tag.startswith("e2e_"):
                row["twin_ms"] = median_ms(torch, lambda: twin(x, *args[1:]), max(reps // 3, 5))
            emit(row)
            del ref, got


MMA_PEAK_SOURCE = r"""
#include <cstdint>
// every warp: iters rounds of 8 independent m16n8k8 TF32 MMAs
__global__ void mma_peak(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3, b0 = a0 + 4, b1 = a0 + 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
          "{%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float sum = 0.f;
  for (int j = 0; j < 8; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int mma_peak_launch(float* out, int blocks, int threads, int iters, void* stream) {
  mma_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def bench_mma(torch, _build, dev, smi, reps):
    """TFLOP/s of bare mma.sync m16n8k8 TF32 at 8, 16 and 32 warps per SM."""
    import ctypes

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = _build.BUILD_DIR / "mma_peak.cu", _build.BUILD_DIR / "mma_peak.so"
    src.write_text(MMA_PEAK_SOURCE)
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(src)], check=True)
    fn = ctypes.CDLL(str(so)).mma_peak_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 1024, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    iters = 20000
    for warps in (4, 8, 16, 32):
        threads = min(warps * 32, 1024)

        def launch():
            if fn(out.data_ptr(), sms, threads, iters, stream) != 0:
                raise RuntimeError("mma_peak: launch failed")
        ms = median_ms(torch, launch, reps)
        flop = sms * (threads // 32) * iters * 8 * 2048
        emit({"what": "mma_peak", "device": smi, "warps_per_sm": threads // 32,
              "instruction": "mma.sync.m16n8k8.tf32", "ms": ms, "tflops": flop / ms / 1e9,
              "note": "8 independent accumulators per warp"})


def bench_stages(np, torch, tk, dev, smi):
    """E2E forward at the real-scene shape, by stage and by kernel name."""
    from dffx_torch.eval import load_params_auto
    from dffx_torch.models import alignnet

    net = load_params_auto(0, device=dev, e2e=True)
    flow = net.optical_flow_aggregation
    rng = np.random.default_rng(1)
    fd = torch.from_numpy((1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]).to(dev)
    fovs = torch.from_numpy(np.linspace(1.0, 1.03, 10, dtype=np.float32)[None]).to(dev)
    spans = []  # (stage, start event, end event)

    def timed(stage, fn):
        def run(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            end.record()
            spans.append((stage, start, end))
            return out
        return run

    stages = {"DFFNet": net.DFF_net, "fe1 (rb_of_chain)": flow.OF_feature,
              "fe2 (strided block + rb_of_chain)": flow.OF_feature1,
              "fe3 (strided block + rb_of_chain)": flow.OF_feature2,
              "conv1 head (stock, quarter res)": flow.conv1,
              "conv2 head (stock, half res)": flow.conv2,
              "conv3 head (motion_head_conv_chain + pool)": flow.conv3}
    for stage, mod in stages.items():
        mod.forward = timed(stage, mod.forward)
    alignnet.warp_cf = timed("four warps", alignnet.warp_cf)
    for dtype in (torch.float32, torch.bfloat16):
        fs = torch.from_numpy(rng.uniform(-1, 1, (1, 10, EH, EW, 3)).astype(np.float32)).to(
            dev, dtype)
        totals, runs = [], []
        with torch.inference_mode():
            for i in range(5):
                spans.clear()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                net(fs, fd, fovs)
                end.record()
                torch.cuda.synchronize()
                if i >= 2:  # two warm-up forwards
                    totals.append(start.elapsed_time(end))
                    by = {}
                    for stage, s, e in spans:
                        by[stage] = by.get(stage, 0.0) + s.elapsed_time(e)
                    runs.append(by)
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        total = statistics.median(totals)
        med["everything else (motion volumes, permutes)"] = total - sum(med.values())
        emit({"what": "stages", "device": smi, "dtype": str(dtype).split(".")[1],
              "shape": [1, 10, EH, EW], "forwards": len(totals), "total_ms": total,
              "stage_ms": med})
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                         ProfilerActivity.CUDA]) as prof:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(3):
                net(fs, fd, fovs)
            end.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        from torch.autograd import DeviceType

        # the kernels' own rows only: an operator's row repeats its kernels' time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
        emit({"what": "profile", "device": smi, "dtype": str(dtype).split(".")[1],
              "forwards": 3, "wall_ms_per_forward": wall / 3,
              "device_busy_share": sum(r[1] for r in rows) / wall,
              "top_ms_per_forward": [{"name": k[:90], "ms": ms / 3, "calls": c / 3}
                                     for k, ms, c in rows[:14]]})


def bench_serving(np, torch, dev, smi):
    from dffx_torch.eval import TimedForward, load_params_auto

    rng = np.random.default_rng(1)
    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    fovs = np.linspace(1.0, 1.03, 10, dtype=np.float32)[None]
    for e2e, (h, w), batches in ((False, (H, W), (1, 4)), (True, (EH, EW), (1,))):
        net = load_params_auto(0, device=dev, e2e=e2e)
        for dtype in (torch.float32, torch.bfloat16):
            for batch in batches:
                tf = TimedForward(net, dtype=dtype)
                extra = (np.tile(fovs, (batch, 1)),) if e2e else ()
                for i in range(2 + 8):
                    if i == 2:
                        tf.total, tf.count = 0.0, 0
                    tf(rng.uniform(-1, 1, (batch, 10, h, w, 3)).astype(np.float32),
                       np.tile(fd, (batch, 1)), *extra)
                emit({"what": "serving", "device": smi, "model": "e2e" if e2e else "dffnet",
                      "dtype": str(dtype).split(".")[1], "batch": batch, "shape": [10, h, w],
                      "requests": 8, "avg_time_ms": tf.avg_time * 1e3,
                      "stacks_per_s": 1.0 / tf.avg_time})


def main() -> int:
    here = Path(__file__).resolve().parents[1]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=here, help="tree whose dffx_torch is measured")
    ap.add_argument("--what", default="kernels,mma,stages,serving")
    ap.add_argument("--only", default="", help="kernels mode: these kernels only (a,b,...)")
    ap.add_argument("--reps", type=int, default=30)
    ns = ap.parse_args()
    sys.path.insert(0, str(ns.root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    from dffx_torch.ops import _build
    from dffx_torch.ops import kernels as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _, seconds, log = _build.build()
    lib = _build.library()
    emit({"what": "build", "device": smi, "root": str(ns.root), "seconds": seconds,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})
    what = ns.what.split(",")
    if "kernels" in what:
        bench_kernels(np, torch, tk, lib, dev, smi, ns.reps,
                      tuple(k for k in ns.only.split(",") if k))
    if "mma" in what:
        bench_mma(torch, _build, dev, smi, ns.reps)
    if "stages" in what:
        bench_stages(np, torch, tk, dev, smi)
    if "serving" in what:
        bench_serving(np, torch, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
