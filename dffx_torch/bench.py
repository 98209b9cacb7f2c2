#!/usr/bin/env python3
"""Timings of dffx_torch's CUDA kernels and forwards on one NVIDIA GPU.

    python3 dffx_torch/bench.py [--root TREE] [--what kernels,mma,stages,serving,train,sim]
                                [--graph unpacked,packed,...] [--cudnn-benchmark] [--tf32]

Every line it prints is one JSON object with the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``).  ``--root`` names the tree whose
``dffx_torch`` is imported and built (default: the tree this file is in), so two
trees can be measured in turns by one command; for that the script itself
takes both C signatures of ``rb2d_residual`` and of ``srd_attention_residual``
(separate weight pointers in the trees before their redesigns, one packed
buffer now, and for the attention its grid plan).

* ``kernels``   each kernel against its fp32 twin, fp32 and bf16: the median of
                single calls through the wrapper and, for the kernels whose
                wrapper packs the weights in the measured tree, through the
                wrapper with the packed buffer kept by a ``ParamCache`` (as the
                modules call it), of
                single launches of the C entry point alone (weights packed
                beforehand) and the mean of 20 such launches back to back,
                CUDA events;
* ``mma``       what ``mma.sync`` m16n8k8 TF32 reaches on this card with nothing
                around it (a kernel of independent MMAs, built here with nvcc);
* ``stages``    the end-to-end forward at 1 x 10 x 608 x 1088 by stage (CUDA
                events at module boundaries), then ``torch.profiler``'s device
                time by kernel name and the device's busy share, for it and
                for DFFNet alone at 10 x 384 x 384 (batch 1 fp32, batch 4 bf16);
* ``serving``   ``TimedForward`` at the two serving shapes, fp32 and bf16;
* ``train``     ``torch.profiler`` over train steps at b4 10 x 224 x 224 (DFFNet
                fp32, bf16 and remat; the end-to-end network fp32): device
                time by kernel name and the device's busy share (this tree only);
* ``pieces``    DFFNet's full-resolution stage and its neighbours alone, at the
                shapes the two serving paths give them: each 16 -> 8 deconv as
                cuDNN runs it, in ``channels_last_3d`` and as a packed conv,
                the whole stage unpacked and packed, and both EFDs unpacked
                and packed (``models/packed.py``);
* ``sim``       the simulator's render program (``dffx_torch.sim``) on a scene
                at its command line's size (224 x 352, 10 slices, 2,000
                planes, the pixel6 profile), its blur as one conv a slice (the
                library's) and as one grouped conv (here only), in turns:
                device time per scene, the blur alone, the two against each
                other, and the profile of the library's program;
* ``parallel``  several processes, a card each, under ``torchrun
                --nproc_per_node S`` (``python -m torch.distributed.run``):
                DFFNet's data-parallel train step (global batch 2 S, ``sync``
                and ``per_shard``) against one process at that batch and at a
                rank's, then ``--spatial S`` forwards against whole ones
                (DFFNet at 10 x 384 x 576 and 10 x 768 x 1152, E2E at
                384 x 576; fp32 and bf16); rank 0 prints.  Runs alone: the
                other measurements are for one card.

``--graph`` names the graphs that ``stages`` and ``serving`` run, in turns, as a
list: ``unpacked``; ``packed`` (both EFDs and the full-resolution stage
space-to-depth, what the JAX package serves); and two that exist only here,
for measurement: ``deconvs`` (unpacked, but the two 16 -> 8 full-resolution
deconvs lowered to a packed conv and an unpack) and ``tail`` (the
full-resolution stage packed, the EFDs not).  A tree from before the packed
path takes ``unpacked`` only.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, H, W = 10, 384, 384
EH, EW = 608, 1088


#: the function that packs each kernel's weights, where the wrapper packs them
PACKERS = {"fm_conv_bn_relu": "fm_conv_params", "rb2d_residual": "rb2d_params",
           "rb_of_chain": "rb_of_chain_params", "motion_head_conv_chain": "motion_head_params",
           "srd_attention_residual": "srd_attention_params"}


GRAPHS = ("unpacked", "deconvs", "tail", "packed")
#: ``parallel``: the train crop, and the (E2E?, H x W) of the spatial forwards
PARALLEL_TRAIN_SHAPE = (10, 224, 224)
PARALLEL_SPATIAL_CASES = ((False, (384, 576)), (False, (768, 1152)), (True, (384, 576)))


def lowered_deconv(deconv):
    """A forward for the reference's one deconv configuration as a packed
    conv (``pack_deconv``) and an ``unpack``; the scattered weight is kept."""
    import torch.nn.functional as F

    from dffx_torch.models import packed as pk
    from dffx_torch.ops.kernels import ParamCache

    cache = ParamCache(lambda x, w: pk.pack_deconv(w.to(x.dtype)))

    def forward(x):
        w = cache.or_packed(x, deconv.weight)
        return pk.unpack(F.conv3d(F.pad(x, pk._PAD_DECONV), w))
    return forward


def make_net(graph: str, dev, e2e: bool):
    """The seed-0 network of ``graph`` on ``dev``."""
    from dffx_torch.eval import load_params_auto

    kw = {}
    if "packed" in inspect.signature(load_params_auto).parameters:
        kw["packed"] = graph in ("tail", "packed")
    elif graph != "unpacked":
        raise SystemExit(f"bench: this tree has no packed path, so no graph {graph!r}")
    net = load_params_auto(0, device=dev, e2e=e2e, **kw)
    dff = net.DFF_net
    if graph == "tail":  # the EFDs as the unpacked graph runs them (both trees' names)
        dff._down = dff._packed_down = (
            lambda level, x, x_packed=None: (dff.FM_conv1, dff.FM_conv2)[level](x))
    elif graph == "deconvs":
        for deconv in (dff.deconv_3[0], dff.dres4.conv6[0]):
            deconv.forward = lowered_deconv(deconv)
    return net


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
        y = torch.empty((b, 8, n, h, w), dtype=x.dtype, device=x.device)
        params = tk.fm_conv_params(x, *args)
        ptrs = (x.data_ptr(), params.data_ptr(), y.data_ptr())
        return (lambda: lib.dffx_fm_conv_bn_relu(*ptrs, b, n, h, w, dt, stream)), y
    if name == "rb2d_residual":
        fn = lib.dffx_rb2d_residual
        y = torch.empty_like(x)
        if len(fn.argtypes) == 10:  # x, params, y, ...
            keep = [tk.rb2d_params(x, *args)]
        else:  # the tree before the redesign: x, w1, s1, b1, w2, s2, b2, y, ...
            w1, aff1, w2, aff2 = args
            keep = [t.float().contiguous() for t in (w1, *aff1, w2, *aff2)]
        ptrs = [x.data_ptr(), *(t.data_ptr() for t in keep), y.data_ptr()]
        return (lambda: fn(*ptrs, b, x.shape[1], n, h, w, dt, stream)), y
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
    if name == "srd_attention_residual":
        fn = lib.dffx_srd_attention_residual
        y = torch.empty_like(x)
        c = x.shape[1]
        if len(fn.argtypes) == 12:  # f, params, y, B, C, N, H, W, slices, blocks, dtype, stream
            plan = tk.srd_attention_plan(b, c, n, h * w, x.dtype == torch.bfloat16,
                                         tk._sm_count(x.device))
            params = tk.srd_attention_params(x, *args)
            ptrs = (x.data_ptr(), params.data_ptr(), y.data_ptr())
            return (lambda: fn(*ptrs, b, c, n, h, w, plan.slices, plan.blocks, dt, stream)), y
        # the tree before the redesign: f, wn, w1, y, B, C, N, H, W, dtype, stream
        keep = [t.float().contiguous() for t in args]
        ptrs = [x.data_ptr(), *(t.data_ptr() for t in keep), y.data_ptr()]
        return (lambda: fn(*ptrs, b, c, n, h, w, dt, stream)), y
    raise ValueError(name)


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
             ("rb2d_residual", "path_c8", mk.rb2d(*path)),
             ("rb2d_residual", "odd_c8", mk.rb2d(*odd)),
             ("rb2d_residual", "ragged_c16", mk.rb2d(*ragged, c=16)),
             ("rb2d_residual", "ragged_c32", mk.rb2d(*ragged, c=32)),
             ("srd_attention_residual", "e2e_c8", mk.srd(*e2e)),
             ("srd_attention_residual", "path_c8", mk.srd(*path)),
             ("srd_attention_residual", "b4_c8", mk.srd(4, N, H, W)),
             ("srd_attention_residual", "ragged_c16", mk.srd(*ragged, c=16)),
             ("srd_attention_residual", "ragged_c32", mk.srd(*ragged, c=32)),
             ("srd_attention_residual", "slices_c8", mk.srd(1, 65537, 2, 3)),
             ("srd_attention_residual", "batches_c8", mk.srd(65537, 1, 2, 3)),
             ("rb_of_chain", "e2e_fe1", mk.chain(*e2e, ((3, 8), (8, 8)))),
             ("rb_of_chain", "odd_fe1", mk.chain(*odd, ((3, 8), (8, 8)))),
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
            packer = getattr(tk, PACKERS.get(name, ""), None)  # None: the wrapper packs nothing
            if packer is not None:
                cache = tk.ParamCache(packer)
                row["cached_ms"] = median_ms(
                    torch, lambda: kernel(x, *args[1:], params=cache(x, *args[1:])), reps)
            launch, y = raw_launch(torch, tk, lib, name, x, args[1:])
            if launch() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            row["kernel_only_err"] = (y.float() - ref).abs().max().item()
            row["kernel_only_ms"] = median_ms(torch, launch, reps)
            row["kernel_only_back_to_back_ms"] = back_to_back_ms(torch, launch)
            if tag in ("e2e", "path") or tag.startswith(("e2e_", "path_", "slices_")):
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


def bench_stages(np, torch, tk, dev, smi, graph):
    """E2E forward at the real-scene shape, by stage and by kernel name."""
    from dffx_torch.models import alignnet

    net = make_net(graph, dev, e2e=True)
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
    warp_cf, alignnet.warp_cf = alignnet.warp_cf, timed("four warps", alignnet.warp_cf)
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
        emit({"what": "stages", "device": smi, "graph": graph,
              "dtype": str(dtype).split(".")[1],
              "shape": [1, 10, EH, EW], "forwards": len(totals), "total_ms": total,
              "stage_ms": med})
        emit({"what": "profile", "device": smi, "graph": graph, "model": "e2e", "batch": 1,
              "dtype": str(dtype).split(".")[1], "shape": [10, EH, EW],
              **profile_forwards(torch, lambda: net(fs, fd, fovs))})
    alignnet.warp_cf = warp_cf
    # DFFNet alone at its serving shape: device time by kernel name, busy share
    dff = make_net(graph, dev, e2e=False)
    for dtype, batch in ((torch.float32, 1), (torch.bfloat16, 4)):
        fs = torch.from_numpy(rng.uniform(-1, 1, (batch, N, H, W, 3)).astype(np.float32)).to(
            dev, dtype)
        fdb = fd.expand(batch, -1).contiguous()
        with torch.inference_mode():
            for _ in range(3):
                dff(fs, fdb)
        emit({"what": "profile", "device": smi, "graph": graph, "model": "dffnet", "batch": batch,
              "dtype": str(dtype).split(".")[1], "shape": [N, H, W],
              **profile_forwards(torch, lambda: dff(fs, fdb), forwards=6)})


def bench_train(np, torch, dev, smi):
    """The train step at the recipes' size (b4 10 x 224 x 224): device time by
    kernel name and the device's busy share, for DFFNet in fp32, bf16 and with
    remat and for the end-to-end network in fp32."""
    from dffx_torch.eval import load_params_auto
    from dffx_torch.train import LossConfig, create_train_state, make_train_step

    rng = np.random.default_rng(2)
    b, n, h, w = 4, 10, 224, 224
    for e2e, dtype, remat in ((False, torch.float32, False), (False, torch.bfloat16, False),
                              (False, torch.float32, True), (True, torch.float32, False)):
        batch = {"fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
                 "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32),
                 "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32), (b, 1)),
                 "mask": rng.random((b, h, w)) > 0.2,
                 "fovs": np.tile(np.linspace(1.0, 1.03, n, dtype=np.float32), (b, 1))}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = create_train_state(load_params_auto(0, device=dev, e2e=e2e), 1e-3)
        step = make_train_step(1e-3, LossConfig(), e2e=e2e, compute_dtype=dtype, remat=remat)
        for _ in range(2):
            step(state, batch)
        emit({"what": "train_profile", "device": smi, "model": "e2e" if e2e else "dffnet",
              "dtype": str(dtype).split(".")[1], "remat": remat, "batch": b, "shape": [n, h, w],
              "cudnn_benchmark": torch.backends.cudnn.benchmark,
              "tf32": torch.backends.cudnn.allow_tf32,
              **profile_forwards(torch, lambda: step(state, batch), grad=True)})


def profile_forwards(torch, forward, forwards: int = 3, grad: bool = False) -> dict:
    """``torch.profiler`` over a few forwards (or, with ``grad``, train
    steps): wall time, the device's busy share of it, and the device time of
    the top kernels, per forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mode = contextlib.nullcontext() if grad else torch.inference_mode()
    with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(forwards):
            forward()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    # the kernels' own rows only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return {"forwards": forwards, "wall_ms_per_forward": wall / forwards,
            "device_busy_share": sum(r[1] for r in rows) / wall,
            "top_ms_per_forward": [{"name": k[:90], "ms": ms / forwards, "calls": c / forwards}
                                   for k, ms, c in rows[:14]]}


#: fp32 FMA outside the tensor cores, one H100 SXM at 700 W (NVIDIA's data sheet):
#: the simulator's convs run with TF32 off
FP32_FLOP_PER_S, HBM_BYTES_PER_S = 67e12, 3.35e12


def sim_scene(np, seed: int = 0, h: int = 224, w: int = 352):
    """A NYU-shaped scene at the simulator's size: a smooth BGR image, a
    smooth depth in [0.1, 1.1] m with an edge, planned (``plan_scene``) with
    the pixel6 profile at the command line's defaults."""
    from dffx_torch.sim import simulator as sim

    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    image = (127.5 + 127.5 * np.sin(np.stack([5 * xx + c * yy for c in (3, 7, 11)], -1) * 3)
             ).astype(np.float32)
    depth = 0.3 + 0.5 * xx + 0.2 * np.cos(4 * yy) + (xx > 0.4) * 0.3
    depth = 1.0 * (depth - depth.min()) / (depth.max() - depth.min()) + 0.1
    pvm = 1 / 0.0000014 * 352 / 4080
    plan, _, _ = sim.plan_scene(depth, profile=sim.DEVICE_PROFILES[1], rng=r, pixel_vs_meter=pvm)
    return image, depth, depth * pvm, plan


def blur_grouped(torch, sim):
    """The simulator's blur as one grouped conv (the slices as groups, each
    slice's layers its outputs, the colours as the batch), for measurement
    against the library's conv a slice."""
    import torch.nn.functional as F

    def blur(wimg, kernels):
        s, n_layers, k, _ = kernels.shape
        out = F.conv2d(sim._reflect_pad(wimg, k // 2), kernels.reshape(s * n_layers, 1, k, k),
                       groups=s)
        return torch.clamp(torch.round(out), 0.0, 255.0).view(3, s, n_layers,
                                                               *wimg.shape[-2:])

    return blur


def sim_host_ms(np, torch, sim, image, depth, depth_px, dev, reps: int = 5) -> dict:
    """Median host milliseconds of a scene's pieces outside the render
    program, as ``generate_scene`` and the command line run them: the
    prepass (``plan_scene``: the draws and ``coc_layers`` over 2,000 planes a
    slice), the kernels and bounds (``_layer_operands``), the operands to the
    card, the results back, the last slice's depth warp (``warp_2d``), and
    one scene's files (ten PNGs and two .mat files, on one thread)."""
    import tempfile

    import cv2
    import scipy.io as sio

    pvm = 1 / 0.0000014 * 352 / 4080
    plan, cam, _ = sim.plan_scene(depth, profile=sim.DEVICE_PROFILES[1],
                                  rng=np.random.default_rng(0), pixel_vs_meter=pvm)
    ops = sim.scene_operands(image, depth, depth_px, plan, dev)
    out, disp = sim.render_program(*ops)
    imgs = out.cpu().numpy().astype(np.uint8)

    def write(root):
        for i in range(imgs.shape[0]):
            cv2.imwrite(f"{root}/img{i}.png", imgs[i])
        sio.savemat(f"{root}/depth.mat", {"depth": depth, "defocus": disp.cpu().numpy()})
        sio.savemat(f"{root}/camera_param.mat", cam)

    def timed(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    last = plan[-1]
    with tempfile.TemporaryDirectory() as tmp:
        return {
            "plan_scene": timed(lambda: sim.plan_scene(
                depth, profile=sim.DEVICE_PROFILES[1], rng=np.random.default_rng(0),
                pixel_vs_meter=pvm)),
            "layer_operands": timed(lambda: sim._layer_operands([p["layers"] for p in plan])),
            "scene_operands": timed(lambda: sim.scene_operands(image, depth, depth_px, plan, dev)),
            "results_to_host": timed(lambda: (out.cpu().numpy().astype(np.uint8),
                                              disp.cpu().numpy())),
            "warp_2d_depth": timed(lambda: sim.warp_2d(depth.astype(np.float32), last["fov"],
                                                       last["beta"], last["gamma"], device=dev)),
            "write_files": timed(lambda: write(tmp)),
        }


def bench_sim(np, torch, dev, smi, reps):
    """The render program on one scene, the blur per slice and grouped in
    turns (per slice, grouped, grouped, per slice): device seconds per scene
    (``profiling.device_loop_time``), the blur alone, the outputs of the two
    against each other, the least time for the blur's work, and a profile."""
    from dffx_torch.sim import simulator as sim
    from dffx_torch.utils.profiling import device_loop_time

    image, depth, depth_px, plan = sim_scene(np)
    ops = sim.scene_operands(image, depth, depth_px, plan, dev)
    kernels = ops[6]
    s, n_layers, k, _ = kernels.shape
    h, w = depth.shape
    per_slice, grouped = sim._blur_layers, blur_grouped(torch, sim)
    wimg = torch.floor(torch.rand(3, s, h, w, device=dev) * 256)
    # the work of the blur as the program runs it (bucketed kernels and layers)
    # and as the scene needs it (each layer's own disc size, no padding rows)
    macs = 3 * s * n_layers * h * w * k * k
    need = 3 * h * w * sum(sim._ksize(c) ** 2 for p in plan for c, _, _ in p["layers"])
    nbytes = 4 * (3 * s * h * w + kernels.numel() + 3 * s * n_layers * h * w)
    bound = max(2 * need / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    outs, rows = {}, []
    with torch.inference_mode(), sim._fp32_exact(dev):
        for name in ("per_slice", "grouped", "grouped", "per_slice"):
            sim._blur_layers = grouped if name == "grouped" else per_slice
            try:
                program_s = device_loop_time(sim.render_program, *ops, iters=reps)
                blur_s = device_loop_time(sim._blur_layers, wimg, kernels, iters=reps)
                outs[name] = [t.cpu() for t in sim.render_program(*ops)]
            finally:
                sim._blur_layers = per_slice
            rows.append({"blur": name, "program_ms": program_s * 1e3, "blur_ms": blur_s * 1e3})
        prof = profile_forwards(torch, lambda: sim.render_program(*ops), forwards=3)
    diff = (outs["grouped"][0] - outs["per_slice"][0]).abs()
    host = sim_host_ms(np, torch, sim, image, depth, depth_px, dev)
    emit({"what": "sim", "device": smi, "shape": [s, h, w], "layers": n_layers, "kernel": k,
          "layers_per_slice": [len(p["layers"]) for p in plan],
          "cudnn_benchmark": torch.backends.cudnn.benchmark, "turns": rows,
          "blur_macs_run": macs, "blur_macs_needed": need, "blur_bound_ms": bound,
          "bound_by": "operations" if 2 * need / FP32_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S
          else "bytes",
          "per_slice_vs_grouped": {"max_abs": float(diff.max()),
                                   "share_differing": float((diff > 0).float().mean()),
                                   "disparity_max_abs": float((outs["grouped"][1]
                                                               - outs["per_slice"][1]).abs()
                                                              .nan_to_num().max())},
          "host_ms": host, "profile": prof})


def bench_serving(np, torch, dev, smi, graph):
    from dffx_torch.eval import TimedForward

    rng = np.random.default_rng(1)
    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    fovs = np.linspace(1.0, 1.03, 10, dtype=np.float32)[None]
    for e2e, (h, w), batches in ((False, (H, W), (1, 4)), (True, (EH, EW), (1,))):
        net = make_net(graph, dev, e2e)
        for dtype in (torch.float32, torch.bfloat16):
            for batch in batches:
                tf = TimedForward(net, dtype=dtype)
                extra = (np.tile(fovs, (batch, 1)),) if e2e else ()
                for i in range(2 + 8):
                    if i == 2:
                        tf.total, tf.count = 0.0, 0
                    tf(rng.uniform(-1, 1, (batch, 10, h, w, 3)).astype(np.float32),
                       np.tile(fd, (batch, 1)), *extra)
                emit({"what": "serving", "device": smi, "graph": graph,
                      "cudnn_benchmark": torch.backends.cudnn.benchmark,
                      "model": "e2e" if e2e else "dffnet",
                      "dtype": str(dtype).split(".")[1], "batch": batch, "shape": [10, h, w],
                      "requests": 8, "avg_time_ms": tf.avg_time * 1e3,
                      "stacks_per_s": 1.0 / tf.avg_time})


def bench_pieces(np, torch, dev, smi, reps):
    """The full-resolution stage (``deconv_3``, ``dres4``, ``classif3``), its two
    16 -> 8 deconvs and both EFDs alone, on random activations at the shapes
    the serving paths give them, unpacked and, where the tree has
    ``models/packed.py``, packed.  Medians of single calls, CUDA events."""
    import torch.nn.functional as F

    try:
        from dffx_torch.models import packed as pk
    except ImportError:
        pk = None
    dff = make_net("unpacked", dev, e2e=False).DFF_net
    rng = np.random.default_rng(2)

    def act(dtype, b, c, n, h, w):
        return torch.from_numpy(rng.uniform(-1, 1, (b, c, n, h, w)).astype(np.float32)).to(
            dev, dtype)

    def unpacked_tail(out_in, fm, pre, out):
        out2 = dff.deconv_3(out_in)
        o, _ = dff.dres4(torch.cat([out2, fm], dim=1), pre, out)
        return dff.classif3(out2 + o)[:, 0]

    cl = torch.channels_last_3d
    for tag, dtype, (b, n, h, w) in (("dffnet_b1", torch.float32, (1, N, H, W)),
                                     ("dffnet_b4", torch.bfloat16, (4, N, H, W)),
                                     ("e2e_b1", torch.float32, (1, 10, EH, EW)),
                                     ("e2e_b1", torch.bfloat16, (1, 10, EH, EW))):
        out_in, pre, out = (act(dtype, b, 16, n, h // 2, w // 2) for _ in range(3))
        fm = act(dtype, b, 8, n, h, w)
        ms = {}
        with torch.inference_mode():
            for name, mod in (("deconv_3", dff.deconv_3[0]), ("dres4.conv6", dff.dres4.conv6[0])):
                ms[f"{name} cudnn"] = median_ms(torch, lambda: mod(out_in), reps)
                x_cl, w_cl = out_in.to(memory_format=cl), mod.weight.to(dtype).to(memory_format=cl)
                ms[f"{name} channels_last_3d"] = median_ms(
                    torch, lambda: F.conv_transpose3d(x_cl, w_cl, stride=(1, 2, 2), padding=1,
                                                      output_padding=(0, 1, 1)), reps)
                ms[f"{name} channels_last_3d with both copies"] = median_ms(
                    torch, lambda: F.conv_transpose3d(
                        out_in.to(memory_format=cl), w_cl, stride=(1, 2, 2), padding=1,
                        output_padding=(0, 1, 1)).contiguous(), reps)
                if pk is not None:
                    wp = pk.pack_deconv(mod.weight.to(dtype))
                    ms[f"{name} packed conv"] = median_ms(
                        torch, lambda: F.conv3d(F.pad(out_in, pk._PAD_DECONV), wp), reps)
                    ms[f"{name} packed conv + unpack"] = median_ms(
                        torch, lambda: pk.unpack(F.conv3d(F.pad(out_in, pk._PAD_DECONV), wp)),
                        reps)
            ms["stage unpacked"] = median_ms(
                torch, lambda: unpacked_tail(out_in, fm, pre, out), reps)
            half = act(dtype, b, 16, n, h // 2, w // 2)
            efds = ((dff.FM_conv1[0], fm, "EFD 8->16"), (dff.FM_conv2[0], half, "EFD 16->32"))
            for efd, x, name in efds:
                ms[f"{name} unpacked"] = median_ms(torch, lambda: efd(x), reps)
            if pk is not None:
                params = pk.stage_params(out_in, *pk.stage_sources(dff.deconv_3, dff.dres4,
                                                                   dff.classif3[0]))
                fmp = pk.pack(fm)
                ms["pack(fm)"] = median_ms(torch, lambda: pk.pack(fm), reps)
                ms["stage packed (fm packed already)"] = median_ms(
                    torch, lambda: pk.packed_stage(dff.dres4, out_in, fmp, pre, out, params), reps)
                for efd, x, name in efds:
                    xp, w_s2 = pk.pack(x), pk.efd_params(x, efd.stride_conv[0].weight)
                    ms[f"{name} packed (input packed already)"] = median_ms(
                        torch, lambda: pk.packed_efd(efd, xp, w_s2), reps)
                ms["pack(half)"] = median_ms(torch, lambda: pk.pack(half), reps)
        emit({"what": "pieces", "device": smi, "shape": tag, "dtype": str(dtype).split(".")[1],
              "cudnn_benchmark": torch.backends.cudnn.benchmark, "stack": [b, n, h, w], "ms": ms})
        del out_in, pre, out, fm, half
        torch.cuda.empty_cache()


def _params_digest(torch, model) -> int:
    """A 63-bit digest of every parameter's and buffer's bytes, to tell whether
    two ranks hold the same bits."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    for t in model.state_dict().values():
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return int.from_bytes(h.digest(), "little") >> 1


def bench_parallel(np, torch, smi):
    """Several processes, a card each (launch under ``torchrun
    --nproc_per_node S``): DFFNet's train step with the global batch 2 S of
    10 x 224 x 224 over the S ranks, ``sync`` and ``per_shard``, against one
    process on one card at the same global batch and at a rank's (2); then
    ``TimedForward(spatial=S)`` against the same forward whole on each rank's
    card.  Rank 0 prints; every check runs on every rank."""
    import torch.distributed as dist

    from dffx_torch.eval import TimedForward, load_params_auto
    from dffx_torch.parallel import distributed, make_mesh, shard_batch
    from dffx_torch.train import LossConfig, create_train_state, make_train_step

    dev = distributed.initialize()
    world, rank = distributed.process_count(), distributed.process_index()
    mesh = make_mesh()

    def show(obj):
        if rank == 0:
            emit({**obj, "device": smi, "ranks": world, "backend": dist.get_backend()})

    def step_ms(step, state, batches) -> list:
        times = []
        for batch in batches:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, logs = step(state, batch)
            float(logs["loss"])
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    rng = np.random.default_rng(5)
    (n, h, w), per_rank, steps = PARALLEL_TRAIN_SHAPE, 2, 7
    host = [{"fs": rng.uniform(-1, 1, (per_rank * world, n, h, w, 3)).astype(np.float32),
             "depth": rng.uniform(0.1, 1.5, (per_rank * world, h, w)).astype(np.float32),
             "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32),
                                    (per_rank * world, 1)),
             "mask": rng.random((per_rank * world, h, w)) > 0.2} for _ in range(steps)]
    for mode in ("sync", "per_shard"):
        state = create_train_state(load_params_auto(0, device=dev), 1e-3)
        step = make_train_step(1e-3, LossConfig(), bn_mode=mode, mesh=mesh)
        distributed.reset_traffic()
        times = step_ms(step, state, [shard_batch(b, mesh, dev) for b in host])
        digests = torch.tensor([_params_digest(torch, state.model)], device=dev)
        every = [torch.zeros_like(digests) for _ in range(world)]
        dist.all_gather(every, digests)
        same = len({int(d) for d in every}) == 1
        show({"what": "parallel_train", "mode": mode, "batch": per_rank * world,
              "batch_a_rank": per_rank, "shape": [n, h, w], "ms_steps": times,
              "ms_per_step": statistics.median(times[2:]),
              "bytes_a_step": {k: v / steps for k, v in distributed.traffic.items()},
              "same_bits_on_every_rank": same,
              "cudnn_benchmark": torch.backends.cudnn.benchmark})
        if not same:
            raise RuntimeError(f"parallel_train {mode}: ranks differ")
    # one process a card: the same global batch, and a rank's; every rank runs
    # it on its own card at once (``create_train_state`` broadcasts)
    for b in (per_rank * world, per_rank):
        state = create_train_state(load_params_auto(0, device=dev), 1e-3)
        step = make_train_step(1e-3, LossConfig())
        times = step_ms(step, state, [{k: torch.from_numpy(v[:b]).to(dev)
                                       for k, v in hb.items()} for hb in host])
        show({"what": "parallel_train_one_process", "batch": b, "shape": [n, h, w],
              "ms_steps": times, "ms_per_step": statistics.median(times[2:])})

    fd = (1 / np.linspace(0.2, 3.0, 10, dtype=np.float32))[None]
    fovs = np.linspace(1.0, 1.03, 10, dtype=np.float32)[None]
    for e2e, (h, w) in PARALLEL_SPATIAL_CASES:
        net = load_params_auto(0, device=dev, e2e=e2e)
        args = [rng.uniform(-1, 1, (1, 10, h, w, 3)).astype(np.float32), fd]
        args += [fovs] if e2e else []
        for dtype in (torch.float32, torch.bfloat16):
            whole = TimedForward(net, dtype=dtype)
            sharded = TimedForward(net, dtype=dtype, spatial=world)
            outs = []
            for tf in (whole, sharded):
                for i in range(2 + 8):
                    if i == 2:
                        tf.total, tf.count = 0.0, 0
                    out = tf(*args)
                outs.append([o.float() for o in out])
            distributed.reset_traffic()
            sharded(*args)
            err = max(float((a - b).abs().max()) for a, b in zip(*outs))
            show({"what": "parallel_spatial", "model": "e2e" if e2e else "dffnet",
                  "dtype": str(dtype).split(".")[1], "shape": [10, h, w],
                  "whole_ms": whole.avg_time * 1e3, "sharded_ms": sharded.avg_time * 1e3,
                  "bytes_a_forward": dict(distributed.traffic), "max_abs_err": err})
            if dtype == torch.float32 and err > 1e-4:
                raise RuntimeError(f"parallel_spatial fp32: {err} from the whole forward")
    distributed.shutdown()


def main() -> int:
    here = Path(__file__).resolve().parents[1]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=here, help="tree whose dffx_torch is measured")
    ap.add_argument("--what", default="kernels,mma,stages,serving")
    ap.add_argument("--only", default="", help="kernels mode: these kernels only (a,b,...)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--graph", default="unpacked,packed",
                    help=f"stages and serving: the graphs to run, in turns, of {GRAPHS}")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="pieces, stages, serving, train and sim under "
                         "torch.backends.cudnn.benchmark = True")
    ap.add_argument("--tf32", action="store_true",
                    help="TF32 for cuDNN's fp32 convs and cuBLAS's fp32 matmuls (PyTorch's "
                         "default for cuDNN); without it both run in full fp32")
    ns = ap.parse_args()
    graphs = ns.graph.split(",")
    if set(graphs) - set(GRAPHS):
        ap.error(f"--graph takes {GRAPHS}, got {ns.graph!r}")
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
    torch.backends.cudnn.allow_tf32 = ns.tf32
    torch.backends.cuda.matmul.allow_tf32 = ns.tf32
    what = ns.what.split(",")
    if "parallel" in what:  # before any other CUDA call: each rank takes its card
        torch.backends.cudnn.benchmark = ns.cudnn_benchmark
        bench_parallel(np, torch, smi)
        return 0
    dev = torch.device("cuda", 0)
    _, seconds, log = _build.build()
    lib = _build.library()
    emit({"what": "build", "device": smi, "root": str(ns.root), "seconds": seconds,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})
    if "kernels" in what:
        bench_kernels(np, torch, tk, lib, dev, smi, ns.reps,
                      tuple(k for k in ns.only.split(",") if k))
    if "mma" in what:
        bench_mma(torch, _build, dev, smi, ns.reps)
    # for the whole process, before its first conv: cuDNN's choice for a shape
    # is kept, and setting the flag later does not search again
    torch.backends.cudnn.benchmark = ns.cudnn_benchmark
    if "pieces" in what:
        bench_pieces(np, torch, dev, smi, ns.reps)
    if "train" in what:
        bench_train(np, torch, dev, smi)
    if "sim" in what:
        bench_sim(np, torch, dev, smi, ns.reps)
    for graph in graphs:
        if "stages" in what:
            bench_stages(np, torch, tk, dev, smi, graph)
        if "serving" in what:
            bench_serving(np, torch, dev, smi, graph)
    return 0


if __name__ == "__main__":
    sys.exit(main())
