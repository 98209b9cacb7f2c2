"""One hand-held scene at a time: one client in a closed loop hands the
program's serving entry (``TimedForward``) a float32 stack from host memory,
with the rest of its inputs, and copies the depth map (the network's output
``DEPTH``, E2E's pred3) back to the host.  The stacks come from a pool of
distinct ones made from the seed.

Traffic keys: ``batch`` (1), ``dtype``, ``pool``, ``sample_calls`` (the
window's answers held to the reference, drawn from the seed),
``trace_calls``.  End to end: ``serve_p50_ms``, the median over every
request of the window of the time from the call to the depth map on the
host, by the host's clock (its 95th percentile goes to standard error).
Spans: the mean request time and the mean of ``TimedForward``'s own event
time a request."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import core
from portbench.core import Run
from portbench.drivers import common
from portbench.inputs import serving_inputs


def run(r: Run) -> None:
    from dffx_torch.eval.common import TimedForward

    cfg, tr = r.cell.config, r.cell.traffic
    b, dtype = int(tr["batch"]), common.DTYPES[tr["dtype"]]
    common.program_device(r)
    depth = common.network(r).DEPTH
    net = common.program_network(cfg, common.draw_weights(r), r.device)
    serve = TimedForward(net, dtype=dtype)
    r.mark("weights and model")
    gen = r.generator("inputs")
    pool = [[t.cpu() for t in serving_inputs(cfg, b, torch.float32, r.device, gen)]
            for _ in range(int(tr["pool"]))]

    def request(inputs):
        outs = serve(*inputs)
        return outs, outs[depth].cpu()

    r.mark("inputs")
    for inputs in pool[:2]:
        request(inputs)
    sample = common.Sample(r.seed, int(tr["sample_calls"]))
    bad = torch.zeros((), dtype=torch.int32, device=r.device)
    latencies = []
    model_s = serve.total

    t0 = r.end_setup()
    while time.perf_counter() - t0 < r.seconds:
        inputs = pool[len(latencies) % len(pool)]
        start = time.perf_counter()
        outs, _depth = request(inputs)
        latencies.append(time.perf_counter() - start)
        bad += common.nonfinite(outs)
        sample.offer((inputs, outs))
    r.sync()
    n = len(latencies)
    r.e2e["serve_p50_ms"] = statistics.median(latencies) * 1e3
    r.attempted, r.failed = n, int(bad)
    r.values["request_ms"] = statistics.fmean(latencies) * 1e3
    r.values["model_ms"] = (serve.total - model_s) / n * 1e3
    r.note(f"requests {n}, p50 {r.e2e['serve_p50_ms']:.4f} ms, "
           f"p95 {float(np.percentile(latencies, 95)) * 1e3:.4f} ms")
    r.read_memory()

    if r.trace:
        k = int(tr["trace_calls"])

        def body() -> int:
            for i in range(k):
                request(pool[i % len(pool)])
            return k * b

        r.profile(body, k)
        r.read_memory()
    del net, serve
    core.release()
    common.serving_checks(r, [([t.to(r.device) for t in inputs], outs)
                              for inputs, outs in sample.kept])
