"""Batched serving on device-resident stacks: a closed loop of the program's
serving entry (``TimedForward``) on a pool of distinct batches made on the
card from the seed, so that no input copy is in the window.

Traffic keys: ``batch``, ``dtype``, ``pool`` (distinct batches, cycled),
``sample_calls`` and ``sample_rows`` (the window's answers held to the
reference: calls drawn from the seed, rows of each), ``trace_calls``.
End to end: ``serve_stacks_per_s``, the stacks of every forward of the
window over the window's seconds, the window ending in a synchronise."""

from __future__ import annotations

import time

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
    net = common.program_network(cfg, common.draw_weights(r), r.device)
    serve = TimedForward(net, dtype=dtype)
    r.mark("weights and model")
    gen = r.generator("inputs")
    pool = [serving_inputs(cfg, b, dtype, r.device, gen) for _ in range(int(tr["pool"]))]
    r.mark("inputs")
    for inputs in pool[:2]:  # builds the kernels, packs the weights, picks cuDNN's algorithms
        serve(*inputs)
    sample = common.Sample(r.seed, int(tr["sample_calls"]))
    bad = torch.zeros((), dtype=torch.int32, device=r.device)

    t0 = r.end_setup()
    calls = 0
    while time.perf_counter() - t0 < r.seconds:
        inputs = pool[calls % len(pool)]
        outs = serve(*inputs)
        bad += common.nonfinite(outs)
        sample.offer((inputs, outs))
        calls += 1
    r.sync()
    window = time.perf_counter() - t0
    r.e2e["serve_stacks_per_s"] = calls * b / window
    r.attempted, r.failed = calls, int(bad)
    r.read_memory()

    if r.trace:
        n = int(tr["trace_calls"])

        def body() -> int:
            for i in range(n):
                serve(*pool[i % len(pool)])
            return n * b

        r.profile(body, n)
        r.read_memory()
    del net, serve
    core.release()

    rows_each = int(tr["sample_rows"])
    rng = sample.rng
    rows = []
    for inputs, outs in sample.kept:
        for i in rng.sample(range(b), min(rows_each, b)):
            rows.append(([t[i:i + 1] for t in inputs], [o[i:i + 1] for o in outs]))
    common.serving_checks(r, rows)
