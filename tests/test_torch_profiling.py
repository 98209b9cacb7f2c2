"""``dffx_torch.utils.profiling`` on the CPU: ``device_loop_time``'s calls
and ``trace``'s file (its spans and counters: ``test_torch_spans.py``)."""

import json
import os

import torch

from dffx_torch.utils import profiling as tprof


def test_device_loop_time_on_the_cpu():
    calls = []

    def fn(x, y):
        calls.append(x.device.type)
        return x @ y

    x = torch.ones(64, 64)
    seconds = tprof.device_loop_time(fn, x, x, iters=5)
    assert calls == ["cpu"] * 6  # one warm call and five timed
    assert seconds > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    path = os.path.join(logdir, tprof.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
