"""``dffx_torch.utils.profiling`` against ``dffx.utils.profiling`` on the CPU:
``StepTimer``'s arithmetic over a scripted clock, ``device_loop_time``'s
calls and ``trace``'s file."""

import json
import os

import pytest
import torch

from dffx.utils import profiling as jprof
from dffx_torch.utils import profiling as tprof

#: a scripted perf_counter: (enter, exit) of each step
TICKS = [0.0, 0.5, 1.0, 1.25, 2.0, 3.0, 3.5, 3.6]


@pytest.mark.parametrize("ema", [0.9, 0.5])
def test_step_timer_matches_dffx(monkeypatch, ema):
    timers = {}
    for name, mod in (("port", tprof), ("dffx", jprof)):
        clock = iter(TICKS)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(ema=ema)
        assert timer.avg == 0.0 and timer.items_per_sec(4) == 0.0
        for _ in range(len(TICKS) // 2):
            with timer:
                pass
        timers[name] = timer
    got, want = timers["port"], timers["dffx"]
    assert (got.avg, got.total, got.count, got._last) == (want.avg, want.total, want.count,
                                                           want._last)
    assert got.items_per_sec(10) == want.items_per_sec(10) > 0


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
