"""The program's spans and counters (``dffx_torch.utils.profiling``) on the
CPU: off they do nothing, self time over a scripted clock, two threads at
once, the spans each layer fires (DFFNet, E2E, the train step, the
prefetch, the serving entry) and their place in ``trace()``'s Chrome
trace."""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch import nn

from dffx_torch.data.pipeline import device_prefetch
from dffx_torch.eval import common
from dffx_torch.eval.common import TimedForward, stage_plan
from dffx_torch.models import E2ENetwork, Network
from dffx_torch.train import LossConfig, create_train_state, make_train_step
from dffx_torch.utils import profiling

CPU = torch.device("cpu")
DFFNET = ("dffnet.features", "dffnet.aggregate", "dffnet.full_res")
ALIGN = ("align.features", "align.motion", "align.warp")


@pytest.fixture(autouse=True)
def fresh():
    torch.set_num_threads(2)
    profiling.reset()
    assert not profiling.enabled()
    yield
    profiling.reset()


def stack(h=64, w=96, b=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    fs = torch.rand((b, 10, h, w, 3), generator=g) * 2 - 1
    return fs, torch.linspace(0.1, 1.0, 10).expand(b, -1), torch.linspace(1.0, 1.02, 10
                                                                          ).expand(b, -1)


class Doubler(nn.Module):
    """A model of one op a forward, on the device of its one parameter."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.w = nn.Parameter(torch.ones(1, device=device))

    def forward(self, fs, focus_dists, *rest):
        return (torch.relu(fs * 2),)


class Capture(nn.Module):
    """A model that hands back the inputs it got, on the device of its one
    parameter."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.w = nn.Parameter(torch.ones(1, device=device))

    def forward(self, *inputs):
        return inputs


def test_off_a_span_does_one_flag_test(monkeypatch):
    """No profiler and no ``collect()``: a served DFFNet forward opens no
    ``record_function``, reads no span clock, makes no CUDA event and no
    span object, and leaves no total; every span is the one shared no-op."""

    def boom(*a, **k):
        raise AssertionError("a span did work while off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=boom))
    monkeypatch.setattr(profiling, "_Span", boom)
    serve = TimedForward(Network().eval())
    fs, fd, _ = stack()
    serve(fs.numpy(), fd.numpy())
    profiling.count("anything", 3)
    assert profiling.spans() == {} and profiling.counters() == {}
    assert profiling.span("a", CPU) is profiling.span("b", "cuda")


def test_self_time_over_a_scripted_clock(monkeypatch):
    """a { b {} c { d {} } } then b again: self time is a span's host time
    less what its children cover; on the CPU device time is host time."""
    ticks = iter([0, 10, 25, 30, 32, 40, 50, 100, 200, 204])
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    with profiling.collect():
        with profiling.span("a", CPU):
            with profiling.span("b", CPU):
                pass
            with profiling.span("c", CPU):
                with profiling.span("d", CPU):
                    pass
        with profiling.span("b", CPU):
            pass
    ns = 1e-9
    want = {"a": (1, 100, 65), "b": (2, 19, 19), "c": (1, 20, 12), "d": (1, 8, 8)}
    got = profiling.spans()
    assert set(got) == set(want)
    for name, (count, host, own) in want.items():
        assert got[name][0] == count
        assert got[name][1:] == pytest.approx((host * ns, own * ns, host * ns), abs=1e-15)


class FakeEvent:
    """A CUDA timing event's stand-in: done or not, 2 ms after its start."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        return 2.0


def test_pending_device_spans_fold_without_waiting(monkeypatch):
    """Once enough CUDA spans wait to be read, those the device has
    finished fold into the totals and the rest stay pending, with no
    wait; reading the totals then waits for the rest."""
    monkeypatch.setattr(profiling, "_fold_at", 4)
    ends = [FakeEvent(done=i % 2 == 0) for i in range(4)]
    with profiling.collect():
        for end in ends:
            with profiling.span("s", "cuda", events=(FakeEvent(True), end)):
                pass
    assert [e for _, _, e in profiling._pending] == ends[1::2]
    assert not any(e.waited for e in ends)
    assert profiling.spans()["s"][0::3] == (4, pytest.approx(0.008))
    assert [e.waited for e in ends] == [False, True, False, True]
    assert profiling._pending == []


def test_spans_from_threads_at_once():
    """Eight threads nest ``outer { inner }`` and count, all at once, with a
    short switch interval: no update is lost, and each thread's inner span
    is its own outer's child."""
    threads, rounds = 8, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=30)
        for _ in range(rounds):
            with profiling.span("outer", CPU):
                with profiling.span("inner", CPU):
                    profiling.count("rounds")

    try:
        with profiling.collect():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = profiling.spans()
    assert got["outer"][0] == got["inner"][0] == threads * rounds
    assert profiling.counters() == {"rounds": threads * rounds}
    outer, inner = got["outer"], got["inner"]
    assert outer[2] == pytest.approx(outer[1] - inner[1], abs=1e-6)
    assert inner[2] == inner[1]


def test_dffnet_and_e2e_forwards_fire_their_spans():
    """Under ``collect()`` a DFFNet forward (10x64x96) fires its three
    stages once each; an E2E forward fires ``e2e.align`` over the three
    ``align.*`` and ``e2e.depth`` over DFFNet's three, each parent's self
    time its own time less its children's."""
    fs, fd, fovs = stack()
    with torch.inference_mode(), profiling.collect():
        Network().eval()(fs, fd)
    got = profiling.spans()
    assert {k: v[0] for k, v in got.items()} == dict.fromkeys(DFFNET, 1)
    profiling.reset()
    with torch.inference_mode(), profiling.collect():
        E2ENetwork().eval()(fs, fd, fovs)
    got = profiling.spans()
    assert {k: v[0] for k, v in got.items()} == dict.fromkeys(
        ("e2e.align", "e2e.depth") + ALIGN + DFFNET, 1)
    for parent, children in (("e2e.align", ALIGN), ("e2e.depth", DFFNET)):
        covered = sum(got[c][1] for c in children)
        assert got[parent][2] == pytest.approx(got[parent][1] - covered, abs=1e-6)
        assert 0 <= got[parent][2] < got[parent][1]


def test_train_step_fires_forward_backward_optimizer():
    """Two steps without a group: forward, backward and optimizer twice
    each, no ``train.exchange``."""
    torch.manual_seed(0)
    state = create_train_state(Network(), 1e-4)
    step = make_train_step(1e-4, LossConfig())
    fs, fd, _ = stack(32, 32, b=2)
    batch = {"fs": fs, "focus_dists": fd.contiguous(), "depth": torch.rand(2, 32, 32) + 0.1,
             "mask": torch.ones(2, 32, 32, dtype=torch.bool)}
    with profiling.collect():
        for _ in range(2):
            state, _ = step(state, batch)
    got = profiling.spans()
    assert {k: got[k][0] for k in got if k.startswith("train.")} == {
        "train.forward": 2, "train.backward": 2, "train.optimizer": 2}
    assert got["dffnet.features"][0] == 2  # the forward's own, under train.forward


@pytest.mark.parametrize("taken", [5, 2])
def test_prefetch_counts_the_batches_consumed(taken):
    """``prefetch.wait`` opens once a batch the consumer took (all five, or
    two before it let go) and once for the end; the producer made at least
    those under ``prefetch.produce``; no counter counts."""
    batches = ({"fs": np.full((2, 3), i, np.float32)} for i in range(5))
    running = threading.active_count()
    with profiling.collect():
        feed = device_prefetch(batches, "cpu", ("fs",))
        got = [int(on_device["fs"][0, 0]) for _, (_, on_device) in zip(range(taken), feed)]
        if taken == 5:
            assert next(feed, None) is None
        feed.close()
        deadline = time.monotonic() + 30  # the producer sees the close and ends
        while threading.active_count() > running and time.monotonic() < deadline:
            time.sleep(0.01)
    assert threading.active_count() == running
    assert got == list(range(taken))
    spans = profiling.spans()
    assert profiling.counters() == {}
    assert spans["prefetch.wait"][0] == taken + (taken == 5)  # and the end's
    assert spans["prefetch.produce"][0] >= taken


def test_timed_forward_counts_the_staged_bytes():
    """Inputs that come to the model's device from elsewhere count as
    staged, at the size the model gets them: a model on the meta device
    stands in for the card.  Inputs already on the model's device stage nothing."""
    fs, fd, fovs = stack()
    serve = TimedForward(Doubler("meta"), dtype=torch.bfloat16)
    with profiling.collect():
        serve(fs.numpy(), fd, fovs)
    want = fs.numel() * 2 + fd.numel() * 4 + fovs.numel() * 4
    assert profiling.counters() == {"serve.staged_bytes": want}
    assert {k: v[0] for k, v in profiling.spans().items()} == {"serve.stage_in": 1,
                                                               "serve.forward": 1}
    profiling.reset()
    with profiling.collect():
        TimedForward(Doubler())(fs, fd)
    assert profiling.counters() == {"serve.staged_bytes": 0}


@pytest.mark.parametrize("host", ["tensor", "numpy"])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_off_the_card_inputs_stage_as_before(device, host, monkeypatch):
    """With the model on the meta device or the CPU nothing is pinned: each
    input goes through ``.to(device, dtype)``, ``serve.staged_bytes`` counts
    what crossed, and ``serve.staged_pinned`` never fires."""

    def boom(*a, **k):
        raise AssertionError("a stage-in off the card went through pinned memory")

    monkeypatch.setattr(common._PinnedStage, "__call__", boom)
    fs, fd, fovs = stack()
    serve = TimedForward(Capture(device), dtype=torch.bfloat16)
    assert serve._pinned is None
    args = (fs, fd, fovs) if host == "tensor" else (fs.numpy(), fd.numpy(), fovs.numpy())
    with profiling.collect():
        got = serve(*args)
    want = [fs.to(device, torch.bfloat16), fd.to(device), fovs.to(device)]
    for g, w in zip(got, want):
        assert (g.device, g.dtype, g.shape) == (w.device, w.dtype, w.shape)
        if device == "cpu":
            assert torch.equal(g, w)
    moved = sum(w.nbytes for w in want) if device == "meta" else 0
    assert profiling.counters() == {"serve.staged_bytes": moved}


def _layout(layout, shape):
    """A float32 tensor of ``shape`` (B, N, H, W, C) holding 0, 1, 2, ... in
    its logical order, laid out as ``layout`` says."""
    b, n, h, w, c = shape
    values = torch.arange(b * n * h * w * c, dtype=torch.float32).reshape(shape)
    if layout == "contiguous":
        return values
    if layout == "channels_first":  # (B, C, N, H, W) in memory
        return values.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    wide = torch.zeros((b, n, h, 2 * w, c))  # every other column of a wider stack
    wide[:, :, :, ::2] = values
    return wide[:, :, :, ::2]


@pytest.mark.parametrize("layout", ["contiguous", "channels_first", "strided"])
@pytest.mark.parametrize("b", [1, 3])
def test_stage_plan_covers_each_slice_once_in_order(b, layout):
    """The stage-in's plan of a (B, N, H, W, C) stack is its (b, n) slices in
    row-major order; copying a source slice by slice through it, whatever
    the source's strides, writes every value once and gives the source."""
    shape = (b, 4, 6, 5, 3)
    src = _layout(layout, shape)
    assert src.is_contiguous() == (layout == "contiguous")
    plan = stage_plan(src.shape)
    assert plan == [(i, j) for i in range(b) for j in range(4)]
    out, hits = torch.full(shape, -1.0), torch.zeros(shape, dtype=torch.int64)
    for index in plan:
        out[index].copy_(src[index])
        hits[index] += 1
    assert torch.equal(out, src) and bool((hits == 1).all())


@pytest.mark.parametrize("shape,want", [
    ((3, 10), [()]), ((10,), [()]), ((6, 5, 3), [()]), ((2, 6, 5, 3), [(0,), (1,)])])
def test_stage_plan_takes_a_small_input_whole(shape, want):
    """Focus distances and fields of view ((B, N)) cross in one piece; an
    input of more than three dimensions is cut over the leading ones."""
    assert stage_plan(shape) == want


def test_trace_holds_the_spans_around_their_ops(tmp_path):
    """Under ``torch.profiler`` (``profiling.trace``) the spans record with
    no ``collect()``: the Chrome trace holds ``serve.forward`` as a user
    annotation, and the forward's ``aten::`` ops lie inside it on its
    thread."""
    fs, fd, _ = stack()
    serve = TimedForward(Doubler())
    with profiling.trace(str(tmp_path)):
        assert profiling.enabled()
        serve(fs, fd)
    assert not profiling.enabled()
    assert profiling.spans()["serve.forward"][0] == 1
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = next(e for e in events if e["name"] == "serve.forward")
    assert span["cat"] == "user_annotation"
    lo, hi = span["ts"], span["ts"] + span["dur"]
    inside = {e["name"] for e in events if e.get("cat") == "cpu_op" and e["tid"] == span["tid"]
              and lo <= e["ts"] and e["ts"] + e["dur"] <= hi}
    assert {"aten::mul", "aten::relu"} <= inside
