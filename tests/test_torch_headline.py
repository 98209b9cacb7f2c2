"""``dffx_torch.headline``, the port's counterpart of the root ``bench.py``, on
the CPU at small sizes: the forward and train-step closures it times against
``dffx`` on the same parameters and inputs, its fallback on running out of
device memory and nothing else, its budget and its exit codes.

The measured functions run with ``device="cpu"`` and fp32 here; ``main``
runs only on a card, so its tests stand fast fakes in for the measurements
(the sandbox has none) and check what it prints and returns.  The JAX
forwards run ``dffx``'s packed graph where the port's does, on its XLA path
(the plain reference of its Pallas kernels: ``tests/test_torch_dffnet.py``
and ``test_torch_alignnet.py`` hold the port against the interpreted
kernels); the JAX train step is compiled once for the module."""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dffx.models import Ctx, dffnet_apply, e2e_apply, e2e_network_specs, network_specs
from dffx.models import init_params as jinit
from dffx.train import LossConfig as JLossConfig
from dffx.train import create_train_state as jcreate, make_train_step as jmake
from dffx_torch import headline as hl
from dffx_torch.checkpoint import jax_layout
from dffx_torch.ops import kernels as tk
from torch_fixtures import one_thread

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
HEADS = ("mid", "pred1", "pred2", "pred3")
#: a train step's gradients and update against dffx's (tests/test_torch_train.py)
GRAD_RTOL, GRAD_ATOL, GRAD_L2 = 0.25, 1e-7, 0.05
UPDATE_ATOL = 2.5e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def test_module_without_a_card_exits_1_with_one_null_line():
    proc = subprocess.run([sys.executable, "-m", "dffx_torch.headline"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec == {"metric": hl.METRIC, "value": None, "unit": "stacks/s", "vs_baseline": None,
                   "error": "no CUDA device"}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_serving_closure_matches_dffnet_apply(packed):
    """b2 of 10 x 64 x 64 in fp32 through the bench's inputs and network
    (seed 0, ``load_jax_params``) against ``dffnet_apply`` on the same
    ``init_params`` and the same graph: 1e-4 on every head."""
    fs, fd = hl.dffnet_inputs(2, (10, 64, 64), torch.float32, CPU, hl.generator(CPU))
    net = hl.Counted(hl.serving_net(packed, CPU))
    tk.reset_launches()
    with torch.inference_mode():
        got = net(fs, fd)
    hl.check_heads(got, fd, (2, 64, 64), "test")
    assert net.calls == 1 and tk.launches == dict.fromkeys(tk.launches, 0)
    forward = jax.jit(lambda p, x, d: dffnet_apply(p, x, d, Ctx(use_packed=packed)))
    ref = forward(jinit(network_specs(), seed=hl.SEED), jnp.asarray(_np(fs)),
                  jnp.asarray(_np(fd)))
    for name, g, r in zip(HEADS, got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=1e-4, err_msg=name)


def test_e2e_closure_matches_e2e_apply():
    """The end-to-end point's inputs and packed network at 1 x 10 x 64 x 96
    (``test_torch_alignnet.py``'s size) against ``e2e_apply`` with the packed
    tail: 1e-4 on the heads, 2e-5 on the warped stack."""
    fs, fd, fovs = hl.e2e_inputs((10, 64, 96), torch.float32, CPU, hl.generator(CPU))
    with torch.inference_mode():
        got = hl.serving_net(True, CPU, arch="e2e")(fs, fd, fovs)
    hl.check_heads(got, fd, (1, 64, 96), "test")
    forward = jax.jit(lambda p, x, d, v: e2e_apply(p, x, d, v, Ctx(use_packed=True)))
    ref = forward(jinit(e2e_network_specs(), seed=hl.SEED),
                  *(jnp.asarray(_np(t)) for t in (fs, fd, fovs)))
    for name, g, r in zip(HEADS, got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=1e-4, err_msg=name)
    np.testing.assert_allclose(_np(got[4]), np.asarray(ref[4]), atol=2e-5, err_msg="warped")


TRAIN_B, TRAIN_SHAPE = 2, (10, 32, 32)


@pytest.fixture(scope="module")
def jax_train_step():
    """``dffx``'s step on the bench's batch: (its batch, new params, logs with grads)."""
    _, _, batch = hl.train_setup(TRAIN_B, device=CPU, dtype=torch.float32, shape=TRAIN_SHAPE)
    batch = {k: _np(v) for k, v in batch.items()}
    params = {k: np.asarray(v) for k, v in jinit(network_specs(), seed=hl.SEED).items()}
    step = jmake(hl.LR, JLossConfig(), donate=False, debug_grads=True)
    state, logs = step(jcreate({k: jnp.asarray(v) for k, v in params.items()}, hl.LR),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, params, logs


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_matches_dffx(jax_train_step, remat):
    """The bench's step (``make_train_step(1e-4, LossConfig())``, fp32) at b2
    of 10 x 32 x 32 against ``dffx.train.make_train_step``: the loss within
    1e-5, each gradient within ``test_torch_train.py``'s bound of
    ``jax.grad``'s, and the new parameters Adam's first step on the port's
    own gradients, ``p - lr g / (|g| + eps)`` (``test_torch_train.py`` holds
    that step to optax's)."""
    jbatch, params, jlogs = jax_train_step
    state, step, batch = hl.train_setup(TRAIN_B, remat=remat, device=CPU, dtype=torch.float32,
                                        shape=TRAIN_SHAPE)
    for k, v in batch.items():
        np.testing.assert_array_equal(_np(v), jbatch[k], err_msg=k)
    state, logs = step(state, batch)
    np.testing.assert_allclose(float(logs["loss"]), float(jlogs["loss"]), rtol=1e-5)
    model = state.model
    grads = jax_layout(model, {k: p.grad for k, p in model.named_parameters()})
    assert len(grads) == 198
    num = den = 0.0
    for k, g in grads.items():
        want = np.asarray(jlogs["grads"][k])
        gap, scale = np.abs(g - want).max(), np.abs(want).max()
        assert gap <= GRAD_RTOL * scale + GRAD_ATOL, (k, gap, scale)
        num, den = num + float(((g - want) ** 2).sum()), den + float((want ** 2).sum())
    assert num <= GRAD_L2 ** 2 * den, (num / den) ** 0.5
    got = jax_layout(model, dict(model.named_parameters()))
    for k, g in grads.items():
        want = params[k] - np.float32(hl.LR) * g / (np.abs(g) + np.float32(1e-8))
        np.testing.assert_allclose(got[k], want, rtol=0, atol=UPDATE_ATOL, err_msg=k)


def _raising_at(monkeypatch, batch: int, error: Exception) -> list:
    """Make every serving network raise ``error`` on a stack of ``batch``;
    returns the batches the networks were called with."""
    seen, make = [], hl.serving_net

    def serving_net(packed, dev, arch="dffnet"):
        net = make(packed, dev, arch)

        def forward(fs, *rest):
            seen.append(int(fs.shape[0]))
            if fs.shape[0] == batch:
                raise error
            return net(fs, *rest)
        return forward

    monkeypatch.setattr(hl, "serving_net", serving_net)
    return seen


SMALL = dict(device=CPU, dtype=torch.float32, shape=(5, 32, 32), repeats=1, window=0.0)


def test_b128_out_of_memory_falls_back_to_64(monkeypatch, capsys):
    seen = _raising_at(monkeypatch, 128, torch.cuda.OutOfMemoryError("out of memory"))
    got = hl.bench_dffx(points=((128, 1, (True,)),), **SMALL)
    assert got["b128_actual_batch"] == 64 and got["best"] == got["b128_stacks_per_sec"] > 0
    assert seen[0] == 128 and set(seen[1:]) == {64}
    err = capsys.readouterr().err.splitlines()
    assert "# b128: batch 128 ran out of device memory; falling back" in err
    info = json.loads(err[-1])
    assert info["detail"] == "b128" and info["batch"] == 64 and info["forwards"] == 3


def test_other_errors_at_b128_propagate(monkeypatch):
    seen = _raising_at(monkeypatch, 128, RuntimeError("cuDNN error"))
    with pytest.raises(RuntimeError, match="cuDNN error") as info:
        hl.bench_dffx(points=((128, 1, (True,)),), **SMALL)
    assert not isinstance(info.value, torch.cuda.OutOfMemoryError)
    assert seen == [128]


def test_serving_points_count_forwards_and_report_medians(capsys):
    got = hl.bench_dffx(points=((1, 2, (True,)), (2, 1, (True, False))),
                        **{**SMALL, "repeats": 2})
    details = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()]
    assert [d["detail"] for d in details] == ["b1", "b2"]
    assert [d["forwards"] for d in details] == [1 + 2 * 3, 2 * (1 + 2 * 2)]
    assert all(d["launches"] == dict.fromkeys(tk.launches, 0) for d in details)
    lo, hi = got["b1_stacks_per_sec_spread"]
    assert lo <= got["b1_stacks_per_sec"] <= hi
    assert got["b2_stacks_per_sec"] == max(got["b2_packed_stacks_per_sec"],
                                           got["b2_unpacked_stacks_per_sec"])
    assert "b1_actual_batch" not in got and "b1_packed_stacks_per_sec" not in got
    assert [d["iters"] for d in details] == [[2], [1, 1]]


@pytest.mark.parametrize("window", [0.0, 0.05], ids=["iters", "window"])
def test_a_window_sets_the_calls_of_a_repeat(window):
    """Without a window a repeat runs ``iters`` calls; with one, a first timed
    run of ``iters`` calls sets as many as fill it (5 ms and more a call here:
    at most 10), each repeat after its warm call."""
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.005)

    iters, rates = hl.timed_rates(fn, (torch.zeros(1),), 2, 3, 4, window)
    assert len(rates) == 3 and all(0 < r <= 4 / 0.005 for r in rates)
    if window:
        assert 2 <= iters <= 10 and len(calls) == (1 + 2) + 3 * (1 + iters)
    else:
        assert iters == 2 and len(calls) == 3 * (1 + 2)


def test_simulator_repeats_fill_their_window(capsys):
    """Each repeat runs scenes until both ``iters`` scenes and ``window``
    seconds have passed: no repeat's rate is above its scenes over the window."""
    got = hl.bench_simulator(device="cpu", iters=1, repeats=2, window=0.5)
    info = json.loads(capsys.readouterr().err.splitlines()[-1])
    assert info["detail"] == "simulator" and info["launches"] == dict.fromkeys(tk.launches, 0)
    assert len(info["iters"]) == 2 and min(info["iters"]) >= 1
    assert info["scenes"] == 1 + sum(info["iters"])
    lo, hi = got["simulator_scenes_per_sec_spread"]
    assert 0 < lo <= got["simulator_scenes_per_sec"] <= hi <= max(info["iters"]) / 0.5


def _fp32_kernel(twin, error: float = 0.0):
    """A kernel as the card computes it: the twin in fp32 on the rounded
    input, rounded once to the input's dtype (plus ``error``)."""
    return lambda x, *args, **kw: (twin(x.float(), *args) + error).to(x.dtype)


SMALL_GATE = tuple((name, min(b, 2), c, n, 16, 24) for name, b, c, n, _, _ in hl.GATE_CASES)
GATE_CHECKS = 2 * len(hl.GATE_CASES)


def test_kernel_gate_passes_a_right_kernel_and_names_a_wrong_one(smoke, monkeypatch):
    names = {name for name, *_ in hl.GATE_CASES}
    # the gate runs the five that replace a Pallas kernel in fp32 and bf16
    assert names == set(smoke.PORTED) and set(smoke.KERNELS) == set(tk.launches)
    for name in names:
        monkeypatch.setattr(tk, name, _fp32_kernel(getattr(tk, f"{name}_ref")))
    got = hl.kernel_gate(device=CPU, cases=SMALL_GATE)
    assert got == {"kernel_gate": "pass", "kernel_gate_checks": GATE_CHECKS,
                   "kernel_gate_failures": []}
    monkeypatch.setattr(tk, "rb2d_residual", _fp32_kernel(tk.rb2d_residual_ref, 2e-4))
    got = hl.kernel_gate(device=CPU, cases=SMALL_GATE)
    assert got["kernel_gate"] == "fail" and got["kernel_gate_checks"] == GATE_CHECKS
    assert [(f["kernel"], f["in"][0], f["dtype"]) for f in got["kernel_gate_failures"]] == [
        ("rb2d_residual", 1, "float32"), ("rb2d_residual", 2, "float32")]


def test_reference_cpu_rate_is_the_cached_one(monkeypatch, tmp_path):
    cached = json.loads((ROOT / ".bench_cpu_baseline.json").read_text())["stacks_per_sec"]
    assert hl.bench_reference_cpu() == cached
    monkeypatch.setattr(hl, "CPU_BASELINE", tmp_path / "absent.json")
    assert hl.bench_reference_cpu() is None


@pytest.fixture
def fake_card(monkeypatch):
    """``main`` on the CPU: a card is 'found', and each measurement is a fast
    fake; returns the names of the sections that ran, in order."""
    ran = []
    monkeypatch.setattr(hl, "probe_backend", lambda: True)
    monkeypatch.setattr(hl, "cli_device", lambda name: CPU)
    monkeypatch.setattr(hl, "nvidia_smi", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")

    def bench_dffx(progress=None, **kw):
        res = {}
        for b, rate in ((1, 100.0), (4, 300.0), (128, 400.0)):
            res.update({f"b{b}_stacks_per_sec": rate, "best": rate})
            progress(dict(res))
        return res

    def section(name, result):
        def run(*args, **kw):
            ran.append(name)
            return result
        return run

    monkeypatch.setattr(hl, "bench_dffx", bench_dffx)
    monkeypatch.setattr(hl, "kernel_gate", section("kernel_gate", {"kernel_gate": "pass"}))
    monkeypatch.setattr(hl, "bench_train", lambda b=32, remat=False, **kw: section(
        f"train_b{b}", {f"train_b{b}_stacks_per_sec": 1.0})())
    monkeypatch.setattr(hl, "bench_e2e", section("e2e", {"e2e_ms_per_stack": 40.0}))
    monkeypatch.setattr(hl, "bench_simulator", section("simulator",
                                                       {"simulator_scenes_per_sec": 10.0}))
    return ran


def _records(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines()]


def test_tiny_budget_skips_every_section(fake_card, capsys):
    assert hl.main(["--budget", "0.001"]) == 0
    recs = _records(capsys.readouterr().out)
    assert [r.get("partial", False) for r in recs[:3]] == [True] * 3
    assert not any(r.get("partial") for r in recs[3:])
    last = recs[-1]
    assert last["skipped_sections"] == [name for name, _ in hl.SECTIONS]
    assert fake_card == []
    assert last["value"] == 400.0 and last["platform"] == "gpu"
    assert last["vs_baseline"] == 400.0 / hl.bench_reference_cpu()
    assert len(recs) == 3 + 1 + len(hl.SECTIONS)


def test_every_section_runs_within_the_budget(fake_card, capsys):
    assert hl.main(["--budget", "1e9"]) == 0
    recs = _records(capsys.readouterr().out)
    assert fake_card == ["kernel_gate", "train_b128", "e2e", "train_b32", "simulator"]
    last = recs[-1]
    assert "skipped_sections" not in last and not any(k.endswith("_error") for k in last)
    assert last["e2e_ms_per_stack"] == 40.0 and last["train_b128_stacks_per_sec"] == 1.0


@pytest.mark.parametrize("fault", ["e2e_raises", "gate_fails"])
def test_a_failed_section_is_recorded_and_fails_the_run(fake_card, monkeypatch, capsys, fault):
    if fault == "e2e_raises":
        def boom(**kw):
            raise RuntimeError("boom")
        monkeypatch.setattr(hl, "bench_e2e", boom)
    else:
        monkeypatch.setattr(hl, "kernel_gate", lambda **kw: {
            "kernel_gate": "fail", "kernel_gate_checks": 12, "kernel_gate_failures": [{}]})
    assert hl.main(["--budget", "1e9"]) == 1
    recs = _records(capsys.readouterr().out)
    assert len(recs) == 3 + 1 + len(hl.SECTIONS)  # re-printed after every section
    last = recs[-1]
    if fault == "e2e_raises":
        assert last["e2e_error"] == "RuntimeError: boom"
        assert fake_card == ["kernel_gate", "train_b128", "train_b32", "simulator"]
    else:
        assert last["kernel_gate"] == "fail" and "simulator_scenes_per_sec" in last


# ---------------------------------------------------------------------------
# chip_smoke.py's headline phase and bf16 bound, on canned output
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _canned_headline(smoke, fault: str):
    """What ``python3 -m dffx_torch.headline`` prints on a card, with ``fault``."""
    zero = dict.fromkeys(smoke.KERNELS, 0)
    per = {"b1": ("dffnet", 106), "b4": ("dffnet", 92), "b128": ("dffnet", 42),
           "e2e": ("e2e", 36)}
    details = [{"detail": p, "dtype": "bfloat16", "forwards": n,
                "launches": {**zero, **smoke.want_launches(net, "bfloat16", n)}}
               for p, (net, n) in per.items()]
    details += [{"detail": p, "steps": 25, "launches": dict(zero)}
                for p in ("train_b128_remat", "train_b32", "simulator")]
    details += [{"detail": "section", "name": n} for n in smoke.HEADLINE_SECTIONS]
    last = {"metric": hl.METRIC, "value": 254.7, "platform": "gpu", "kernel_gate": "pass",
            **dict.fromkeys(smoke.HEADLINE_RESULTS, 1.0)}
    rc = 0
    if fault == "partial_last":
        last["partial"] = True
    elif fault == "skipped":
        last["skipped_sections"] = ["simulator"]
    elif fault == "gate_failed":
        last["kernel_gate"] = "fail"
    elif fault == "section_error":
        last["e2e_error"] = "RuntimeError: boom"
        rc = 1
    elif fault == "missing_b128":
        del last["b128_stacks_per_sec"]
    elif fault == "serving_launches":
        details[2]["launches"]["srd_attention_residual"] -= 1
    elif fault == "bn_act_launches":
        details[3]["launches"]["bn_act"] += 1
    elif fault == "train_launches":
        details[4]["launches"]["rb2d_residual"] = 1
    records = [{**last, "partial": True}, last]
    stderr = "\n".join(["# b128: a note"] + [json.dumps(d) for d in details])
    return subprocess.CompletedProcess([], rc, "\n".join(map(json.dumps, records)), stderr)


@pytest.mark.parametrize("fault", ["none", "partial_last", "skipped", "gate_failed",
                                   "section_error", "missing_b128", "serving_launches",
                                   "bn_act_launches", "train_launches"])
def test_chip_smoke_headline_phase_checks(smoke, monkeypatch, capsys, fault):
    """The phase passes the headline's output only when the last record is
    complete, has every point and section, a passed gate and no error, and
    each point launched exactly its forwards' kernels (none in training and
    the simulator); it returns each kernel's launches over the points."""
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        return _canned_headline(smoke, fault)

    monkeypatch.setattr(smoke.subprocess, "run", run)
    if fault == "none":
        got = smoke.phase_headline(torch, "NVIDIA H100 80GB HBM3, 700.00 W")
        assert got == {"fm_conv_bn_relu": 276, "rb2d_residual": 276,
                       "srd_attention_residual": 276, "rb_of_chain": 108,
                       "motion_head_conv_chain": 36, "bn_act": 55 * 240 + 65 * 36,
                       "bn_act_pool": 0}
    else:
        with pytest.raises(RuntimeError, match="headline"):
            smoke.phase_headline(torch, "NVIDIA H100 80GB HBM3, 700.00 W")
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "dffx_torch.headline", "--budget", str(smoke.HEADLINE_BUDGET)]
    assert kw["timeout"] == smoke.HEADLINE_TIMEOUT and kw["cwd"] == ROOT
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "headline" and line["device"].startswith("NVIDIA")


def test_chip_smoke_bf16_bound(smoke):
    fp32 = [torch.tensor([1.0, -4.0]), torch.tensor([0.5, 2.0])]
    bf16 = [torch.tensor([1.2, -4.0]), torch.tensor([0.5, 2.1])]
    gaps = smoke.bf16_gaps(["mid", "pred3"], bf16, fp32)
    assert gaps == pytest.approx({"mid": 0.05, "pred3": 0.05})
    smoke.check_bf16_gaps("forward", gaps, {"mid": 0.06, "pred3": 0.06})
    with pytest.raises(RuntimeError, match="pred3"):
        smoke.check_bf16_gaps("forward", gaps, {"mid": 0.06, "pred3": 0.04})
    assert set(smoke.BF16_RTOL) == {"mid", "pred1", "pred2", "pred3", "warped", "motion"}
