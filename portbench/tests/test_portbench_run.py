"""The harness end to end on the CPU at small sizes: the result line's keys,
no result without a card, a sound run reads correct, every fault a cell can
have makes it read not correct, the control fails each cell's limits, the
four-rank path over gloo, and no process of a run loads JAX or the JAX
package."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import core, faults, networks, run
from portbench.drivers import common
from portbench.reference import lowp, weights

torch.set_num_threads(2)
BENCH = json.loads(core.BENCHMARK.read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"config": {"stack": [10, 64, 96], "train_stack": [10, 32, 32]},
         "traffic": {"pool": 3, "trace_calls": 2, "sample_calls": 2, "dtype": "float32"}}
#: the faults each kind of traffic can have
FAULTS = {"batch": ("answer", "half"), "single": ("answer",), "train": ("unchanged", "half"),
          "train_dp": ("unchanged", "half", "exchange")}
SEED = 2**31 + 977


def small(cell: str) -> dict:
    batch = 4 if "train" in cell else (1 if "single" in cell else 2)
    return {"config": SMALL["config"], "traffic": {**SMALL["traffic"], "batch": batch}}


def execute(cell: str, trace: bool = False, fault=None):
    return run.execute(cell, SEED, 0.5, trace, device="cpu", overrides=small(cell), fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_reads_correct(cell):
    r = execute(cell)
    out = run.result(r)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in r.cell.end_to_end}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(r.cell.limits)
    assert r.setup_s > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" not in c][:1] + [
    c for c in CELLS if "train" in c][:1])
def test_traced_run_has_a_breakdown(cell):
    out = run.result(execute(cell, trace=True))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in core.load_cell(cell).per_layer}
    assert set(out["metrics"]) <= names


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[core.load_cell(c).traffic["driver"]]
                                        if f != "exchange"])
def test_fault_reads_not_correct(cell, fault):
    out = run.result(execute(cell, fault=fault))
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("cell", [c for c in CELLS if core.load_cell(c).traffic["dtype"]
                                  == "bfloat16"])
def test_control_fails_the_limits(cell):
    """The control (the reference in fp8 in the program's place) against the
    reference in fp32, at a small size: at least one compared number over
    its limit.  (fp32 cells' TF32 control needs the card:
    ``test_portbench_gpu.py``.)"""
    c = core.load_cell(cell, {"config": {"stack": SMALL["config"]["stack"]}})
    net = networks.load(c.config["network"])
    params = weights.draw(net.specs(), SEED, "cpu")
    x = net.serving_inputs(c.config, 1, torch.float32, "cpu", torch.Generator().manual_seed(5))
    got = {}
    with torch.no_grad():
        want = net.reference(params, x)
        with lowp.control(c.traffic["dtype"]):
            low = net.reference(params, x)
    common._worst(got, net.SERVED, low, want)
    assert any(got[k] > limit for k, limit in c.limits.items()), (got, c.limits)


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout == ""


def test_no_process_loads_jax_or_the_jax_package():
    """A run of a serving cell and of a training cell, then every module of
    the harness: no top-level ``jax``, ``jaxlib``, ``flax`` or ``dffx``
    (``dffx_torch`` is another name); the reference alone loads nothing of
    the program."""
    serving = [c for c in CELLS if "train" not in c][0]
    training = [c for c in CELLS if "train" in c][0]
    code = (
        "import json, sys, pkgutil, importlib\n"
        "import portbench.reference.nets, portbench.reference.train, portbench.reference.lowp\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'dffx_torch')\n"
        "from portbench import run\n"
        "for cell, ov in json.loads(sys.argv[1]).items():\n"
        "    run.execute(cell, 5, 0.3, True, device='cpu', overrides=ov)\n"
        "import portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "print(json.dumps({'ref': ref, 'forbidden': run.forbidden_loaded(),\n"
        "                  'program': 'dffx_torch' in sys.modules}))\n")
    cells = json.dumps({c: small(c) for c in (serving, training)})
    out = subprocess.run([sys.executable, "-c", code, cells], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"ref": [], "forbidden": [], "program": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dffx_torch_like", sys)
    assert "dffx" not in run.forbidden_loaded() or "dffx" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib_extra.sub", sys)
    assert "jaxlib" not in run.forbidden_loaded() or "jaxlib" in sys.modules


def four_rank_checkout(tmp_path):
    """A copy of the benchmark whose BENCHMARK.json holds the four-rank cell
    (its traffic file and driver are the benchmark's own)."""
    root = tmp_path / "checkout"
    shutil.copytree(core.PACKAGE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(core.BENCHMARK.read_text())
    cell = "dffnet-ddff12.train-dp4-fp32"
    if cell not in [w["name"] for w in bench["workloads"]]:
        bench["workloads"].append({"name": cell, "config": "dffnet-ddff12",
                                   "traffic": "train-dp4-fp32", "chips": 4, "why": "four ranks"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "dffnet-ddff12.train-b32-fp32" in m.get("workloads", []):
                m["workloads"].append(cell)
        for name, unit, source in (("collective_ms.train", "ms", "device_trace"),
                                   ("collective_mb.train", "MB", "program_counter")):
            if name not in [m["name"] for m in bench["per_layer"]]:
                bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                           "source": source, "layer": "processes",
                                           "moves": "train_stacks_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = root / "portbench" / "limits" / f"{cell}.json"
    if not limits.is_file():
        shutil.copy(core.PACKAGE / "limits" / "dffnet-ddff12.train-b32-fp32.json", limits)
    return root, cell


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_four_ranks_over_gloo(tmp_path, fault):
    """Rank 0 starts three more ranks, the window ends on rank 0's clock, and
    rank 0 alone prints the line; the gradient exchange left out reads not
    correct."""
    root, cell = four_rank_checkout(tmp_path)
    ov = {"config": SMALL["config"], "traffic": {**SMALL["traffic"], "batch": 8}}
    argv = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(SEED),
            "--seconds", "0.5", "--trace", "1", "--device", "cpu", "--overrides", json.dumps(ov)]
    if fault:
        argv += ["--fault", fault]
    env = {**os.environ, "PYTHONPATH": str(core.ROOT), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    line = lines[0]
    assert line["device"]["count"] == 4 and "collective_mb.train" in line["metrics"]
    assert line["correct"] is (fault is None), line["checks"]


def test_faults_are_known():
    assert set(faults.FAULTS) == {f for fs in FAULTS.values() for f in fs}
    with pytest.raises(ValueError):
        faults.plant("nothing", False, 3)
