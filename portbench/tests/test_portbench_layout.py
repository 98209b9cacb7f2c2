"""The benchmark's files: every configuration, network, traffic mix, driver,
limit and per-layer metric of ``BENCHMARK.json`` is found by name and
parses, every metric's ``moves`` is reported by each of its cells, the file
keeps the contract's shapes, and a new cell, or a new network with its
cell, can be added as new files and entries alone."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import core, networks

BENCH = json.loads(core.BENCHMARK.read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "-m"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        for key in ("why", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse(cell):
    c = core.load_cell(cell)
    assert networks.load(c.config["network"]).SERVED
    assert importlib.import_module(f"portbench.drivers.{c.traffic['driver']}").run
    assert c.limits, f"limits/{cell}.json"
    for m in c.per_layer:
        assert callable(core.metric_reader(m["name"]))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported, (cell, m["name"], m["moves"])


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (core.ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert c["reduced"] == []
    for m in BENCH["per_layer"]:
        assert (core.PACKAGE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(1 <= len(layer) <= 200 for layer in layers)


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A configuration, a traffic mix of a new kind with its driver, a
    per-layer metric, its limits and a cell, added in a copy as new files
    and new entries of BENCHMARK.json:
    the copy's harness finds all of them, and no existing file changed."""
    root = tmp_path / "checkout"
    shutil.copytree(core.PACKAGE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench = json.loads(core.BENCHMARK.read_text())
    (root / "portbench" / "configs" / "dummy.json").write_text(json.dumps(
        {**json.loads((core.PACKAGE / "configs" / "dffnet-ddff12.json").read_text()),
         "stack": [10, 64, 64]}))
    (root / "portbench" / "traffic" / "dummy-b2.json").write_text(json.dumps(
        {**json.loads((core.PACKAGE / "traffic" / "batch-b32.json").read_text()), "batch": 2,
         "driver": "dummy"}))
    (root / "portbench" / "drivers" / "dummy.py").write_text(
        "def run(r):\n    r.e2e['serve_stacks_per_s'] = 1.0\n")
    (root / "portbench" / "metrics" / "dummy_ms.serve.py").write_text(
        "def read(r):\n    return 1.5\n")
    (root / "portbench" / "limits" / "dummy.dummy-b2.json").write_text(
        json.dumps({"limits": {"pred3_max": 0.1}}))
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy.json", "reduced": [],
                             "why": "a dummy"})
    bench["workloads"].append({"name": "dummy.dummy-b2", "config": "dummy",
                               "traffic": "dummy-b2", "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy_ms.serve", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "models",
                               "moves": "serve_stacks_per_s", "workloads": ["dummy.dummy-b2"]})
    bench["end_to_end"][0]["workloads"].append("dummy.dummy-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import core\n"
            "c = core.load_cell('dummy.dummy-b2')\n"
            "assert c.config['stack'] == [10, 64, 64] and c.traffic['batch'] == 2\n"
            "assert [m['name'] for m in c.per_layer] == ['dummy_ms.serve']\n"
            "assert core.metric_reader('dummy_ms.serve')(None) == 1.5\n"
            "assert c.limits == {'pred3_max': 0.1}\n"
            "assert core.driver(c).__name__ == 'portbench.drivers.dummy'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    after = {p: p.read_bytes() for p in before}
    assert after == before


TOY_NETWORK = '''"""A toy depth-from-focus network: a 3-D conv, BatchNorm and ReLU, a
1x1x1 conv to one channel, and a softmax over the focus axis."""

import torch
from torch import nn

from portbench.inputs import focus_dists, uniform
from portbench.reference import toy

SERVED = ("depth",)
DEPTH = 0
WORK = {}
KERNELS = ()
specs = toy.specs
reference = toy.forward


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv3d(3, 4, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm3d(4)
        self.head = nn.Conv3d(4, 1, 1)

    def forward(self, fs, focus_dists):
        x = torch.relu(self.bn(self.conv(fs.permute(0, 4, 1, 2, 3))))
        p = torch.softmax(self.head(x)[:, 0], dim=1)
        return ((p * focus_dists[:, :, None, None]).sum(dim=1),)


def probe_inputs(stack, device):
    n, h, w = stack
    return [torch.zeros((1, n, h, w, 3), device=device), torch.ones((1, n), device=device)]


def program(config, params, device):
    net = Toy().to(device)
    net.load_state_dict(params)
    return net.eval()


def serving_inputs(config, b, dtype, dev, gen):
    n, h, w = config["stack"]
    return [uniform((b, n, h, w, 3), dtype, dev, gen), focus_dists(b, n, dev, *config["focus"])]


def launches(b, stack):
    return []
'''

TOY_REFERENCE = '''"""The toy network's plain reference."""

import torch
import torch.nn.functional as F


def specs():
    return {"bn.bias": ((4,), ("bn_bias",)), "bn.num_batches_tracked": ((), ("count",)),
            "bn.running_mean": ((4,), ("bn_mean",)), "bn.running_var": ((4,), ("bn_var",)),
            "bn.weight": ((4,), ("bn_weight",)), "conv.weight": ((4, 3, 3, 3, 3), ("default", 81)),
            "head.bias": ((1,), ("bias", 4)), "head.weight": ((1, 4, 1, 1, 1), ("default", 4))}


def forward(params, inputs, *, train=False):
    fs, fd = inputs
    p = params
    x = F.conv3d(fs.permute(0, 4, 1, 2, 3), p["conv.weight"], padding=1)
    x = torch.relu(F.batch_norm(x, p["bn.running_mean"], p["bn.running_var"], p["bn.weight"],
                                p["bn.bias"], training=train, eps=1e-5))
    prob = torch.softmax(F.conv3d(x, p["head.weight"], p["head.bias"])[:, 0], dim=1)
    return ((prob * fd[:, :, None, None]).sum(dim=1),)
'''


def test_a_network_is_added_by_new_files_alone(tmp_path):
    """A network of its own (a module under ``networks/``, its reference
    under ``reference/``) with a configuration, limits, a per-layer metric
    and a cell on the existing ``batch`` driver, added in a copy as new files
    and new entries of BENCHMARK.json: the copy's harness runs the cell on
    the CPU and reads it correct, a planted fault reads not correct, and no
    existing file changed."""
    root = tmp_path / "checkout"
    pkg = root / "portbench"
    shutil.copytree(core.PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    (pkg / "networks" / "toy.py").write_text(TOY_NETWORK)
    (pkg / "reference" / "toy.py").write_text(TOY_REFERENCE)
    (pkg / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "network": "toy", "stack": [4, 16, 16], "focus": [0.5, 2.0]}))
    (pkg / "traffic" / "batch-b2-fp32.json").write_text(json.dumps(
        {"driver": "batch", "batch": 2, "dtype": "float32", "pool": 2, "sample_calls": 2,
         "sample_rows": 2, "trace_calls": 2}))
    (pkg / "metrics" / "toy_forwards.serve.py").write_text(
        "def read(r):\n    return None if r.slice is None else float(r.slice.calls)\n")
    (pkg / "limits" / "toy.batch-b2-fp32.json").write_text(
        json.dumps({"limits": {"depth_rms": 1e-4}}))
    bench = json.loads(core.BENCHMARK.read_text())
    cell = "toy.batch-b2-fp32"
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "portbench/configs/toy.json", "reduced": [],
                             "why": "a toy"})
    bench["workloads"].append({"name": cell, "config": "toy", "traffic": "batch-b2-fp32",
                               "chips": 1, "why": "a toy"})
    bench["per_layer"].append({"name": "toy_forwards.serve", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "models",
                               "moves": "serve_stacks_per_s", "workloads": [cell]})
    next(m for m in bench["end_to_end"] if m["name"] == "serve_stacks_per_s")["workloads"].append(
        cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": str(core.ROOT), "OMP_NUM_THREADS": "1"}
    # the conv's and the head's FLOPs: 2 x pixels x (4 x 81 + 4)
    code = ("from portbench import networks, yardstick\n"
            "assert yardstick.forward_bound_s('toy', 2, (4, 16, 16), False) == 0\n"
            "assert yardstick.port_kernels('toy') == yardstick.PORT_KERNELS\n"
            "assert yardstick.conv_flops_per_stack('toy', (4, 16, 16)) == 2 * 1024 * 328\n"
            "try:\n    networks.load('nothing')\nexcept KeyError as e:\n    print(e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0 and "'toy'" in out.stdout, out.stderr[-3000:]
    for fault, trace in ((None, 1), ("answer", 0)):
        argv = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                str(2**31 + 7), "--seconds", "0.3", "--trace", str(trace), "--device", "cpu"]
        out = subprocess.run(argv + (["--fault", fault] if fault else []), cwd=root,
                             capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is (fault is None), (fault, line["checks"])
        assert set(line["checks"]) == {"depth_rms"}
        if trace:
            assert line["metrics"]["toy_forwards.serve"]["value"] == 2
    assert {p: p.read_bytes() for p in before} == before


def test_an_unknown_network_is_refused():
    with pytest.raises(KeyError, match="dffnet"):
        networks.load("no_such_net")
    with pytest.raises(KeyError):
        networks.load("../core")


def test_run_without_the_program_fails(tmp_path):
    """A checkout of only BENCHMARK.json and portbench/ exits non-zero."""
    shutil.copytree(core.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.BENCHMARK, tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--device", "cpu"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
