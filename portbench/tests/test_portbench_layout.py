"""The benchmark's files: every configuration, traffic mix, driver, limit and
per-layer metric of ``BENCHMARK.json`` is found by name and parses, every
metric's ``moves`` is reported by each of its cells, the file keeps the
contract's shapes, and a new cell can be added as new files and entries
alone."""

from __future__ import annotations

import importlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import core

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
    assert c.config["network"] in ("dffnet", "e2e")
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


def test_run_without_the_program_fails(tmp_path):
    """A checkout of only BENCHMARK.json and portbench/ exits non-zero."""
    shutil.copytree(core.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.BENCHMARK, tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--device", "cpu"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
