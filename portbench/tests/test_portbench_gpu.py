"""The control on the card, at each cell's own size: a run with a short
window whose program reads correct, and whose control (the reference one
precision below the cell's: fp8 for bf16, TF32 for fp32) fails at least one
compared number.  Marked ``gpu``: it skips without enough cards.

    python -m pytest portbench/tests/test_portbench_gpu.py -m gpu -q
"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import core, run

CELLS = [w["name"] for w in json.loads(core.BENCHMARK.read_text())["workloads"]]


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.cuda.device_count()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cards, cell):
    c = core.load_cell(cell)
    if cards < c.chips:
        pytest.skip(f"{cell} needs {c.chips} cards")
    r = run.execute(cell, 2**31 + 41, 2.0, False, control=True)
    assert run.result(r)["correct"] is True, r.checks
    assert any(r.control_checks[k] > limit for k, limit in c.limits.items()), r.control_checks
