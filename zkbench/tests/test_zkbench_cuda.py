"""On the card (marked `cuda`, skipped without one): a small cell of each
job loop through the program's kernels comes out correct, and with the
control comes out not correct.

    python -m pytest -o addopts="" -m cuda zkbench/tests/test_zkbench_cuda.py
"""
import json
import time
from pathlib import Path

import pytest

from zkbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("control", [False, True])
def test_small_cells_on_the_card(card, small_cell, name, control):
    cell = small_cell(name)
    plant = cell.loop.control if control else None
    res, _ = harness.run(cell, 2_500_000_001, 0.2, False, card, time.perf_counter(),
                         fault=plant)
    assert res["correct"] is not control
    assert res["device"]["platform"] == "gpu"
