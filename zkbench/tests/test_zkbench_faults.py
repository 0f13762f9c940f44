"""Every cell at a small size on the CPU, driven as a run is (set-up,
window, drain, comparison; only the look for a card skipped): sound, it
comes out correct with every number compared at 0; with the control
(outputs left in the lazy range [p, 2p)) or a fault planted under the
timed path (a step returning its state unchanged, half of the batch left
out, one answer altered where it is produced), it comes out not
correct."""
import json
import time
from pathlib import Path

import pytest

from zkbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CASES = [(c, f) for c in CELLS for f in ("sound", "control", "unchanged", "half", "altered")]


@pytest.mark.parametrize("cell_name, plant", CASES)
def test_the_comparison_catches_the_control_and_every_fault(small_cell, cell_name, plant):
    cell = small_cell(cell_name)
    fault = {"sound": None, "control": cell.loop.control}.get(plant, cell.loop.FAULTS.get(plant))
    res, lines = harness.run(cell, 2_200_000_000 + len(plant), 0.01, False, "cpu",
                             time.perf_counter(), fault=fault)
    values = [c["value"] for c in res["checks"].values()]
    assert res["attempted"] >= 2
    if plant == "sound":
        assert res["correct"] and res["failed"] == 0 and values == [0] * len(values)
    else:
        assert not res["correct"] and res["failed"] >= 1 and max(values) > 0, lines
