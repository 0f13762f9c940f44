import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes at which the plain versions on the CPU run a cell in seconds.
SMALL = {"msm_log_points": 8, "msm_unique_points": 16, "ntt_log_size": 8, "tree_height": 3}


@pytest.fixture
def small_cell():
    """resolve(name) with the configuration cut to SMALL."""
    from zkbench import harness

    def make(name, base=ROOT):
        cell = harness.resolve(name, base)
        cell.config.update({k: v for k, v in SMALL.items() if k in cell.config})
        return cell

    return make


@pytest.fixture
def card():
    """Skips a test without a CUDA device (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def pytest_configure(config):
    """Several test workers share the CPU: keep each to a few threads."""
    import os

    import torch

    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // 3)))
