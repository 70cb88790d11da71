"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests that need the card carry the ``card`` marker and skip from inside
the ``card`` fixture where no CUDA device is present; on the chip
machine run them with ``python -m pytest portbench/tests -q -m card``."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent.parent), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


# The packing limit of whole runs on the CPU at a test's size (40 to 300
# nodes, 2 to 16 clients).  The cells' limit is set at their size from
# the card's readings (PERF.md section 2); at these sizes the fleet is
# nearly empty, ScoreFit scores its nodes alike and the job anti-affinity
# penalty spreads each job's placements, so sound runs read high:
# 3.0 in fleet1k.batch-10x4 at 60 nodes and 4 clients of 5 groups,
# -0.05 to 0.43 in fleet10k.mock-job at 300 nodes and 8 clients; the
# spread control 9.8-10.6 and 3.76-4.9 there.
SMALL_PACKING_LIMIT = {"fleet1k.batch-10x4": 6.0, "fleet10k.mock-job": 2.0}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips on the CPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.cuda.get_device_name(0)
