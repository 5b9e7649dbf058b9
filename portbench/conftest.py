"""pytest settings of the benchmark's own tests (`portbench/tests`).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where there is none; the decision is made in
the fixture, when the test runs, never while a module is imported. On a
machine with a card: `python3 -m pytest portbench/tests -m card`.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
