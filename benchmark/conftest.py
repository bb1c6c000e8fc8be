"""Pytest settings of the benchmark's own tests (``benchmark/tests``).

Run them with ``python -m pytest benchmark/tests -q`` from the repository's
root.  Tests marked ``card`` need a CUDA device: they skip without one, and
run on the card by the same command.  Whether a card is present is decided
inside the ``card`` fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run only on the card")
    return torch.cuda.get_device_name(0)
