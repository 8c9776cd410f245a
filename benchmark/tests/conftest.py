"""The benchmark's CPU tests (`python -m pytest benchmark/tests -q`).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them here; the choice is made inside the fixture,
never while a module is imported."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")
    import torch

    torch.set_num_threads(2)        # several workers share the machine's cores


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """The tiny cells' spec and data folder: configs/tiny.json, a copy of
    pggan256 at widths [16, 16, 8, 8], scale 3, batch 8."""
    return {"spec_path": os.path.join(DATA, "BENCHMARK.json"), "data_dir": DATA}
