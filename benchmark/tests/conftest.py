"""The benchmark's own tests, on the CPU unless marked ``card``:

    python -m pytest benchmark/tests -q -p no:cacheprovider

A ``card`` test needs a CUDA device; whether one is present is decided
inside the ``card`` fixture, never while a module is imported."""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
