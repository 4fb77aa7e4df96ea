"""Test settings of the benchmark's own tests (``python -m pytest wdnbench``).

Tests that need a CUDA card carry the ``cuda`` marker and take the ``card``
fixture, which decides inside the test whether there is one and skips
without it."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control computes in TF32, which only the card has")
    return torch.device("cuda")
