"""The benchmark's own tests (`python -m pytest perfbench/tests`). They run
on the CPU at small sizes; those marked `cuda` need the card and skip
without it."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs on the card at the cell's own size")
    return torch.device("cuda:0")
