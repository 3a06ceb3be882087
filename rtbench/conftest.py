"""pytest settings of the benchmark's own tests: the import path, and the
``card`` marker of tests that need a CUDA card (they skip without one,
decided inside the ``card`` fixture)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark's runs need one")
    return torch.device("cuda", 0)
