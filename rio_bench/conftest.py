"""Pytest settings of the benchmark's own tests (``python -m pytest rio_bench/tests``).

Tests marked ``card`` need a CUDA device; the ``card`` fixture decides at
run time whether there is one and skips on a machine without.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
