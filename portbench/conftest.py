"""pytest settings of the benchmark's own tests (python -m pytest
portbench/tests): the `card` marker, for tests that need a CUDA card and
skip without one (decided in the `card` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run on the "
        "card with: python3 -m pytest portbench/tests -m card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
