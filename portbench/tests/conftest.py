"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository.  Tests marked ``cuda`` need a card and skip
without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped when none is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    return "cuda"
