"""The benchmark's own tests (run them with `python -m pytest benchmark/tests`).
Tests that need the card carry the `card` marker and skip, inside the
`card` fixture, where no CUDA device is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (runs the cell at its own size)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
