"""Tests of the benchmark harness. Those that need an NVIDIA card carry the
`card` marker and skip without one; run them on the card with

    python -m pytest slam_bench/tests -q -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
