"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the root of a checkout.

Tests that need an NVIDIA card carry the ``card`` marker and take the
``card`` fixture, which skips them with a reason where there is none; run
them on the card with ``python -m pytest portbench/tests -q -m card``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips with a reason where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); this machine has none")
    return "cuda"
