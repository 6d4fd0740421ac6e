"""Fixtures of the benchmark's own tests (run them from the repository's
root: ``python -m pytest portbench/tests``; the card's tests with
``-m cuda`` on a machine with a GPU)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def root():
    return ROOT
