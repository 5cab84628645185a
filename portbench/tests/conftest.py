"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository (CPU); the tests marked ``gpu`` run on a CUDA
card and skip without one."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """Skips the test without a CUDA card; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
