"""The benchmark's own tests: run with ``python -m pytest benchmark/tests``
from the repository root (CPU). Tests marked ``cuda`` need the card and
skip without it."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the program's kernels); "
        "skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")
