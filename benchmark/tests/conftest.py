"""The benchmark's own tests: the harness on the CPU at tiny sizes (the
port's entry points run their plain versions on CPU tensors), and, marked
``cuda``, on the card. Run from the repository root:

    python -m pytest benchmark/tests -q
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
