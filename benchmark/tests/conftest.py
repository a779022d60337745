"""Tests of the benchmark harness (run them with
``python -m pytest benchmark/tests``; the repository's ``tests/`` does
not collect them).  Tests that need a CUDA card carry the ``gpu`` marker
and decide inside a fixture whether there is one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
