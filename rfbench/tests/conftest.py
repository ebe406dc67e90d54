"""The benchmark's own tests (``python -m pytest rfbench/tests -q``). The
repo's ``tests/`` does not collect them; ``-m card`` selects the ones that
need a CUDA card, which skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip when this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda"
