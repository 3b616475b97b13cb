"""The benchmark's own tests (``python -m pytest perfbench/tests``): the
harness, the reference and the frozen counts on the CPU at tiny sizes.
Tests marked ``card`` need a CUDA device and skip without one; whether
there is one is decided inside the ``card`` fixture."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "perfbench" / "tests", ROOT / "perfbench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
