"""The benchmark's CPU tests (``python -m pytest portbench/tests``); the
driver's test tier collects only ``tests/``.  Tests marked ``cuda`` need a
card and skip without one, decided inside a fixture."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
