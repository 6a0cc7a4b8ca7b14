"""The benchmark's own tests (CPU; those marked ``gpu`` need the card and
skip here). Run from the root of the checkout:

    python -m pytest -q -p no:cacheprovider h100_bench/tests
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
