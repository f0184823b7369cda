"""The harness's tests: CPU only, except those marked ``cuda`` (run on
the card with ``python -m pytest portbench/tests -m cuda``), which skip
without one. Whether a card is there is decided in the ``card`` fixture,
never at import."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.fixture
def checkout() -> Path:
    return CHECKOUT


@pytest.fixture
def quick_warmup(monkeypatch):
    """The fixture cells' short warm-up in place of the card's."""
    from portbench import harness
    from portbench.tests import fixtures

    monkeypatch.setattr(harness, "WARMUP", fixtures.WARMUP)
