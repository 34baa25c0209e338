"""Fixtures of the benchmark's own tests: the harness on the import path,
and the card-only marker's skip, decided when a test runs (never while a
module is imported)."""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The card, for the tests marked cuda; a skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with -m cuda")
    return torch.device("cuda", 0)
