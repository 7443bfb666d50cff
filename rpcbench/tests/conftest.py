"""Tests of the benchmark harness.  Run from the root of the repository:

    python -m pytest rpcbench/tests -q

They run on the CPU (the harness's rehearsal path, the program's plain
versions, the native echo server on loopback).  Tests marked `card` need a
CUDA card and skip without one; on the card run `python -m pytest
rpcbench/tests -q -m card`.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def root():
    return ROOT
