"""Shared pieces of the benchmark's tests: the ``chip`` marker, and the
cells at a size the CPU runs in seconds (the same files, widths, depth and
traffic cut down, nothing else changed)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

CELL = harness.cell  # the files as they are, whatever a test patches

TINY_MODEL = {"dim": 16, "dim_mults": [1, 2], "img_size": 16}
TINY_MIX = {"train_step": {"batch": 4, "pool": 12},
            "serve_request": {"pool": 6, "sample": 4, "warmup": 2}}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one (decided in a fixture)")


def tiny_cell(name: str):
    cell = CELL(name)
    cell["model"].update(TINY_MODEL)
    cell["mix"].update(TINY_MIX[cell["mix"]["driver"]])
    return cell


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
