"""CPU tests of the benchmark: run with ``python -m pytest portbench/tests``
from the repository's root.  Tests marked ``gpu`` need a CUDA device and
skip themselves without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (run on the card)")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    torch.set_num_threads(1)
