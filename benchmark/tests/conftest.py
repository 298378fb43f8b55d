"""The benchmark's own tests, run from the checkout's root on the CPU:

    python -m pytest benchmark/tests -q

They import the port (the system under test) and, in test_harness_reference,
its host runtime as a second witness; nothing here imports JAX."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    torch.set_num_threads(1)
    yield
