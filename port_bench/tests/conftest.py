"""The benchmark's CPU tests: one or two CPU threads a test process, so
several workers (``-p xdist -n 6``) do not oversubscribe the cores."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _threads():
    torch.set_num_threads(min(2, os.cpu_count() or 1))
    yield
