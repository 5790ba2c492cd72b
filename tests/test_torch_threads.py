"""The root conftest.py's thread budget: under pytest-xdist each worker's
torch runs ``cpu_count // workers`` threads, and the processes its tests
spawn inherit the budget through the environment."""
import os

import pytest
import torch


def test_worker_thread_budget():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        pytest.skip("not an xdist worker: a single pytest process keeps "
                    "every core")
    budget = max(1, (os.cpu_count() or 1) // int(workers))
    assert torch.get_num_threads() <= budget
    assert "OMP_NUM_THREADS" in os.environ
