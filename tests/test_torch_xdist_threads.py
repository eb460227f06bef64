"""Torch's CPU threads under pytest-xdist. Each worker would start one
intra-op thread per core, so n workers run n times as many threads as there
are cores and spend their time contending (the port's parity tests ran 3-7x
slower under 6 workers than alone). Every worker collects every test module,
so importing this one gives each worker its share of the cores,
ceil(cores / workers), before any test runs. Outside pytest-xdist nothing
changes. JAX's own thread pools are untouched."""

import os

import pytest
import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
CORES = len(os.sched_getaffinity(0))


def worker_threads(workers: int, cores: int) -> int:
    return max(1, -(-cores // workers))


if WORKERS > 1:
    torch.set_num_threads(worker_threads(WORKERS, CORES))


@pytest.mark.parametrize("workers,cores,threads", [(6, 8, 2), (4, 8, 2), (8, 8, 1), (3, 8, 3),
                                                   (16, 8, 1), (2, 1, 1)])
def test_worker_share_of_the_cores(workers, cores, threads):
    assert worker_threads(workers, cores) == threads


def test_each_worker_runs_its_share():
    if WORKERS > 1:
        assert torch.get_num_threads() == worker_threads(WORKERS, CORES)
    else:
        assert torch.get_num_threads() >= 1
