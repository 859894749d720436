"""Root test configuration: one share of the cores for each xdist worker.

torch on the CPU starts as many intra-op threads as the machine has cores,
in every process. Under pytest-xdist each worker would do so, and ``n``
workers on ``c`` cores would run ``n * c`` threads that mostly wait for one
another. Inside a worker this gives torch ``cores // workers`` threads (at
least one); outside xdist it changes nothing.
"""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if os.environ.get("PYTEST_XDIST_WORKER") is None or not workers:
        return
    import torch

    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(max(1, cores // int(workers)))
