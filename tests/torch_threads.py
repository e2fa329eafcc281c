"""This test process's share of the host's cores for torch's CPU threads.

Not collected (no ``test_`` prefix): every ``tests/test_torch_*.py``
imports it (``tests/test_torch_threads.py`` checks that they do). Each
pytest-xdist worker is a process of its own, and torch sizes its intra-op
pool to every core of the host; six workers on eight cores then run 48
threads on 8 cores, and the port's tests ran over 15 times slower than
alone. At import this sets the pool to the cores divided by the workers
(``PYTEST_XDIST_WORKER_COUNT``, 1 outside xdist), at least one. The tests
that drop to one thread for bitwise checks do so on top of this.
"""

import os

import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
SHARE = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(SHARE)
