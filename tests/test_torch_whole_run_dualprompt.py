"""Whole-run parity of dualprompt through the port's ``run()`` against the
JAX package's over one two-task stream (``tests/torch_whole_run.py``),
with Adam and ``online_iter 3`` as the scripts' cifar100 row
(``torch_whole_run.POOL_FLAGS``). The pool's selection counters and the
per-step key pulls run as ``run()`` drives them.

The port runs its ``"unfused"`` road, as
``tests/test_torch_whole_run_prompt.py`` says why: on the ``"fused"``
road's bf16 roundings dualprompt flips a near tie that costs an eval point
1/64 of accuracy against JAX's fp32 road. lr 5e-2 moves the accuracy
between eval points.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_whole_run as wr

one_thread = pytest.fixture(autouse=True, scope="module")(wr.one_thread)

CASES = [wr.Case("dualprompt", wr.POOL_FLAGS, impl="unfused")]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_whole_run_matches_jax(case, tmp_path):
    j, t = wr.whole_run(case, tmp_path)
    print(wr.report_line(wr.check(case, j, t)))
