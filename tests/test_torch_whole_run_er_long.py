"""Whole-run parity of the ER family's two longer runs: Finetuning, which
trains the whole tower, and rm with ``--memory_epoch 2 --rm_uncertainty``
(its memory epochs and Monte-Carlo views), each through the port's
``run()`` against the JAX package's over one two-task stream
(``tests/torch_whole_run.py``), with ``scripts/er.sh``'s memory and temp
batch in ratio (``torch_whole_run.ER_FLAGS``). The other ER-family names
are in ``tests/test_torch_whole_run_er.py``.

rm runs the port's ``"fused"`` road under its frozen tower (5e-2 moves the
head's accuracy between eval points). Finetuning trains the tower, at
1e-3, through the ``"unfused"`` road: on the ``"fused"`` road its tower
trains through the kernels' bf16 roundings, and its head's logits (within
0.04 of each other at this lr) then flip a near tie that costs an eval
point 1/64 of accuracy against JAX's fp32 road.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_whole_run as wr

one_thread = pytest.fixture(autouse=True, scope="module")(wr.one_thread)

ER = wr.ER_FLAGS
CASES = [
    wr.Case("Finetuning", ER + (("lr", 1e-3),), impl="unfused"),
    wr.Case("rm", ER + (("memory_epoch", 2), ("rm_uncertainty", True))),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_whole_run_matches_jax(case, tmp_path):
    j, t = wr.whole_run(case, tmp_path)
    print(wr.report_line(wr.check(case, j, t)))
