"""Whole-run parity of the prompt-pool trainers l2p and mvp
(``scripts/mvp.sh``'s mask, contrastive, AFS and GSF on), each through the
port's ``run()`` against the JAX package's over one two-task stream
(``tests/torch_whole_run.py``). The pools' selection counters, the masks
and the per-step key pulls run as ``run()`` drives them. dualprompt is in
``tests/test_torch_whole_run_dualprompt.py``.

Adam with ``online_iter 3`` as the scripts' cifar100 row. The port runs
its ``"unfused"`` road: the ``"fused"`` road's CPU path (the kernels'
plain versions) rounds h, qkv, p and ctx to bf16 as the kernels do, and
the prompted passes put trained prompts through those roundings. Against
JAX's fp32 road l2p's losses then drift to 3.4e-3 and flip near ties,
dualprompt flips a near tie that costs an eval point 1/64 of accuracy, and
mvp's losses drift to 0.16 over the run (its mask and GSF decisions
amplify them); on ``"unfused"`` all three stay within 2.6e-5.
``tests/test_torch_vit_prompt.py`` holds the fused road against JAX's
Pallas road. lr 5e-2 moves the
accuracy between eval points (mvp 5e-3; mvp's accuracy bound is 0.02, as
``tests/test_whole_run_parity.py:1133``).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_whole_run as wr

one_thread = pytest.fixture(autouse=True, scope="module")(wr.one_thread)

POOL = wr.POOL_FLAGS
MVP_ATTRS = (("use_mask", True), ("use_contrastiv", True), ("use_afs", True),
             ("use_gsf", True))
CASES = [
    wr.Case("l2p", POOL, impl="unfused"),
    wr.Case("mvp", POOL + (("lr", 5e-3),), attrs=MVP_ATTRS, acc_tol=0.02,
            impl="unfused"),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_whole_run_matches_jax(case, tmp_path):
    j, t = wr.whole_run(case, tmp_path)
    print(wr.report_line(wr.check(case, j, t)))
