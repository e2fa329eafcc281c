"""Whole-run parity of lora-clip, ``--peft_encoder image`` with a replay
memory and ``both`` with every class visible, each through the port's
``run()`` against the JAX package's over one two-task stream
(``tests/torch_whole_run.py``: the same tower, data and starting LoRA
trees, augmentation off on both sides, JAX on its ``"xla"`` road). The
optimizer resets at each task boundary, the replay memory and the text
caches run as ``run()`` drives them.

The port runs its ``"unfused"`` road, as
``tests/test_torch_whole_run_adapter.py`` says why: on the ``"fused"``
road's bf16 roundings the trained LoRA tree in the text tower misses the
step-0 bound (both: 8.0e-4 against rtol 1e-4). lr 1e-2 moves the accuracy
between eval points.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_whole_run as wr

one_thread = pytest.fixture(autouse=True, scope="module")(wr.one_thread)

CASES = [
    wr.Case("lora-clip", (("lr", 1e-2), ("memory_size", 16),
                          ("temp_batchsize", 2)),
            peft=(("encoder", "image"),), impl="unfused"),
    wr.Case("lora-clip", (("lr", 1e-2), ("visible_classes", "all")),
            peft=(("encoder", "both"),), impl="unfused"),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_whole_run_matches_jax(case, tmp_path):
    j, t = wr.whole_run(case, tmp_path)
    print(wr.report_line(wr.check(case, j, t)))
