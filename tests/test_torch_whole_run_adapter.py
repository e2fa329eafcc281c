"""Whole-run parity of adapter-clip and moe-clip, whose PEFT trees live in
the model, each through the port's ``run()`` against the JAX package's
over one two-task stream (``tests/torch_whole_run.py``: the same tower,
data and starting trees, augmentation off on both sides, JAX on its
``"xla"`` road). The optimizer resets at each task boundary and the text
caches run as ``run()`` drives them; moe-clip's steps take JAX's gate noise
(``torch_whole_run.jax_gate_noise``: the packages cannot share the draw).
lora-clip is in ``tests/test_torch_whole_run_lora.py``, MaPLe and mvp-clip
in ``tests/test_torch_whole_run_maple_mvp.py``.

The port runs its ``"unfused"`` road: the ``"fused"`` road's CPU path
rounds h, qkv, p, ctx and the LoRA ``z`` to bf16 as the kernels do, which
cannot meet the step-0 loss bound against JAX's fp32 road once a trained
tree sits inside the tower (lora-clip both 8.0e-4, MaPLe 2.4e-3 against
rtol 1e-4). ``tests/test_torch_clip.py`` and the step tests hold that
road against JAX's Pallas road, which rounds the same way. lr 1e-2 moves
the accuracy between eval points.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_whole_run as wr

one_thread = pytest.fixture(autouse=True, scope="module")(wr.one_thread)

CASES = [
    wr.Case("adapter-clip", (("lr", 1e-2),), impl="unfused"),
    wr.Case("moe-clip", (("lr", 1e-2),), impl="unfused"),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_whole_run_matches_jax(case, tmp_path):
    j, t = wr.whole_run(case, tmp_path)
    print(wr.report_line(wr.check(case, j, t)))
