"""Whole-run parity of the ER family's trainers over a frozen tower: er,
lwf, ewc++ and clib, each through the port's ``run()`` against the JAX
package's over one two-task stream (``tests/torch_whole_run.py``: the same
tower, data and starting head, augmentation off on both sides, JAX on its
``"xla"`` road). Each keeps ``scripts/er.sh``'s memory and temp batch in
ratio (``torch_whole_run.ER_FLAGS``); clib keeps ``scripts/clib.sh
synthetic``'s flags at a quarter of its memory. Finetuning and rm are in
``tests/test_torch_whole_run_er_long.py``.

The head's lr (5e-2; ewc++ 1e-2, whose head collapses onto one class at
5e-2) moves the accuracy between eval points. The port runs its
``"fused"`` road (the kernels' plain versions on the CPU, which round h,
qkv, p and ctx to bf16 as the kernels do) under the frozen tower, where the
features' roundings keep every bound.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_whole_run as wr
from lifelong_clip_tpu_torch.utils.memory import ReplayMemory

one_thread = pytest.fixture(autouse=True, scope="module")(wr.one_thread)

ER = wr.ER_FLAGS
CASES = [
    wr.Case("er", ER),
    wr.Case("lwf", ER),
    wr.Case("ewc++", ER + (("lr", 1e-2),)),
    wr.Case("clib", (("memory_size", 16), ("opt_name", "adam"),
                     ("lr_step", 0.95), ("lr_length", 10),
                     ("lr_period", 10), ("imp_update_period", 1))),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_whole_run_matches_jax(case, tmp_path):
    j, t = wr.whole_run(case, tmp_path)
    print(wr.report_line(wr.check(case, j, t)))


def test_whole_run_harness_sees_a_planted_fault(tmp_path):
    """The bounds can fail: the port's er run with its memory's reservoir
    draw off by one fails the memory check, and with its head's lr halved
    fails the loss bound."""
    case = CASES[0]
    real = ReplayMemory.reservoir_update

    def off_by_one(self, sample_idx, label):
        self.seen += 1
        if len(self.indices) < self.memory_size:
            self._append(sample_idx, label)
            return len(self.indices) - 1
        slot = int(self.rng.integers(0, self.seen)) + 1
        if slot < self.memory_size:
            self._replace(slot, sample_idx, label)
            return slot
        return -1

    def draw_off_by_one(mp, ttr):
        mp.setattr(ReplayMemory, "reservoir_update", off_by_one)

    j, t = wr.whole_run(case, tmp_path / "draw", patch=draw_off_by_one)
    assert ReplayMemory.reservoir_update is real
    with pytest.raises(AssertionError, match="memory after task"):
        wr.check(case, j, t)

    def half_lr(mp, ttr):
        for group in ttr.state.opt.param_groups:
            group["lr"] /= 2
        ttr.state.sched.base_lrs = [lr / 2 for lr in
                                    ttr.state.sched.base_lrs]

    j, t = wr.whole_run(case, tmp_path / "lr", patch=half_lr)
    with pytest.raises(AssertionError,
                       match="step-0 loss|first 10 losses|mean loss"):
        wr.check(case, j, t)
