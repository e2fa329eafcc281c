"""The port's mvp-clip and MaPLe trainers must learn: ``run()`` over the
fittable synthetic stream lands above the floors of
``tests/test_learning_quality.py`` (``tests/torch_learning_gates.py``: the
JAX test's stream, tower, config and starting trees). A regression that
kills learning in the prompt paths (mvp's mask, AFS or GSF; MaPLe's
compound prompts) lands at the 1/8 chance. ``-s`` prints each case's
accuracies beside JAX's."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_learning_gates as lg

one_thread = pytest.fixture(autouse=True, scope="module")(lg.one_thread)


@pytest.mark.parametrize("method", ["mvp-clip", "maple"])
def test_learns_above_the_floors(method, tmp_path):
    gate = lg.GATES[method]
    lg.check(gate, lg.gate_run(gate, str(tmp_path)))
