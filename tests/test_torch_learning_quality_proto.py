"""The port's ProtoCLIP trainer (``adapter-clip-proto_prompt``) must learn:
``run()`` over the fittable synthetic stream, its stage 2 included, lands
above the floors of ``tests/test_learning_quality.py``
(``tests/torch_learning_gates.py``: the JAX test's stream, tower, config,
tiny knobs and starting trees). ``-s`` prints the accuracies beside
JAX's."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_learning_gates as lg

one_thread = pytest.fixture(autouse=True, scope="module")(lg.one_thread)


def test_learns_above_the_floors(tmp_path):
    gate = lg.GATES["adapter-clip-proto_prompt"]
    lg.check(gate, lg.gate_run(gate, str(tmp_path)))
