"""The port's ER and L2P trainers must learn: ``run()`` over the fittable
synthetic stream lands above the floors of ``tests/test_learning_quality.py``
(``tests/torch_learning_gates.py``: the JAX test's stream, tower, config and
starting trees). ER also from the port's own draws, so a fault in its
seeded init shows too. A run that stopped learning (zeroed grads, an
optimizer on the wrong tree, a broken label remap, a dead replay memory or
prompt pool) lands at the 1/8 chance and fails both floors. ``-s`` prints
each case's accuracies beside JAX's."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import pytest

import torch_learning_gates as lg

one_thread = pytest.fixture(autouse=True, scope="module")(lg.one_thread)


@pytest.mark.parametrize("method", ["er", "l2p"])
def test_learns_above_the_floors(method, tmp_path):
    gate = lg.GATES[method]
    lg.check(gate, lg.gate_run(gate, str(tmp_path)))


def test_er_learns_from_the_ports_own_draws(tmp_path):
    gate = lg.GATES["er"]
    lg.check(gate, lg.own_init_run(gate, str(tmp_path)),
             start="the port's seed-1 draws")
