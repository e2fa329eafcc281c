"""The port's model axis on the CPU (``parallel/mesh.py``: tensor
parallelism of the frozen towers, expert parallelism of the MoE adapters):
``gloo`` ranks of one pool for the file (``tests/torch_mesh_ranks.py``)
against the replicated 1-process step on the ``"unfused"`` road.

Tolerances (fp32): losses at rtol 1e-5, updated trainable leaves at rtol
1e-5 / atol 1e-6, grads at rtol 1e-4 / atol 1e-6 (a head's partial sums
reduce over the model group in another order), eval counts exactly. In
bf16 the model axis's loss and grads within twice the bf16 1-process
step's distance from the fp32 step.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks as R  # noqa: E402

from jax.sharding import PartitionSpec as P  # noqa: E402
from lifelong_clip_tpu.parallel import mesh as jmesh  # noqa: E402
from lifelong_clip_tpu_torch.parallel import mesh as tmesh  # noqa: E402


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = R.RankPool(4, str(tmp_path_factory.mktemp("pg")))
    yield p
    p.close()


CASES = [("lora-clip", (1, 2)), ("adapter-clip", (1, 2)),
         ("moe-clip", (1, 2)), ("continual-clip", (1, 2)),
         ("lora-clip", (2, 2))]


@pytest.mark.parametrize("method,mesh", CASES)
def test_model_axis_step_matches_replicated(pool, method, mesh):
    """(d) lora-clip (LoRA on both towers) and adapter-clip with the towers
    split by heads and hidden units, moe-clip with its experts split too,
    continual-clip's eval: every trainable leaf and its grad equals the
    replicated step's on every rank; the 2x2 mesh runs the data and the
    model groups at once."""
    want = R.trainer_steps(0, 1, method, (1, 1), grads=True)
    got = pool.run(R.trainer_steps, mesh[0] * mesh[1], method, mesh, 2, True)
    for g in got:
        # each rank holds its half of the heads' columns of w_qkv
        key = ("vision", "blocks", "attn", "w_qkv")
        assert g["frozen_shapes"][key][-1] * mesh[1] == \
            want["frozen_shapes"][key][-1]
        np.testing.assert_allclose(np.array(g["losses"]),
                                   np.array(want["losses"]), rtol=1e-5)
        for k, v in (want.get("trainable") or {}).items():
            np.testing.assert_allclose(g["trainable"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=str(k))
            np.testing.assert_allclose(g["grads"][k], want["grads"][k],
                                       rtol=1e-4, atol=1e-6, err_msg=str(k))
        for a, b in zip(g["eval"], want["eval"]):
            np.testing.assert_array_equal(a, b)


def _grad_rel(got, ref):
    """{leaf: its worst grad difference over the grad's largest entry}."""
    return {k: float(np.abs(got[k] - v).max() / np.abs(v).max())
            for k, v in ref.items() if np.abs(v).max() > 0}


@pytest.mark.parametrize("method", ["lora-clip", "moe-clip"])
def test_bf16_model_axis_as_far_as_one_process(pool, method):
    """The model axis in bf16, as users run it, against the fp32 1-process
    step: its loss and each leaf's grad within twice the distance of the
    bf16 1-process step's from it (the split reorders the partial sums and
    rounds them to bf16 apart: 0.85-1.14 times as far on this tree; a lost
    or doubled partial sum is O(1) off)."""
    bf16 = {"use_bf16": True}
    ref = R.trainer_steps(0, 1, method, (1, 1), 1, True)
    wit = R.trainer_steps(0, 1, method, (1, 1), 1, True, None, bf16)
    loss = ref["losses"][0][0]
    w_loss = abs(wit["losses"][0][0] - loss)
    w_grad = _grad_rel(wit["grads"], ref["grads"])
    assert min(w_grad.values()) > 0
    for g in pool.run(R.trainer_steps, 2, method, (1, 2), 1, True, None,
                      bf16):
        assert abs(g["losses"][0][0] - loss) <= 2 * w_loss + 1e-5 * loss
        got = _grad_rel(g["grads"], ref["grads"])
        for k, w in w_grad.items():
            assert got[k] <= 2 * w, (k, got[k], w)


def test_unrouted_model_axis_mesh_rejected(pool):
    """(e) Every name but the adapter family and continual-clip refuses a
    model axis, naming data-parallel meshes (mvp-clip among them, as JAX's
    test_unrouted_model_axis_mesh_rejected)."""
    names = [m for m in R.ALL_METHODS if m not in R.MODEL_AXIS_METHODS]
    assert "mvp-clip" in names and len(names) == 13
    for got in pool.run(R.model_axis_rejected, 2, names):
        for m in names:
            assert got[m] is not None and \
                "data-parallel meshes only" in got[m], (m, got[m])


def test_shard_params_follows_jax_partition_rules():
    """Which dim of each block leaf splits over the model axis, by JAX's
    ``param_partition_spec``; [q | k | v] splits by heads of each."""
    leaves = {"w_qkv": torch.zeros(2, 8, 24), "b_qkv": torch.zeros(2, 24),
              "w_out": torch.zeros(2, 8, 8), "b_out": torch.zeros(2, 8),
              "w_fc": torch.zeros(2, 8, 32), "b_fc": torch.zeros(2, 32),
              "w_proj": torch.zeros(2, 32, 8), "b_proj": torch.zeros(2, 8),
              "scale": torch.zeros(2, 8)}
    for name, leaf in leaves.items():
        spec = jmesh.param_partition_spec(("blocks", name), leaf)
        dim = tmesh.param_split(name, leaf)
        want = None if spec == P() else list(spec).index(jmesh.MODEL_AXIS)
        assert dim == want, name

    class Half:   # rank 1 of a 2-way model axis
        model, model_rank = 2, 1
    cols = tmesh.qkv_columns(8, Half).tolist()
    assert cols == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]
    w = torch.arange(24.).reshape(1, 1, 24).expand(2, 8, 24)
    cut = tmesh.shard_params({"blocks": {"attn": {"w_qkv": w}}}, Half)
    assert cut["blocks"]["attn"]["w_qkv"][0, 0].tolist() == cols
