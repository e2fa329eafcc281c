"""The port's data-parallel mesh (``parallel/mesh.py``, the trainers' DP
road) on the CPU: ranks are ``gloo`` processes of one pool per file
(``tests/torch_mesh_ranks.py``); ``tests/test_torch_mesh_jax.py`` holds
the same road against JAX's.

Tolerances: a step under ``--mesh 2x1`` holds its loss at rtol 1e-5 and its
updated trainable leaves at rtol 1e-5 / atol 1e-6 against the 1-process
step (fp32, SGD at lr 0.1: the ranks' grads average in one all-reduce, so
only the summation order differs); counters and eval counts exactly.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import os
import socket
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks as R  # noqa: E402

from lifelong_clip_tpu_torch import main as cli  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = R.RankPool(2, str(tmp_path_factory.mktemp("pg")))
    yield p
    p.close()


def _same_step(got, want):
    np.testing.assert_allclose(np.array(got["losses"]),
                               np.array(want["losses"]), rtol=RTOL)
    assert want.get("trainable") is None or \
        got["trainable"].keys() == want["trainable"].keys()
    for k, v in (want.get("trainable") or {}).items():
        np.testing.assert_allclose(got["trainable"][k], v, rtol=RTOL,
                                   atol=ATOL, err_msg=str(k))
    assert got["counters"].keys() == want["counters"].keys()
    for k, v in want["counters"].items():
        np.testing.assert_array_equal(got["counters"][k], v)
    for a, b in zip(got["eval"], want["eval"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", R.ALL_METHODS)
def test_dp_step_matches_one_process(pool, method):
    """(b) Two steps of every registered name (eval for continual-clip)
    under --mesh 2x1, each rank on its 2 of 4 rows, against the 1-process
    steps on the same batches; both ranks end the same."""
    want = R.trainer_steps(0, 1, method, (1, 1))
    got = pool.run(R.trainer_steps, 2, method, (2, 1))
    for g in got:
        assert g["eval_dp"]
        assert g["dp"] or method == "continual-clip"
        _same_step(g, want)


# -- whole runs, the valve, the draws, checkpoints, torchrun ------------------

RUN_METHODS = ["lora-clip", "er", "l2p", "mvp-clip", "maple",
               "adapter-clip-proto_prompt", "continual-clip"]


@pytest.mark.parametrize("method", RUN_METHODS)
def test_dp_run_keeps_ranks_identical(pool, method, tmp_path):
    """(c) A two-task run() of each family under --mesh 2x1: both ranks end
    with the same summary, memory, metrics, trainable state and counters
    (and zero-shot accuracy, for lora-clip and continual-clip), and only
    rank 0 writes files (each rank has its own log path here)."""
    r0, r1 = pool.run(R.short_run, 2, method, str(tmp_path))
    assert r0["summary"] == r1["summary"]
    assert r0["zero_shot"] == r1["zero_shot"]
    assert np.isfinite(r0["summary"]["A_last"])
    assert r0["memory"] == r1["memory"]
    for a, b in zip(r0["task_acc"], r1["task_acc"]):
        np.testing.assert_array_equal(a, b)
    if r0["trainable"] is not None:
        for k, v in r0["trainable"].items():
            np.testing.assert_array_equal(r1["trainable"][k], v)
    for k, v in r0["counters"].items():
        np.testing.assert_array_equal(r1["counters"][k], v)
    assert r1["files"] == []
    names = [os.path.basename(f) for f in r0["files"]]
    for f in ("result.txt", "result.jsonl", "log.txt", "seed_1.npy",
              "train_data_config.npy"):
        assert names.count(f) == 1, (f, r0["files"])


def test_dp_mesh_skipped_on_nondividing_batch(pool):
    """(f) Batch size 3 on a 2-way data axis: one warning, the whole batch
    on every rank (no all-reduce), the step equal to the 1-process one;
    eval keeps its road (test batch 4)."""
    kw = {"batchsize": 3}
    want = R.trainer_steps(0, 1, "l2p", (1, 1), cfg_kw=kw)
    for g in pool.run(R.trainer_steps, 2, "l2p", (2, 1), 2, False, None, kw):
        assert not g["dp"] and g["eval_dp"] and g["warned"]
        _same_step(g, want)


def test_ranks_draw_their_own_augmentation(pool):
    """(g) With the default transforms, rank 0's rows and rank 1's rows are
    the same two images, yet the ranks augment them differently (each
    folds its data index into the step's generator); the state generator
    stays the same on both."""
    (a, n0), (b, n1) = pool.run(R.aug_draws, 2)
    assert a.shape == b.shape
    assert np.abs(a - b).max() > 1e-3
    assert n0 == n1


def test_checkpoint_moves_between_meshes(pool, tmp_path):
    """(h) A checkpoint that rank 0 writes under --mesh 2x1 (after a barrier
    every rank sees it) restores bitwise under 1x1, and a 1x1 checkpoint
    restores bitwise on both ranks of a 2x1 mesh."""
    ck2 = str(tmp_path / "ck2")
    run = pool.run(R.short_run, 2, "lora-clip", str(tmp_path / "runs"),
                   ck2)[0]
    assert os.listdir(ck2) == ["checkpoint.pt"]
    one = R.restored(0, 1, ck2, (1, 1))
    for k, v in run["trainable"].items():
        np.testing.assert_array_equal(one["trainable"][k], v)
    assert one["cursor"]["task_id"] == 2

    ck1 = str(tmp_path / "ck1")
    R.short_run(0, 1, "lora-clip", str(tmp_path / "one"), ck1)
    want = R.restored(0, 1, ck1, (1, 1))
    for got in pool.run(R.restored, 2, ck1):
        for k, v in want["trainable"].items():
            np.testing.assert_array_equal(got["trainable"][k], v)
        np.testing.assert_array_equal(got["gen"], want["gen"])
        assert got["step"] == want["step"] and got["cursor"] == want["cursor"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_main_under_torchrun_env(pool, tmp_path):
    """main() as torchrun starts it (WORLD_SIZE, RANK, LOCAL_RANK and the
    rendezvous address in the environment) with --mesh 2x1 --device cpu:
    a gloo group, one result.txt from rank 0, the same summary on both
    ranks, the group destroyed at exit."""
    out = pool.run(R.main_under_env, 2, str(tmp_path), _free_port())
    assert out[0]["summary"] == out[1]["summary"]
    assert all(not o["initialized_after"] for o in out)
    found = [d for d, _, fs in os.walk(tmp_path) if "result.txt" in fs]
    assert len(found) == 1


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "4", "RANK": "0",
                                      "LOCAL_RANK": "0"}])
def test_mesh_without_matching_torchrun_raises(env, tmp_path, monkeypatch):
    """--mesh 2x1 with no torchrun environment, or with WORLD_SIZE != D*M,
    raises a ValueError before any process group starts."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="torchrun" if not env else
                       "needs 2 processes"):
        cli.main(["--method", "lora-clip", "--model_name", "debug-tiny",
                  "--dataset", "synthetic-10x8", "--n_tasks", "2",
                  "--device", "cpu", "--transforms", "--mesh", "2x1",
                  "--log_path", str(tmp_path)])
    assert not torch.distributed.is_initialized()


def test_trainer_mesh_needs_a_process_group():
    """A trainer asked for a mesh with no process group raises, naming
    torchrun."""
    from lifelong_clip_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh((2, 1), torch.device("cpu"))

