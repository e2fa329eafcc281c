"""The port's ``--mesh 2x1`` steps against the JAX package's 2-device
shard_map steps (``tests/conftest.py``'s virtual devices) on the same
bridged weights and batches: the ranks are ``gloo`` CPU processes of one
pool for the file (``tests/torch_mesh_ranks.py``).

Tolerances: the loss at the single-device parity tests' rtol 1e-5, the
updated trainable leaves at rtol 1e-5 / atol 1e-6 (fp32, SGD at lr 0.1),
the selection counters exactly.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks as R  # noqa: E402

from lifelong_clip_tpu.config import PEFTConfig as JPEFT  # noqa: E402
from lifelong_clip_tpu.config import StreamConfig as JStream  # noqa: E402
from lifelong_clip_tpu.config import TrainConfig as JTrainConfig  # noqa
from lifelong_clip_tpu.config import resolve_clip_preset  # noqa: E402
from lifelong_clip_tpu.data.registry import make_synthetic as jsynth  # noqa
from lifelong_clip_tpu.methods import get_method as jget  # noqa: E402
from lifelong_clip_tpu.models.init import init_clip_params  # noqa: E402
from lifelong_clip_tpu.ops import preprocess as jpre  # noqa: E402
from lifelong_clip_tpu.parallel import mesh as jmesh  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = R.RankPool(2, str(tmp_path_factory.mktemp("pg")))
    yield p
    p.close()


JAX_METHODS = ["lora-clip", "mvp-clip", "l2p", "dualprompt", "er"]
JAX_COUNTER = {"mvp-clip": ("count", "count"), "l2p": ("frequency", "counter"),
               "dualprompt": ("e_frequency", "counter")}


def _jax_eval_like(mean, std):
    def run(rng, images_u8):
        x = images_u8.astype(jnp.float32) / 255.0
        x = jpre.resize_bilinear(x, R.IMG)
        return jpre.normalize(x, mean, std).astype(jnp.float32)
    return run


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded_build(model_name, pretrained_path=None, rng=None):
    """JAX's ``build_clip`` with no checkpoint: the preset's seeded init."""
    cfg = resolve_clip_preset(model_name)
    return init_clip_params(rng if rng is not None else
                            jax.random.PRNGKey(0), cfg), cfg


def _jax_trainer(method, tmp_path, monkeypatch):
    """JAX's trainer on a (2, 1) mesh of two virtual devices, its train
    pipeline replaced by the eval preprocessing, its zero trainable leaves
    given the same seeded draws as the port's."""
    # other test files swap the builder in JAX's method modules for a tower
    # of their own and leave it swapped in their worker process
    for name, mod in list(sys.modules.items()):
        if (name.startswith("lifelong_clip_tpu.methods.")
                and hasattr(mod, "build_clip")):
            monkeypatch.setattr(mod, "build_clip", _seeded_build)
    orig = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, devices=None:
                        orig(shape, jax.devices()[:2]))
    train = jsynth(n_classes=R.N_CLS, per_class=6, image_size=R.IMG, seed=0)
    test = jsynth(n_classes=R.N_CLS, per_class=2, image_size=R.IMG, seed=0,
                  train=False)
    monkeypatch.setattr(jpre, "make_train_pipeline", lambda *a, **kw:
                        _jax_eval_like(train.mean, train.std))
    cls = jget(method)
    cls = type(cls.__name__, (cls,), R.ATTRS.get(method, {}))
    cfg = JTrainConfig(
        method=method, dataset="synthetic-8", model_name="debug-tiny",
        batchsize=R.B, test_batchsize=R.B, online_iter=1, lr=0.1,
        opt_name="sgd", memory_size=16 if method in R.ER_FAMILY else 0,
        transforms=(), use_bf16=False, peft=JPEFT(encoder="both"),
        stream=JStream(n_tasks=2, n=50, m=10, seed=1),
        log_path=str(tmp_path / "jax"), seed=1, mesh_shape=(2, 1))
    jtr = cls(cfg, train_dataset=train, test_dataset=test)
    assert jtr._dp_mesh is not None
    rng = np.random.default_rng(5)
    trainable = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if not np.asarray(a).any() else np.array(a),
        jtr.state.trainable)
    jtr.state = jtr.state.replace(
        trainable=jax.tree.map(jnp.asarray, trainable),
        opt_state=jtr.tx.init(jax.tree.map(jnp.asarray, trainable)))
    return jtr, trainable


@pytest.mark.parametrize("method", JAX_METHODS)
def test_dp_step_matches_jax_shard_map(pool, method, tmp_path, monkeypatch):
    """(a) The port's --mesh 2x1 steps against JAX's 2-device shard_map
    steps (the DP road of each trainer: the contrastive mass all-gather
    of mvp-clip, the summed selection counts of l2p and dualprompt) on the
    same bridged weights and batches."""
    jtr, trainable = _jax_trainer(method, tmp_path, monkeypatch)
    losses = []
    for images, labels, idx in R.batches(2):
        jtr.vocab.expose(labels)
        st = jtr.online_step(images, labels, idx)
        losses.append((float(st["loss"]), float(st["acc"])))
    # the JAX step donates its state: read the frozen tree from the new one
    got = pool.run(R.bridged_steps, 2, method, _np(jtr.state.frozen),
                   trainable)
    want_tree = R.flat(_np(jtr.state.trainable))
    for g in got:
        np.testing.assert_allclose(np.array(g["losses"]), np.array(losses),
                                   rtol=RTOL)
        assert g["trainable"].keys() == want_tree.keys()
        for k, v in want_tree.items():
            np.testing.assert_allclose(g["trainable"][k], v, rtol=RTOL,
                                       atol=ATOL, err_msg=str(k))
        if method in JAX_COUNTER:
            jname, tname = JAX_COUNTER[method]
            np.testing.assert_array_equal(
                g["counters"][tname], np.asarray(getattr(jtr, jname)))
