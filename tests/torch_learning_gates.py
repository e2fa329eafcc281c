"""The learning-quality floors of ``tests/test_learning_quality.py`` for the
port's trainers: each case's ``run()`` over the fittable synthetic stream
must land its final and its area-under-curve accuracy above JAX's pinned
floors, well above the 1/8 chance a run that stopped learning lands at.

Not collected (no ``test_`` prefix): ``tests/test_torch_learning_quality_*.py``
drive it. Imports nothing of JAX. Every case has the JAX test's stream,
tower and config: ``make_synthetic(n_classes=8, per_class=64,
image_size=32, seed=0)`` with the 8 x 8 test split, ``tests/test_engine.py:
TINY``, ``tiny_cfg`` (bs 8, 2 tasks, n=50, m=10, seed 1, fp32, no
transforms) with the case's lr, online_iter and memory, and the tiny knobs
of ``tests/test_sharding.py:_tiny_trainer_for``. The port runs its
``"unfused"`` road, as JAX's test runs its ``"xla"`` road on the CPU.

The floors were pinned on the JAX trainers' seed-1 draws (their starting
trees). The port draws from ``torch.Generator`` (``models/init.py``), so
each case starts from the JAX test's own starting trees: the frozen tower
and the trainable tree, read from ``START`` (written by ``python
tools/torch_learning_floors.py write``) through the bridge. The tower's
token table holds only the rows the runs read; every other row is NaN, so
a run that reads one fails. ``own_init_run`` runs a case from the port's
own draws.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import (CLIPConfig, StreamConfig,
                                            TrainConfig)
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods import get_method
from lifelong_clip_tpu_torch.models.init import init_clip_params

# tests/test_engine.py:TINY
TINY = CLIPConfig(embed_dim=64, image_size=32, patch_size=8, vision_width=64,
                  vision_layers=2, vision_heads=4, context_length=77,
                  vocab_size=49408, text_width=64, text_heads=4,
                  text_layers=2)
START = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "learning_gate_start.npz")
ROWS = "token_rows"       # the token table rows the runs read, in START


@dataclasses.dataclass(frozen=True)
class Gate:
    """One case of ``tests/test_learning_quality.py``: its lr, online_iter,
    floors and JAX's measured A_last / A_auc there (``healthy``); ``flags``:
    TrainConfig fields, ``attrs``: trainer class attributes."""
    method: str
    lr: float
    online_iter: int
    last_floor: float
    auc_floor: float
    healthy: str
    flags: tuple = (("memory_size", 0),)
    attrs: tuple = ()


GATES = {g.method: g for g in (
    Gate("er", 0.1, 8, 0.35, 0.25, "0.70/0.59",
         flags=(("memory_size", 128),)),
    Gate("mvp-clip", 3e-2, 16, 0.22, 0.16, "0.344/0.202"),
    Gate("maple", 1e-2, 16, 0.19, 0.22, "0.250/0.307"),
    Gate("adapter-clip-proto_prompt", 1e-2, 8, 0.25, 0.22, "0.359/0.315",
         attrs=(("n_ctx", 3), ("top_k", 2), ("num_prompt", 4),
                ("num_sampled_pcls", 8), ("ca_epochs", 1))),
    Gate("l2p", 1e-2, 8, 0.30, 0.35, "0.438/0.534",
         attrs=(("pool_size", 4), ("selection_size", 2), ("prompt_len", 2))),
)}


def one_thread():
    """A tiny tower gains nothing from intra-op threads, and under the
    suite's parallel workers those threads oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data():
    """(train, test): the JAX test's stream and test split."""
    return (make_synthetic(n_classes=8, per_class=64, image_size=32, seed=0),
            make_synthetic(n_classes=8, per_class=8, image_size=32, seed=0,
                           train=False))


def config(gate: Gate, log_path: str, seed: int = 1) -> TrainConfig:
    """``tests/test_engine.py:tiny_cfg`` with the case's fields, on the
    CPU."""
    return TrainConfig(
        method=gate.method, dataset="synthetic-8", model_name="ViT-B/16",
        batchsize=8, test_batchsize=8, online_iter=gate.online_iter,
        lr=gate.lr, eval_period=64, temp_batchsize=0,
        stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1), transforms=(),
        use_bf16=False, log_path=log_path, debug=True, seed=seed,
        device="cpu", **dict(gate.flags))


def trainer_class(gate: Gate):
    """The port's trainer of ``gate`` on the ``"unfused"`` road (the
    trainers name the class attribute ``attn_impl`` or ``_attn_impl``)."""
    cls = get_method(gate.method)
    return type(cls.__name__, (cls,), {"attn_impl": "unfused",
                                       "_attn_impl": "unfused",
                                       **dict(gate.attrs)})


def patch_build(mp, cls, build):
    """``build_clip`` in the module of ``cls`` and of each of its bases."""
    for base in cls.__mro__:
        mod = sys.modules[base.__module__]
        if hasattr(mod, "build_clip"):
            mp.setattr(mod, "build_clip", build)


def flat(tree, path=()) -> dict:
    """{key path: leaf} of a nested dict, whatever its key order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def nest(named: dict) -> dict:
    """{"a/b/c": leaf} (``START``'s names) -> nested dicts."""
    out = {}
    for name, leaf in named.items():
        *heads, last = name.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def load_start(method: str):
    """(frozen tower, trainable tree) as numpy: the JAX test's seed-1
    starting trees of ``method`` from ``START``, the token table's other
    rows NaN."""
    with np.load(START) as f:
        arrays = dict(f)
    frozen = nest({k[len("frozen/"):]: v for k, v in arrays.items()
                   if k.startswith("frozen/")})
    rows = arrays[ROWS]
    table = np.full((TINY.vocab_size, TINY.text_width), np.nan, np.float32)
    table[rows] = frozen["text"]["token_embedding"]
    frozen["text"]["token_embedding"] = table
    pre = method + "/"
    trainable = nest({k[len(pre):]: v for k, v in arrays.items()
                      if k.startswith(pre)})
    return frozen, trainable


def copy_trainable(start: dict, tr):
    """``start``'s leaves (numpy) into the trainer's trainable tree (the
    same keys and shapes), then fresh optimizer moments over them."""
    want = flat(params_from_numpy(start))
    live = flat(tr.state.trainable)
    assert live.keys() == want.keys(), set(live) ^ set(want)
    with torch.no_grad():
        for k, p in live.items():
            if p is None or want[k] is None:
                assert p is None and want[k] is None, k
                continue
            assert p.shape == want[k].shape, k
            p.copy_(want[k])
    tr.state.reset_optimizer()


def gate_run(gate: Gate, log_path: str) -> dict:
    """The port's ``run()`` of ``gate`` from the JAX test's starting trees;
    returns its result (A_auc, A_avg, A_last, F_last)."""
    frozen, start = load_start(gate.method)
    cls = trainer_class(gate)
    train, test = data()
    with pytest.MonkeyPatch.context() as mp:
        patch_build(mp, cls, lambda *a, device=None, **kw: (
            params_from_numpy(frozen, device or "cpu"), TINY))
        tr = cls(config(gate, log_path), train_dataset=train,
                 test_dataset=test)
        copy_trainable(start, tr)
        return tr.run()


def own_init_run(gate: Gate, log_path: str, seed: int = 1) -> dict:
    """The port's ``run()`` of ``gate`` from its own seeded draws (the
    trainer's generators, ``models/init.py`` for the tower)."""
    cls = trainer_class(gate)
    train, test = data()

    def build(model_name=None, pretrained_path=None, gen=None, device=None):
        return init_clip_params(gen, TINY, device=device), TINY

    with pytest.MonkeyPatch.context() as mp:
        patch_build(mp, cls, build)
        tr = cls(config(gate, log_path, seed), train_dataset=train,
                 test_dataset=test)
        return tr.run()


def check(gate: Gate, out: dict, start: str = "JAX's seed-1 trees"):
    """Print the case's accuracies beside JAX's and hold them to the
    floors."""
    print(f"learning gate {gate.method} from {start}: A_last "
          f"{out['A_last']:.4f} (floor {gate.last_floor}), A_auc "
          f"{out['A_auc']:.4f} (floor {gate.auc_floor}); JAX's measured "
          f"A_last/A_auc {gate.healthy}")
    assert np.isfinite([out[k] for k in ("A_last", "A_auc")]).all(), out
    assert out["A_last"] > gate.last_floor, (
        f"{gate.method}: A_last {out['A_last']:.3f} under the floor "
        f"{gate.last_floor} (chance 0.125, JAX {gate.healthy}): this "
        "family stopped learning")
    assert out["A_auc"] > gate.auc_floor, (
        f"{gate.method}: A_auc {out['A_auc']:.3f} under the floor "
        f"{gate.auc_floor}: the periodic evals never rose above chance")
