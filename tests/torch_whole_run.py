"""Whole-run parity: the JAX package's trainer and the port's for one method
name, each through ``run()`` over the same two-task Si-Blurry stream, and
the checks that hold the two runs to each other.

Not collected (no ``test_`` prefix): ``tests/test_torch_whole_run_*.py``
drive it, one file a family. Both trainers get:

- ``debug-tiny`` in fp32, the same frozen tower (JAX's seeded init, bridged
  into the port) patched into the trainer modules' ``build_clip``, and
  JAX's starting trainable tree copied leaf by leaf into the port's, whose
  optimizer state is then made fresh;
- the same ``make_synthetic`` contents as the train and the test set;
- the train pipeline replaced by the eval preprocessing (``--transforms``
  with no values): the packages draw augmentation differently;
- JAX on its ``"xla"`` road, the port on the road the case names;
- for moe-clip, JAX's gate-noise draws (``jax_gate_noise``).

What each run records (``Recorder``): every train step's loss and the
labels of the rows it trained on (whatever attribute the trainer's step
goes through), the steps of each ``online_step`` call, the replay memory's
(index, label) slots after each task, every eval point's per-sample
predictions (JAX's also with their masked logits, for the top-2 margin)
and accuracy, the final result and ``result.txt``. ``check`` holds the two
records to the bounds of ``tests/test_whole_run_parity.py:852-865`` and
returns each bound's largest distance.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_clip_tpu.config import PEFTConfig as JPEFTConfig
from lifelong_clip_tpu.config import StreamConfig as JStreamConfig
from lifelong_clip_tpu.config import TrainConfig as JTrainConfig
from lifelong_clip_tpu.config import resolve_clip_preset as jpreset
from lifelong_clip_tpu.data.registry import make_synthetic as jsynthetic
from lifelong_clip_tpu.methods import get_method as jget_method
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.ops import attention as jattention
from lifelong_clip_tpu.ops import preprocess as jpre
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import PEFTConfig, StreamConfig
from lifelong_clip_tpu_torch.config import TrainConfig
from lifelong_clip_tpu_torch.config import resolve_clip_preset
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods import get_method
from lifelong_clip_tpu_torch.ops import preprocess as tpre
from lifelong_clip_tpu_torch.utils.stream import (exposed_test_indices,
                                                  iter_batches)
from torch_learning_gates import copy_trainable, flat, one_thread  # noqa: F401

# the registries import every trainer module (CLIB's scipy.stats, the
# meshes' torch.distributed): once, while the test files are collected
jget_method("er"), get_method("er")
N_CLS, PER_CLASS = 8, 8     # 64 samples, 32 a task
STREAM = dict(n_tasks=2, n=50, m=10, seed=1)
# tests/test_whole_run_parity.py:852-865 and :1133
LOSS0_TOL = 1e-4          # step 0: rtol and atol
LOSS10_TOL = 2e-2         # the first 10 steps: rtol and atol
MEAN_LOSS_TOL = 0.05
ACC_TOL = 0.01            # mvp: 0.02
NEAR_TIE = 1e-3           # of the eval point's logit scale
# the attributes a trainer's train step goes through, in either package
STEP_ATTRS = ("_train_step", "train_step", "_step", "_mvp_step", "_kd_step",
              "_ewc_step", "ewc_step", "_clib_step", "clib_step")


@dataclasses.dataclass(frozen=True)
class Case:
    """One whole run: the method name, the TrainConfig fields that differ
    from ``BASE`` (``peft``: PEFTConfig fields), the port's road, the
    eval-accuracy bound and the method flags that ``main`` sets as trainer
    class attributes (``_ATTR_FLAGS``), on both sides."""
    method: str
    flags: tuple = ()
    peft: tuple = ()
    impl: str = "fused"
    acc_tol: float = ACC_TOL
    attrs: tuple = ()

    @property
    def name(self):
        enc = dict(self.peft).get("encoder")
        return self.method + (f" {enc}" if enc else "")


BASE = dict(dataset="synthetic-8", model_name="debug-tiny", batchsize=4,
            test_batchsize=16, online_iter=1, lr=5e-2, opt_name="adamw",
            eval_period=12, memory_size=0, transforms=(), use_bf16=False,
            seed=1)
# the ER family: scripts/er.sh's memory and temp batch in ratio (memory half
# the stream, half of each step's rows from it), scaled to 64 samples
ER_FLAGS = (("batchsize", 4), ("temp_batchsize", 2), ("memory_size", 32))
# the prompt pools: Adam with online_iter 3, as the scripts' cifar100 row
POOL_FLAGS = (("opt_name", "adam"), ("lr", 5e-2), ("online_iter", 3))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the same inputs on both sides
# ---------------------------------------------------------------------------

def _jax_eval_like(img_size, mean, std, *, out_dtype=jnp.float32, **_):
    """JAX's train pipeline replaced by its eval preprocessing."""
    def pipeline(rng, images_u8):
        x = jpre.resize_bilinear(images_u8.astype(jnp.float32) / 255.0,
                                 img_size)
        return jpre.normalize(x, mean, std).astype(out_dtype)
    return pipeline


def _port_eval_like(img_size, mean, std, *, out_dtype=torch.float32, **_):
    """The port's train pipeline replaced by its eval preprocessing."""
    eval_pipe = tpre.make_eval_pipeline(img_size, mean, std,
                                        out_dtype=out_dtype)
    return lambda gen, images_u8: eval_pipe(images_u8)


@functools.lru_cache(maxsize=1)
def frozen_tower():
    """The debug-tiny CLIP tree from JAX's seeded init, as numpy (one jitted
    init: eager, its hundreds of small ops each compile)."""
    init = jax.jit(init_clip_params, static_argnums=1)
    return _np(init(jax.random.PRNGKey(0), jpreset("debug-tiny")))


def _patch_inputs(mp, classes, frozen):
    """Both packages' train pipelines, JAX's road, and ``build_clip`` in the
    module of each trainer class and of its bases (JAX's older tests leave
    other builders swapped in a worker)."""
    mp.setattr(jattention, "_DEFAULT_IMPL", "xla")
    mp.setattr(jpre, "make_train_pipeline", _jax_eval_like)
    mp.setattr(tpre, "make_train_pipeline", _port_eval_like)
    jcfg, tcfg = jpreset("debug-tiny"), resolve_clip_preset("debug-tiny")
    builders = {
        "lifelong_clip_tpu.": lambda *a, **kw: (
            jax.tree.map(jnp.asarray, frozen), jcfg),
        "lifelong_clip_tpu_torch.": lambda *a, device=None, **kw: (
            params_from_numpy(frozen, device or "cpu"), tcfg)}
    for cls in classes:
        for base in cls.__mro__:
            mod = sys.modules[base.__module__]
            if hasattr(mod, "build_clip"):
                prefix = max((p for p in builders
                              if mod.__name__.startswith(p)), key=len)
                mp.setattr(mod, "build_clip", builders[prefix])


def configs(case: Case, tmp):
    """(JAX TrainConfig, the port's) for ``case``, logging under ``tmp``."""
    kw = dict(BASE, **dict(case.flags))
    jcfg = JTrainConfig(method=case.method, stream=JStreamConfig(**STREAM),
                        peft=JPEFTConfig(**dict(case.peft)),
                        log_path=os.path.join(tmp, "jax"), **kw)
    tcfg = TrainConfig(method=case.method, stream=StreamConfig(**STREAM),
                       peft=PEFTConfig(**dict(case.peft)),
                       log_path=os.path.join(tmp, "port"), device="cpu",
                       **kw)
    return jcfg, tcfg


def port_class(case: Case):
    """The port's trainer class on the case's road (the trainers name the
    class attribute ``attn_impl`` or ``_attn_impl``)."""
    cls = get_method(case.method)
    return type(cls.__name__, (cls,), {"attn_impl": case.impl,
                                       "_attn_impl": case.impl,
                                       **dict(case.attrs)})


# ---------------------------------------------------------------------------
# recording a run
# ---------------------------------------------------------------------------

def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _labels_of(args):
    for a in args:
        if isinstance(a, dict) and "labels" in a:
            return _host(a["labels"]).copy()
    raise AssertionError("a train step with no batch")


def _loss_of(out):
    for o in (out if isinstance(out, tuple) else (out,)):
        if isinstance(o, dict) and "loss" in o:
            return float(o["loss"])
    raise AssertionError(f"a train step returned no loss: {type(out)}")


class Recorder:
    """Wraps a trainer's hooks (instance attributes, so the class and other
    trainers are untouched) and records what ``run()`` does."""

    def __init__(self, tr, jax_side: bool):
        self.tr, self.jax_side = tr, jax_side
        self.steps = []        # (loss, labels), in call order
        self.rngs = []         # JAX: each step's state key
        self.calls = []        # train steps a call of online_step made
        self.memory = []       # (index, label) slots after each task
        self.evals = []        # one dict an eval point
        self.task, self._kind, self._depth = 0, "task end", 0
        self._preds, self._logits = [], []
        for attr in STEP_ATTRS:
            fn = getattr(tr, attr, None)
            if callable(fn):
                setattr(tr, attr, self._step(fn))
        for attr in ("online_step", "online_before_task",
                     "online_after_task", "evaluate", "predict",
                     "_periodic_eval"):
            setattr(tr, attr, getattr(self, "wrap_" + attr.lstrip("_"))(
                getattr(tr, attr)))
        if jax_side:
            self._hook_jax_logits()

    # -- steps ---------------------------------------------------------------
    def _step(self, fn):
        def wrapped(*a, **kw):
            if self.jax_side and self._depth == 0 and hasattr(a[0], "rng"):
                self.rngs.append(np.asarray(a[0].rng))
            self._depth += 1
            try:
                out = fn(*a, **kw)
            finally:
                self._depth -= 1
            if self._depth == 0:
                self.steps.append((_loss_of(out), _labels_of(a)))
            return out
        return wrapped

    def wrap_online_step(self, fn):
        def wrapped(*a, **kw):
            n = len(self.steps)
            out = fn(*a, **kw)
            self.calls.append(len(self.steps) - n)
            return out
        return wrapped

    def wrap_online_before_task(self, fn):
        def wrapped(task_id):
            self.task = task_id
            return fn(task_id)
        return wrapped

    def wrap_online_after_task(self, fn):
        def wrapped(task_id):
            out = fn(task_id)
            mem = self.tr.memory
            self.memory.append(list(zip(map(int, mem.indices),
                                        map(int, mem.labels))))
            return out
        return wrapped

    # -- evaluation ------------------------------------------------------------
    def wrap_periodic_eval(self, fn):
        def wrapped():
            self._kind = "periodic"
            try:
                return fn()
            finally:
                self._kind = "task end"
        return wrapped

    def wrap_evaluate(self, fn):
        def wrapped():
            tr = self.tr
            n = len(exposed_test_indices(tr.test_dataset.targets,
                                         tr.vocab.exposed))
            self._preds, self._logits = [], []
            correct, total = fn()
            bs = tr.cfg.test_batchsize
            keep = [min(bs, n - lo) for lo in range(0, n, bs)]
            assert len(keep) == len(self._preds), (len(keep),
                                                   len(self._preds))
            rec = {"task": self.task, "kind": self._kind, "n": n,
                   "acc": float(correct.sum()) / max(float(total.sum()), 1),
                   "preds": np.concatenate(
                       [p[:k] for p, k in zip(self._preds, keep)])
                   if n else np.zeros(0, np.int64)}
            if self.jax_side and n:
                assert len(self._logits) == len(keep)
                rec["logits"] = np.concatenate(
                    [lg[:k] for lg, k in zip(self._logits, keep)])
            self.evals.append(rec)
            return correct, total
        return wrapped

    def wrap_predict(self, fn):
        def wrapped(images):
            out = fn(images)
            self._preds.append(_host(out).copy())
            return out
        return wrapped

    def _hook_jax_logits(self):
        """Record the masked logits behind JAX's predictions: the eval step
        returns them beside its argmax (the adapter family, MaPLe,
        mvp-clip); the ER family's and the prompt pools' jitted predict
        ends in ``jnp.argmax(logits)``, so its Python body is traced again
        with that argmax left out and the argmax taken after."""
        tr = self.tr
        if callable(getattr(tr, "_eval_fn", None)):
            fn = tr._eval_fn

            def eval_fn(*a, **kw):
                out = fn(*a, **kw)
                self._logits.append(np.asarray(out[1]))
                return out
            tr._eval_fn = eval_fn
            return
        body = tr._predict_fn.__wrapped__

        def traced(*a):
            real = jnp.argmax
            jnp.argmax = lambda x, axis=-1: x
            try:
                return body(*a)
            finally:
                jnp.argmax = real
        logits_fn = jax.jit(traced)

        def predict_fn(*a):
            logits = logits_fn(*a)
            self._logits.append(np.asarray(logits))
            return jnp.argmax(logits, axis=-1)
        tr._predict_fn = predict_fn


@dataclasses.dataclass
class Run:
    rec: Recorder
    result: dict
    result_txt: list
    n_batches: int
    run_s: float            # run(), JAX's traces and compiles included
    start: dict = None      # JAX: the starting trainable tree, numpy
    build_s: float = 0.0    # the trainer's construction


def run_recorded(tr, jax_side: bool) -> Run:
    rec = Recorder(tr, jax_side)
    t0 = time.perf_counter()
    result = tr.run()
    run_s = time.perf_counter() - t0
    with open(os.path.join(tr.result_dir(), "result.txt")) as f:
        lines = f.read().splitlines()
    n_batches = sum(len(list(iter_batches(t, tr.cfg.batchsize)))
                    for t in tr.stream.task_indices)
    return Run(rec, result, lines, n_batches, run_s)


def _data(make):
    return make(n_classes=N_CLS, per_class=PER_CLASS, image_size=32, seed=0)


def jax_trainer(case: Case, tmp, mp):
    """The JAX trainer of ``case`` (``mp``: a MonkeyPatch the caller
    undoes), its data as the train and the test set."""
    jcls = jget_method(case.method)
    jcls = type(jcls.__name__, (jcls,), dict(case.attrs))
    _patch_inputs(mp, (jcls,), frozen_tower())
    data = _data(jsynthetic)
    return jcls(configs(case, str(tmp))[0], train_dataset=data,
                test_dataset=data)


def port_trainer(case: Case, tmp, mp, start):
    """The port's trainer of ``case`` on the same data and tower, its
    trainable tree set to JAX's starting one (``start``)."""
    tcls = port_class(case)
    _patch_inputs(mp, (tcls,), frozen_tower())
    data = _data(make_synthetic)
    np.testing.assert_array_equal(data.images,
                                  _data(jsynthetic).images)
    ttr = tcls(configs(case, str(tmp))[1], train_dataset=data,
               test_dataset=data)
    copy_trainable(start, ttr)
    return ttr


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _keys(line):
    """A result.txt line's keys: the words before each value."""
    return [part.strip().split(":")[0].split(" ")[0]
            for part in line.split("|")]


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", line)]


def check(case: Case, j: Run, t: Run) -> dict:
    """Hold the port's run to JAX's; returns each bound's largest distance
    (and the near ties let through) for the report."""
    jr, tr = j.rec, t.rec
    report = {"case": case.name, "steps": len(jr.steps),
              "evals": len(jr.evals)}
    # 1. the stream and 2. the memory after each task, exactly (the memory
    # first: its slots feed later steps' rows)
    assert len(jr.calls) == j.n_batches == t.n_batches == len(tr.calls), \
        (len(jr.calls), j.n_batches, len(tr.calls))
    assert all(c >= 1 for c in jr.calls), jr.calls
    assert tr.calls == jr.calls, (tr.calls, jr.calls)
    assert len(tr.memory) == len(jr.memory) == STREAM["n_tasks"]
    for task, (jm, tm) in enumerate(zip(jr.memory, tr.memory)):
        assert tm == jm, (f"memory after task {task}", tm, jm)
    assert len(tr.steps) == len(jr.steps) >= 10, (len(tr.steps),
                                                  len(jr.steps))
    for k, ((_, jy), (_, ty)) in enumerate(zip(jr.steps, tr.steps)):
        np.testing.assert_array_equal(ty, jy, err_msg=f"step {k} labels")
    # 3. the losses
    jl = np.array([s[0] for s in jr.steps])
    tl = np.array([s[0] for s in tr.steps])
    assert np.isfinite(jl).all() and np.isfinite(tl).all()
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS0_TOL, atol=LOSS0_TOL,
                               err_msg="step-0 loss")
    np.testing.assert_allclose(tl[:10], jl[:10], rtol=LOSS10_TOL,
                               atol=LOSS10_TOL, err_msg="first 10 losses")
    mean_d = abs(float(tl.mean() - jl.mean()))
    assert mean_d < MEAN_LOSS_TOL, ("mean loss", tl.mean(), jl.mean())
    report.update(loss0=float(abs(tl[0] - jl[0])),
                  loss10=float(np.abs(tl[:10] - jl[:10]).max()),
                  loss_mean=mean_d)
    # 4. every eval point: predictions but near ties, accuracy
    assert len(tr.evals) == len(jr.evals)
    for task in range(STREAM["n_tasks"]):
        assert any(e["kind"] == "periodic" and e["task"] == task
                   for e in jr.evals), f"no periodic eval in task {task}"
    acc_d, ties = 0.0, []
    for k, (je, te) in enumerate(zip(jr.evals, tr.evals)):
        assert (te["task"], te["kind"], te["n"]) == \
            (je["task"], je["kind"], je["n"]), (k, te, je)
        diff = np.flatnonzero(te["preds"] != je["preds"])
        if len(diff):
            lg = je["logits"]
            fin = np.where(np.isfinite(lg), lg, -np.inf)
            top2 = np.sort(fin, axis=-1)[:, -2:]
            margin = top2[:, 1] - top2[:, 0]
            scale = float(np.abs(lg[np.isfinite(lg)]).max())
            for i in diff:
                print(f"{case.name}: eval {k} sample {i}: JAX {je['preds'][i]}"
                      f" port {te['preds'][i]}, JAX top-2 margin "
                      f"{margin[i]:.3g} of scale {scale:.3g}")
            assert len(diff) <= 1 and margin[diff[0]] < NEAR_TIE * scale, \
                (f"eval {k}: {len(diff)} predictions differ", diff,
                 margin[diff], scale)
            ties.append((k, int(diff[0])))
        acc_d = max(acc_d, abs(te["acc"] - je["acc"]))
        assert abs(te["acc"] - je["acc"]) <= case.acc_tol, (k, te["acc"],
                                                            je["acc"])
    report.update(acc=acc_d, near_ties=ties)
    # the summary and result.txt
    assert set(t.result) == set(j.result) == {"A_auc", "A_avg", "A_last",
                                              "F_last"}
    summary_d = max(abs(t.result[k] - j.result[k]) for k in j.result)
    assert summary_d <= case.acc_tol, (t.result, j.result)
    assert len(t.result_txt) == len(j.result_txt) == 3
    for tline, jline in zip(t.result_txt, j.result_txt):
        assert _keys(tline) == _keys(jline), (tline, jline)
    for tline, jline in zip(t.result_txt[:2], j.result_txt[:2]):
        np.testing.assert_allclose(_numbers(tline), _numbers(jline),
                                   atol=case.acc_tol, rtol=0)
    report.update(summary=summary_d, jax_result=j.result,
                  a_auc=j.result["A_auc"], jax_build_s=j.build_s,
                  jax_run_s=j.run_s, port_build_s=t.build_s,
                  port_run_s=t.run_s)
    return report


_JAX_RUNS = {}


def jax_run(case: Case, tmp) -> Run:
    """JAX's run of ``case``, made once a process and shared by the tests
    that read it."""
    if case not in _JAX_RUNS:
        with pytest.MonkeyPatch.context() as mp:
            t0 = time.perf_counter()
            jtr = jax_trainer(case, tmp, mp)
            start = _np(jtr.state.trainable)
            build_s = time.perf_counter() - t0
            _JAX_RUNS[case] = run = run_recorded(jtr, True)
            run.start, run.build_s = start, build_s
    return _JAX_RUNS[case]


def jax_gate_noise(mp, rngs, cfg):
    """The MoE gate noise of JAX's train steps, fed to the port's steps in
    order: each JAX step draws it from its state key (``engine.py:264``,
    the fourth of four), one key a vision layer (``models/clip.py:279``),
    (rows, E) N(0, 1) draws each (``ops/moe.py:41``); the port's step draws
    it from its generator (``draw_gate_noise``). The packages cannot share
    the draw, so the port takes JAX's."""
    from lifelong_clip_tpu_torch.methods import engine as tengine
    keys = iter(rngs)

    def draw(gen, shape, device):
        layers, rows, experts = shape
        moe_key = jax.random.split(next(keys), 4)[3]
        noise = np.stack([np.asarray(jax.random.normal(k, (rows, experts)))
                          for k in jax.random.split(moe_key, layers)])
        return torch.tensor(noise, device=device)

    assert cfg.peft.encoder == "image", "one noise draw a step: the vision"
    mp.setattr(tengine.moe_ops, "draw_gate_noise", draw)


def whole_run(case: Case, tmp, *, patch=None) -> tuple:
    """(JAX's run, the port's run) of ``case``; ``patch(mp, trainer)``
    changes the port's side before its run."""
    j = jax_run(case, os.path.join(str(tmp), "j"))
    with pytest.MonkeyPatch.context() as mp:
        t0 = time.perf_counter()
        ttr = port_trainer(case, os.path.join(str(tmp), "t"), mp, j.start)
        build_s = time.perf_counter() - t0
        if case.method == "moe-clip":
            jax_gate_noise(mp, j.rec.rngs, ttr.cfg)
        if patch is not None:
            patch(mp, ttr)
        t = run_recorded(ttr, False)
    t.build_s = build_s
    return j, t


def report_line(rep: dict) -> str:
    return "whole-run " + json.dumps(rep, default=float)
