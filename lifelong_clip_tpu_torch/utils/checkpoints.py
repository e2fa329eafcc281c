"""Training checkpoints: save and resume the whole online-CL state.

Counterpart of ``lifelong_clip_tpu/utils/checkpoints.py`` on ``torch.save``
(the file format is the port's own; it does not read the JAX package's
orbax or pickle layout). A checkpoint directory holds one file,
``checkpoint.pt``, with

  * the train state: the trainable tensors, the optimizer's and the LR
    schedule's ``state_dict``, the step count and the augmentation
    generator's state;
  * the replay memory, the exposed-class vocabulary and the metric
    accumulators;
  * the stream cursor (``task_id``, ``samples_seen``, ``next_eval``;
    checkpoints are written at task ends, so a run resumes at the first
    batch of task ``task_id``) and the method's ``checkpoint_extra()``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

FILE = "checkpoint.pt"


def _train_state(state):
    if state is None:
        return None
    from ..methods.engine import tree_leaves
    return {"trainable": [p.detach().cpu() for p in
                          tree_leaves(state.trainable)],
            "opt": state.opt.state_dict(), "sched": state.sched.state_dict(),
            "step": state.step, "gen": state.gen.get_state()}


def save_checkpoint(path: str, *, mesh=None, state=None, memory=None,
                    vocab=None, cursor: Dict[str, Any] = None, metrics=None,
                    extra: Dict[str, Any] = None):
    """Write the run's state to ``path``/checkpoint.pt (written to a
    temporary name and renamed, so a crash mid-write leaves the previous
    checkpoint). Under a ``mesh`` (``parallel/mesh.py``) rank 0 writes,
    the ranks holding the same state, and every rank waits at a barrier
    until the file is there; every rank then restores from it, under any
    mesh: the file holds the whole trainable tree, its layout the same
    whatever the mesh."""
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
        return
    os.makedirs(path, exist_ok=True)
    ckpt = {
        "state": _train_state(state),
        "memory": memory.state_dict() if memory is not None else None,
        "vocab": vocab.state_dict() if vocab is not None else None,
        "cursor": cursor or {},
        "extra": extra or {},
        "metrics": None if metrics is None else {
            "task_acc": list(metrics.task_acc),
            "task_cls_acc": [np.asarray(a) for a in metrics.task_cls_acc],
            "eval_points": [(e.step, e.accuracy, e.per_class_correct,
                             e.per_class_total)
                            for e in metrics.eval_points]},
    }
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(ckpt, tmp)
    os.replace(tmp, os.path.join(path, FILE))
    if mesh is not None:
        mesh.barrier()


def load_checkpoint(path: str, map_location="cpu"):
    """The checkpoint dict ``save_checkpoint`` wrote. It holds numpy arrays
    and generator states beside tensors, so it is unpickled in full: load
    only checkpoints this program wrote."""
    return torch.load(os.path.join(path, FILE), map_location=map_location,
                      weights_only=False)


def restore_trainer(trainer, path: str):
    """Restore a freshly built trainer in place: train state (the trainable
    tensors copied into the live ones, so the optimizer keeps its
    parameters), memory, vocabulary, metrics and the method's extra state.
    Returns the cursor dict the run loop resumes from."""
    ckpt = load_checkpoint(path)
    st, state = ckpt["state"], getattr(trainer, "state", None)
    if st is not None and state is not None:
        from ..methods.engine import tree_leaves
        leaves = tree_leaves(state.trainable)
        if len(leaves) != len(st["trainable"]):
            raise ValueError(
                f"checkpoint {path} holds {len(st['trainable'])} trainable "
                f"tensors, the trainer {len(leaves)}")
        with torch.no_grad():
            for p, a in zip(leaves, st["trainable"]):
                p.copy_(a)
        state.opt.load_state_dict(st["opt"])
        state.sched.load_state_dict(st["sched"])
        state.step = st["step"]
        state.gen.set_state(st["gen"])
    if ckpt["memory"] and trainer.memory is not None:
        trainer.memory.load_state_dict(ckpt["memory"])
    if ckpt["vocab"] and trainer.vocab is not None:
        trainer.vocab.load_state_dict(ckpt["vocab"])
    m = ckpt["metrics"]
    if m:
        from .metrics import EvalPoint
        trainer.metrics.task_acc = list(m["task_acc"])
        trainer.metrics.task_cls_acc = [np.asarray(a)
                                        for a in m["task_cls_acc"]]
        trainer.metrics.eval_points = [
            EvalPoint(s, acc, np.asarray(c), np.asarray(t))
            for s, acc, c, t in m["eval_points"]]
    trainer.restore_extra(ckpt["extra"] or {})
    return ckpt["cursor"]
