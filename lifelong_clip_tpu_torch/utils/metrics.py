"""Online-CL metrics: A_auc, A_avg, A_last, F_last, per-class accuracy.

Metric definitions match the reference exactly so results are comparable:
``methods/_trainer.py:359-401`` (save_result) and ``:519-534``
(_interpret_pred). Implemented as pure numpy over recorded eval points
rather than mutable meters threaded through the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class EvalPoint:
    """One periodic evaluation: overall + per-class accuracy snapshot."""
    step: int
    accuracy: float
    per_class_correct: np.ndarray
    per_class_total: np.ndarray


class OnlineMetrics:
    """Accumulates periodic evals per task and derives the headline metrics.

    A_auc  = mean of all periodic eval accuracies (area under the online
             accuracy curve; reference _trainer.py:367-372)
    A_avg  = mean of per-task final accuracies
    A_last = accuracy after the final task
    F_last = mean over classes of (max earlier accuracy - final accuracy)
             (forgetting; reference _trainer.py:373-378)
    """

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.eval_points: List[EvalPoint] = []
        self.task_acc: List[float] = []      # post-task accuracies
        self.task_cls_acc: List[np.ndarray] = []

    def record_eval(self, step: int, correct: np.ndarray, total: np.ndarray):
        acc = float(correct.sum() / max(total.sum(), 1))
        self.eval_points.append(
            EvalPoint(step, acc, correct.copy(), total.copy()))
        return acc

    def record_task_end(self, correct: np.ndarray, total: np.ndarray):
        acc = float(correct.sum() / max(total.sum(), 1))
        cls_acc = np.divide(correct, np.maximum(total, 1),
                            dtype=np.float64)
        self.task_acc.append(acc)
        self.task_cls_acc.append(cls_acc)
        return acc

    # -- headline metrics ----------------------------------------------------
    def a_auc(self) -> float:
        if not self.eval_points:
            return 0.0
        return float(np.mean([e.accuracy for e in self.eval_points]))

    def a_avg(self) -> float:
        return float(np.mean(self.task_acc)) if self.task_acc else 0.0

    def a_last(self) -> float:
        return self.task_acc[-1] if self.task_acc else 0.0

    def f_last(self) -> float:
        """Mean forgetting: for each class seen before the last task, max
        earlier accuracy minus final accuracy."""
        if len(self.task_cls_acc) < 2:
            return 0.0
        hist = np.stack(self.task_cls_acc)        # (T, C)
        final = hist[-1]
        earlier_max = hist[:-1].max(axis=0)
        seen = (np.stack([e.per_class_total for e in self.eval_points])
                .sum(axis=0) > 0) if self.eval_points else \
            (earlier_max > 0)
        forg = earlier_max - final
        return float(forg[seen].mean()) if seen.any() else 0.0

    def summary(self) -> Dict[str, float]:
        return {"A_auc": self.a_auc(), "A_avg": self.a_avg(),
                "A_last": self.a_last(), "F_last": self.f_last()}


def per_class_counts(preds: np.ndarray, labels: np.ndarray,
                     n_classes: int):
    """Per-class (correct, total) counters (reference _interpret_pred,
    _trainer.py:519-534, without the y//n_tasks quirk)."""
    total = np.bincount(labels, minlength=n_classes)
    correct = np.bincount(labels[preds == labels], minlength=n_classes)
    return correct.astype(np.int64), total.astype(np.int64)


def confusion_matrix(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """sklearn-compatible confusion matrix: rows = true, cols = predicted,
    over the sorted union of observed label/prediction values (the layout
    the reference saves via sklearn at adapter_clip.py:167 and
    _trainer.py:363-365)."""
    labels = np.asarray(labels, np.int64)
    preds = np.asarray(preds, np.int64)
    classes = np.unique(np.concatenate([labels, preds]))
    lut = np.zeros((int(classes.max()) + 1,), np.int64)
    lut[classes] = np.arange(len(classes))
    cm = np.zeros((len(classes), len(classes)), np.int64)
    np.add.at(cm, (lut[labels], lut[preds]), 1)
    return cm


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, k: int = 1):
    """Top-k accuracy (reference utils/metric.py:91-105)."""
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return float((topk == labels[:, None]).any(axis=1).mean())
