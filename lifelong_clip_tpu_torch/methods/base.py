"""Host-side orchestration of the online CL lifecycle.

Counterpart of ``lifelong_clip_tpu/methods/base.py:OnlineTrainer`` (the
reference's ``_Trainer``, ``methods/_trainer.py:249-653``): seeding, stream
and dataset setup, the task x batch loop, periodic online evaluation and the
result artifacts in the reference's format. Device meshes, the batch
prefetcher and checkpoint/resume are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import TrainConfig, resolve_clip_preset
from ..data.registry import ArrayDataset, get_dataset
from ..device import resolve_device
from ..utils.class_vocab import ClassVocabulary
from ..utils.memory import ReplayMemory
from ..utils.metrics import OnlineMetrics, confusion_matrix, per_class_counts
from ..utils.stream import (exposed_test_indices, iter_batches,
                            si_blurry_stream, stream_class_histogram)

log = logging.getLogger("lifelong_clip_tpu_torch")


class OnlineTrainer:
    """Base online continual-learning trainer."""

    def __init__(self, cfg: TrainConfig,
                 train_dataset: Optional[ArrayDataset] = None,
                 test_dataset: Optional[ArrayDataset] = None,
                 synthetic_fallback: bool = False):
        if tuple(cfg.mesh_shape) != (1, 1):
            raise NotImplementedError(
                f"device meshes are not ported yet (got {cfg.mesh_shape}); "
                "run with --mesh 1x1 (ROADMAP.md, queue A)")
        if cfg.ckpt_dir or cfg.resume_from:
            raise NotImplementedError(
                "checkpoint/resume is not ported yet (ROADMAP.md, queue A)")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.gen = torch.Generator().manual_seed(cfg.seed)

        self.train_dataset = train_dataset or get_dataset(
            cfg.dataset, cfg.data_dir, train=True,
            synthetic_fallback=synthetic_fallback)
        self.test_dataset = test_dataset or get_dataset(
            cfg.dataset, cfg.data_dir, train=False,
            synthetic_fallback=synthetic_fallback)
        self.n_classes = self.train_dataset.n_classes

        self.stream = si_blurry_stream(
            self.train_dataset.targets, self.n_classes,
            cfg.stream.n_tasks, cfg.stream.n, cfg.stream.m,
            cfg.stream.seed, cfg.stream.rnd_NM)

        max_classes = cfg.max_classes or self.n_classes
        self.vocab = ClassVocabulary(self.train_dataset.class_names,
                                     max_classes=max_classes,
                                     template=cfg.text_template)
        self.memory = ReplayMemory(cfg.memory_size, seed=cfg.seed)
        self.metrics = OnlineMetrics(self.n_classes)

        self.clip_cfg = resolve_clip_preset(cfg.model_name)
        self._setup_run_logger()
        hist = stream_class_histogram(self.stream,
                                      self.train_dataset.targets)
        log.info("stream data config: %s",
                 [f"task{t}: {int((h > 0).sum())} classes / {int(h.sum())} "
                  f"samples" for t, h in enumerate(hist)])
        np.save(os.path.join(self.result_dir(), "train_data_config.npy"),
                hist)
        self.samples_seen = 0
        self._next_eval = cfg.eval_period
        self.eval_records = {"acc": [], "time": [], "step": []}
        self._start = time.time()
        self.setup_model()

    def _setup_run_logger(self):
        """Per-run ``log.txt`` on the package logger (reference
        ``_trainer.py:486-503``); ``run()`` detaches it at the end."""
        pkg = logging.getLogger("lifelong_clip_tpu_torch")
        self._teardown_run_logger()
        fh = logging.FileHandler(os.path.join(self.result_dir(), "log.txt"))
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        fh.setLevel(logging.INFO)
        fh._llc_run_log = True
        fh._llc_prev_level = None
        if pkg.getEffectiveLevel() > logging.INFO:
            fh._llc_prev_level = pkg.level
            pkg.setLevel(logging.INFO)
        pkg.addHandler(fh)

    @staticmethod
    def _teardown_run_logger():
        pkg = logging.getLogger("lifelong_clip_tpu_torch")
        for h in list(pkg.handlers):
            if getattr(h, "_llc_run_log", False):
                pkg.removeHandler(h)
                if getattr(h, "_llc_prev_level", None) is not None:
                    pkg.setLevel(h._llc_prev_level)
                h.close()

    # -- to be provided by method subclasses ---------------------------------
    def setup_model(self):
        raise NotImplementedError

    def online_step(self, images: np.ndarray, labels: np.ndarray,
                    indices: np.ndarray):
        raise NotImplementedError

    def online_before_task(self, task_id: int):
        pass

    def online_after_task(self, task_id: int):
        pass

    # -- main loop ------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        from ..utils.observability import StepTimer, profile_trace
        self.step_timer = StepTimer()
        profile_dir = os.path.join(self.result_dir(), "profile")
        with profile_trace(profile_dir, enabled=cfg.profile):
            for task_id in range(self.stream.n_tasks):
                log.info("### task %d / %d ###", task_id + 1,
                         self.stream.n_tasks)
                self.online_before_task(task_id)
                task_indices = self.stream.task_indices[task_id]
                if cfg.debug:
                    task_indices = task_indices[:500]
                for _ in range(max(int(cfg.epoch_num), 1)):
                    for batch_idx in iter_batches(task_indices,
                                                  cfg.batchsize):
                        images, labels = self.train_dataset.gather(batch_idx)
                        self.vocab.expose(labels)
                        with self.step_timer.tick():
                            stats = self.online_step(images, labels,
                                                     batch_idx)
                        self.samples_seen += len(batch_idx)
                        if stats:
                            self._report_train(stats)
                        if self.samples_seen >= self._next_eval:
                            self._periodic_eval()
                            self._next_eval += cfg.eval_period
                self.online_after_task(task_id)
                self._task_end_eval(task_id)
        try:
            return self.save_result()
        finally:
            self._teardown_run_logger()

    # -- evaluation -----------------------------------------------------------
    def evaluate(self):
        """Full eval over test samples of exposed classes; returns
        (correct, total) per-class arrays (global class ids)."""
        idx = exposed_test_indices(self.test_dataset.targets,
                                   self.vocab.exposed)
        correct = np.zeros((self.n_classes,), np.int64)
        total = np.zeros((self.n_classes,), np.int64)
        if len(idx) == 0:
            return correct, total
        bs = self.cfg.test_batchsize
        self.prepare_eval()
        all_labels, all_preds = [], []
        exposed = np.asarray(self.vocab.exposed)
        # predictions come back to the host in groups of GROUP_N batches:
        # one device->host copy per group, and the device keeps working on
        # the next group meanwhile (``base.py:237-284``)
        GROUP_N = 8

        def consume(group):
            rows = torch.stack([p for p, _, _ in group]).cpu().numpy()
            for (_, labels, n), row in zip(group, rows):
                preds = exposed[np.clip(row[:n], 0, len(exposed) - 1)]
                c, t = per_class_counts(preds, labels, self.n_classes)
                correct[:] += c
                total[:] += t
                all_labels.append(labels)
                all_preds.append(preds)

        groups, cur = [], []
        for lo in range(0, len(idx), bs):
            chunk = idx[lo:lo + bs]
            images, labels = self.test_dataset.gather(chunk)
            n = len(chunk)
            if n < bs:   # tile the tail up to the fixed batch shape
                reps = -(-bs // n)
                images = np.concatenate([images] * reps, axis=0)[:bs]
            cur.append((self.predict(images), labels, n))
            if len(cur) == GROUP_N:
                groups.append(cur)
                cur = []
                if len(groups) == 2:
                    consume(groups.pop(0))
        for g in groups:
            consume(g)
        if cur:
            consume(cur)
        self._last_confusion = confusion_matrix(
            np.concatenate(all_labels), np.concatenate(all_preds))
        return correct, total

    def prepare_eval(self):
        """Hook: refresh cached text features etc. before an eval sweep."""

    def predict(self, images: np.ndarray) -> torch.Tensor:
        raise NotImplementedError

    def _periodic_eval(self):
        correct, total = self.evaluate()
        acc = self.metrics.record_eval(self.samples_seen, correct, total)
        self.eval_records["acc"].append(acc)
        self.eval_records["time"].append(self.samples_seen)
        self.eval_records["step"].append(self.samples_seen)
        log.info("eval @ %d samples | acc %.4f | classes %d",
                 self.samples_seen, acc, len(self.vocab))

    def _task_end_eval(self, task_id: int):
        correct, total = self.evaluate()
        acc = self.metrics.record_task_end(correct, total)
        t = self.step_timer.summary()
        log.info("task %d done | acc %.4f | elapsed %.1fs | "
                 "step p50 %.1fms p99 %.1fms", task_id + 1, acc,
                 time.time() - self._start, t.get("p50_ms", 0.0),
                 t.get("p99_ms", 0.0))

    def _report_train(self, stats):
        if self.samples_seen % (self.cfg.batchsize * 20) == 0:
            log.info("train | samples %d | loss %.4f | acc %.4f | "
                     "classes %d", self.samples_seen,
                     float(stats.get("loss", 0.0)),
                     float(stats.get("acc", 0.0)), len(self.vocab))

    # -- artifacts (schema-compatible with reference _trainer.py:359-401) ----
    def result_dir(self) -> str:
        cfg = self.cfg
        s = cfg.stream
        d = os.path.join(cfg.log_path, cfg.dataset,
                         f"TASK{s.n_tasks}N{s.n}M{s.m}",
                         cfg.note or cfg.method)
        os.makedirs(d, exist_ok=True)
        return d

    def save_result(self):
        """seed_k*.npy accuracy curves, the last eval's confusion matrix,
        result.txt in the reference's text format, and result.jsonl."""
        out = self.metrics.summary()
        d = self.result_dir()
        seed = self.cfg.seed
        np.save(os.path.join(d, f"seed_{seed}.npy"),
                np.asarray(self.metrics.task_acc))
        np.save(os.path.join(d, f"seed_{seed}_eval.npy"),
                np.asarray(self.eval_records["acc"]))
        np.save(os.path.join(d, f"seed_{seed}_eval_time.npy"),
                np.asarray(self.eval_records["time"]))
        cm = getattr(self, "_last_confusion", None)
        if cm is not None:
            np.save(os.path.join(d, f"seed_{seed}_confusion_matrix.npy"), cm)
        task_acc = [float(a) for a in self.metrics.task_acc]
        cls_acc = [[float(x) for x in a] for a in self.metrics.task_cls_acc]
        with open(os.path.join(d, "result.txt"), "w") as f:
            f.write(f"Dataset:{self.cfg.dataset} | A_auc {out['A_auc']:.5f}"
                    f" | A_avg {out['A_avg']:.5f}"
                    f" | A_last {out['A_last']:.5f}"
                    f" | F_last {out['F_last']:.5f}\n")
            f.write(f"task_acc:{task_acc}\n")
            f.write(f"per_task_acc:{cls_acc}")
        with open(os.path.join(d, "result.jsonl"), "a") as f:
            f.write(json.dumps({"seed": seed, **out}) + "\n")
        log.info("result: %s", out)
        return out

    # -- misc helpers ----------------------------------------------------------
    def next_gen(self) -> torch.Generator:
        """A fresh generator seeded from the trainer's (``next_rng``)."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.gen))
        return torch.Generator().manual_seed(seed)


def pad_batch(images, labels, batch_size: int):
    """Pad a short tail batch to the static step shape; returns valid count."""
    n = len(labels)
    if n == batch_size:
        return images, labels, n
    reps = -(-batch_size // n)
    images = np.concatenate([images] * reps, axis=0)[:batch_size]
    labels = np.concatenate([labels] * reps, axis=0)[:batch_size]
    return images, labels, n
