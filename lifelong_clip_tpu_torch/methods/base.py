"""Host-side orchestration of the online CL lifecycle.

Counterpart of ``lifelong_clip_tpu/methods/base.py:OnlineTrainer`` (the
reference's ``_Trainer``, ``methods/_trainer.py:249-653``): seeding, stream
and dataset setup, the task x batch loop, periodic online evaluation and the
result artifacts in the reference's format, the batch prefetcher
(``data/prefetch.py``) and checkpoint/resume at task boundaries
(``utils/checkpoints.py``), and the device mesh (JAX ``:67-68``,
``:370-517``): under ``--mesh DxM`` every rank runs this host program, the
step's rows split over the data axis (``resolve_dp_mesh``,
``parallel/mesh.py``), eval's rows too with the predictions all-gathered,
and rank 0 alone writes the run's files.
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
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, gather_rows, make_mesh,
                             shard_params)
from ..utils.class_vocab import ClassVocabulary
from ..utils.memory import ReplayMemory
from ..utils.metrics import OnlineMetrics, confusion_matrix, per_class_counts
from ..utils.stream import (exposed_test_indices, iter_batches,
                            si_blurry_stream, stream_class_histogram)

log = logging.getLogger("lifelong_clip_tpu_torch")


class OnlineTrainer:
    """Base online continual-learning trainer.

    ``_dp_mesh`` / ``_eval_dp_mesh``: the data-parallel mesh of the train
    step and of eval (``resolve_dp_mesh``; the trainers set them, as
    JAX's), None for the whole batch on every rank."""

    _dp_mesh = None
    _eval_dp_mesh = None

    def __init__(self, cfg: TrainConfig,
                 train_dataset: Optional[ArrayDataset] = None,
                 test_dataset: Optional[ArrayDataset] = None,
                 synthetic_fallback: bool = False):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.mesh = make_mesh(tuple(cfg.mesh_shape), self.device) \
            if np.prod(cfg.mesh_shape) > 1 else None
        self.is_main = self.mesh is None or self.mesh.is_main
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
        if self.is_main:
            np.save(os.path.join(self.result_dir(), "train_data_config.npy"),
                    hist)
        self.samples_seen = 0
        self._next_eval = cfg.eval_period
        self.eval_records = {"acc": [], "time": [], "step": []}
        self._start = time.time()
        self.setup_model()

    def _setup_run_logger(self):
        """Per-run ``log.txt`` on the package logger (reference
        ``_trainer.py:486-503``), rank 0's alone; ``run()`` detaches it at
        the end."""
        pkg = logging.getLogger("lifelong_clip_tpu_torch")
        self._teardown_run_logger()
        if not self.is_main:
            return
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
    def run(self, resume_from: Optional[str] = None):
        """The task x batch loop; ``resume_from`` restores a checkpoint
        first and starts at its cursor."""
        cfg = self.cfg
        from ..data.prefetch import BatchPrefetcher
        from ..utils.observability import StepTimer, profile_trace
        self.step_timer = StepTimer()

        start_task = 0
        if resume_from:
            from ..utils.checkpoints import restore_trainer
            cursor = restore_trainer(self, resume_from)
            start_task = cursor.get("task_id", 0)
            self.samples_seen = cursor.get("samples_seen", 0)
            self._next_eval = cursor.get("next_eval", cfg.eval_period)
            log.info("resumed from %s at task %d", resume_from, start_task)

        profile_dir = os.path.join(self.result_dir(), "profile")
        with profile_trace(profile_dir, enabled=cfg.profile):
            for task_id in range(start_task, self.stream.n_tasks):
                log.info("### task %d / %d ###", task_id + 1,
                         self.stream.n_tasks)
                self.online_before_task(task_id)
                task_indices = self.stream.task_indices[task_id]
                if cfg.debug:
                    task_indices = task_indices[:500]
                for _ in range(max(int(cfg.epoch_num), 1)):
                    # the gather (and upload) of the next batches overlap
                    # this batch's step
                    pf = BatchPrefetcher(iter_batches(task_indices,
                                                      cfg.batchsize),
                                         self.train_dataset.gather,
                                         place=self._prefetch_place(),
                                         depth=2)
                    for batch_idx, images, labels in pf:
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
                self._maybe_checkpoint(task_id)
        try:
            return self.save_result()
        finally:
            self._teardown_run_logger()

    def _prefetch_place(self):
        """Where the prefetcher puts a batch's images (JAX
        ``base.py:412-434``): on the card through pinned memory and a side
        stream, except with replay memory (``memory_size > 0``), whose
        concat assembles the step's batch on the host, and on the CPU.
        Under a data-parallel mesh the whole batch goes up and the step
        takes a view of this rank's rows (``local_rows``)."""
        if self.cfg.memory_size > 0 or self.device.type != "cuda":
            return None
        if getattr(self, "_upload", None) is None:
            from ..data.prefetch import DeviceUpload
            self._upload = DeviceUpload(self.device)
        return self._upload

    def resolve_dp_mesh(self, *batch_sizes, allow_model_axis=False):
        """The data-parallel mesh of a step whose batches have these sizes
        (JAX ``resolve_dp_mesh``, the one multi-device road every method
        family shares): each rank runs the step on its rows and the grads
        are averaged over the data group (``TrainState.apply``).

        A model axis raises unless the trainer splits its towers over it
        (``allow_model_axis``: the adapter family and continual-clip); a
        batch size that does not divide the data axis warns once and gives
        None, the whole batch on every rank; a mesh with no data axis gives
        None."""
        mesh = self.mesh
        if mesh is None:
            return None
        if mesh.shape[MODEL_AXIS] > 1 and not allow_model_axis:
            raise ValueError(
                f"method {self.cfg.method!r} supports pure data-parallel "
                f"meshes only (--mesh Nx1); got a model axis of "
                f"{mesh.shape[MODEL_AXIS]}")
        n = mesh.shape[DATA_AXIS]
        if n == 1:
            return None
        bad = sorted({int(b) for b in batch_sizes if b % n != 0})
        if bad:
            if not getattr(self, "_warned_mesh_skip", False):
                log.warning(
                    "batch size(s) %s do not divide the %d-way data axis; "
                    "method %r runs the whole batch on every rank (pick "
                    "sizes divisible by the data axis)", bad, n,
                    self.cfg.method)
                self._warned_mesh_skip = True
            return None
        return mesh

    def place_state(self, frozen):
        """The frozen towers as this rank holds them (JAX
        ``_MeshMixin.place_state``): under a model axis their block leaves
        cut to the rank's heads and hidden units
        (``parallel/mesh.py:shard_params``), else as they are. Trainable
        leaves stay whole on every rank, MoE experts included: each rank
        computes its share of the experts (``ops/moe.py``), so the
        optimizer, the data-parallel reduce and the checkpoint see one
        layout whatever the mesh."""
        if self.mesh is None or self.mesh.shape[MODEL_AXIS] == 1:
            return frozen
        return shard_params(frozen, self.mesh)

    def _maybe_checkpoint(self, task_id: int):
        """Checkpoint after a task to ``--ckpt_dir`` (or ``LLC_CKPT_DIR``),
        with the cursor at the next task's first batch."""
        ckpt_dir = self.cfg.ckpt_dir or os.environ.get("LLC_CKPT_DIR", "")
        if not ckpt_dir:
            return
        from ..utils.checkpoints import save_checkpoint
        save_checkpoint(
            ckpt_dir, mesh=self.mesh, state=getattr(self, "state", None),
            memory=self.memory, vocab=self.vocab, metrics=self.metrics,
            cursor={"task_id": task_id + 1,
                    "samples_seen": self.samples_seen,
                    "next_eval": self._next_eval},
            extra=self.checkpoint_extra())
        log.info("checkpoint saved to %s (post-task %d)", ckpt_dir,
                 task_id + 1)

    def checkpoint_extra(self):
        """Hook: method state kept outside ``self.state`` to save with it
        (tensors, arrays and plain Python values)."""
        return {}

    def restore_extra(self, extra):
        """Hook: restore what ``checkpoint_extra`` saved."""

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
        dp = self._eval_dp_mesh
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
            if dp is None:
                preds = self.predict(images)
            else:   # this rank's rows; every rank keeps all predictions
                preds = gather_rows(self.predict(dp.local(images)), dp)
            cur.append((preds, labels, n))
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
        timer = getattr(self, "step_timer", None)   # set by run()
        t = timer.summary() if timer else {}
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
        result.txt in the reference's text format, and result.jsonl, from
        rank 0 alone; every rank returns the summary."""
        out = self.metrics.summary()
        if not self.is_main:
            return out
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
    def _tensor(self, a, dtype=None):
        """``a`` (a host array, or a tensor the prefetcher already put on
        the device) as a tensor on the trainer's device. The copy from
        pageable host memory is staged before this returns and does not
        wait for the device's queue, so the host keeps ahead of the
        device."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(self.device, dtype, non_blocking=True)

    def next_gen(self) -> torch.Generator:
        """A fresh generator seeded from the trainer's (``next_rng``)."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.gen))
        return torch.Generator().manual_seed(seed)


def pad_batch(images, labels, batch_size: int):
    """Pad a short tail batch to the static step shape; returns valid count.
    ``images`` may be a host array or a tensor already on the device (the
    prefetcher's upload), which is then padded there."""
    n = len(labels)
    if n == batch_size:
        return images, labels, n
    reps = -(-batch_size // n)
    cat = torch.cat if isinstance(images, torch.Tensor) else np.concatenate
    images = cat([images] * reps, 0)[:batch_size]
    labels = np.concatenate([labels] * reps, axis=0)[:batch_size]
    return images, labels, n
