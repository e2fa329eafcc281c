"""Rainbow Memory (``rm``): class-balanced memory and post-task training.

Counterpart of ``lifelong_clip_tpu/methods/rainbow_memory.py`` (reference
``methods/rainbow_memory.py``): each stream batch trains ``online_iter *
temp_batchsize`` iterations; every stream sample goes through the memory's
class-balanced random replacement; after each task ``memory_epoch`` epochs
walk the memory in slot order (the tail batch unpadded, as the reference's
DataLoader runs it) under the warm-start schedule of ``memory_epoch_lr``,
and the next task starts at the base learning rate again. The optimizer is
the script's at a constant schedule, its learning rate set in place
(``ER._set_lr``), so Adam's moments persist. ``--rm_uncertainty`` rebuilds
the memory at a task's end from the 12-view Monte-Carlo vote-ratio
uncertainty, an even spread over each class's ranking.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import preprocess
from ..utils.train_utils import make_optimizer
from .base import pad_batch
from .er_baseline import ER

# the reference's vr_randaug mode votes over 12 views
# (montecarlo(), rainbow_memory.py:263-265)
MC_VIEWS = 12


def vote_ratio_uncertainty(view_preds, n_classes: int):
    """1 - (the most votes a class gets) / (views) a sample (reference
    ``variance_ratio``, rainbow_memory.py:279-285). ``view_preds``: (V, B)
    integer classes a view. Returns (B,) fp32."""
    votes = torch.nn.functional.one_hot(view_preds, n_classes).sum(0)
    return 1.0 - votes.max(-1).values.float() / view_preds.shape[0]


class RM(ER):

    def make_opt(self, leaves):
        # the reference pins the schedule constant for RM
        # (rainbow_memory.py:28); the memory epochs set the lr in place
        return make_optimizer(self.cfg.opt_name, leaves, self.cfg.lr,
                              sched_name="const")

    @staticmethod
    def memory_epoch_lr(epoch: int, base_lr: float,
                        dataset: str = "") -> float:
        """The memory epochs' learning rate (reference
        online_memory_train():126-151): epoch 0 0.1 x base (the warm start),
        epoch 1 base; from epoch 2 on the per-task scheduler has taken
        e - 1 steps: MultiStepLR(milestones=[30, 60, 80, 90], gamma=0.1)
        for ``imagenet``, else CosineAnnealingWarmRestarts(T_0=1, T_mult=2,
        eta_min=0.01 x base), replayed."""
        if epoch <= 0:
            return base_lr * 0.1
        if epoch == 1:
            return base_lr
        if dataset == "imagenet":
            decays = sum(1 for m in (30, 60, 80, 90) if m <= epoch - 1)
            return base_lr * (0.1 ** decays)
        eta_min = base_lr * 0.01
        # torch's CAWR: T_i starts at 1 and doubles at each restart
        t_cur, t_i = 0, 1
        for _ in range(epoch - 1):
            t_cur += 1
            if t_cur >= t_i:
                t_cur -= t_i
                t_i *= 2
        return eta_min + (base_lr - eta_min) * (
            1 + float(np.cos(np.pi * t_cur / t_i))) / 2

    def setup_model(self):
        super().setup_model()
        self._task_seen: list = []
        # the Monte-Carlo views: the train pipeline without AutoAugment, its
        # draws from a generator of their own that the checkpoint keeps
        self._mc_pipeline = preprocess.make_train_pipeline(
            self.clip_cfg.image_size, self.train_dataset.mean,
            self.train_dataset.std, out_dtype=self.compute_dtype)
        self._mc_gen = self.next_gen()

    def _iters_per_batch(self) -> int:
        """``int(online_iter) * temp_batchsize`` iterations a stream batch
        (reference online_step():47); temp_batchsize 0 counts as 1."""
        cfg = self.cfg
        return max(int(cfg.online_iter), 1) * max(int(cfg.temp_batchsize),
                                                  1)

    def online_step(self, images, labels, indices):
        batch = self.stream_batch(images, labels, dp=self._dp_mesh)
        stats = {}
        for _ in range(self._iters_per_batch()):
            stats = self._train_step(self.state, batch)
        # the candidate pool of the optional boundary rebuild
        self._task_seen.extend(int(i) for i in indices)
        if self.cfg.memory_size > 0:
            for i, lab in zip(indices, labels):
                self.memory.balanced_random_update(
                    int(i), int(lab), class_order=self.vocab.exposed)
        return stats

    # -- task boundary -----------------------------------------------------
    def online_before_task(self, task_id):
        super().online_before_task(task_id)
        # the reference installs a fresh constant LambdaLR here
        # (online_before_task():112): back to the base lr
        self._set_lr(self.cfg.lr)

    def online_after_task(self, task_id):
        cfg = self.cfg
        if cfg.memory_size > 0:
            if cfg.rm_uncertainty:
                self._rebuild_memory_by_uncertainty()
            if cfg.memory_epoch > 0:
                self._memory_train_epochs()
        self._task_seen = []

    # -- the rebuild's candidate pool and view generator live outside the
    # train state (the lr rides in the optimizer's state, the eviction
    # draws in the memory's). JAX draws the views from the trainer's key,
    # which its checkpoint does not keep
    def checkpoint_extra(self):
        return {"rm": {"task_seen": list(self._task_seen),
                       "mc_gen": self._mc_gen.get_state()}}

    def restore_extra(self, extra):
        st = (extra or {}).get("rm")
        if st:
            self._task_seen = list(st["task_seen"])
            self._mc_gen.set_state(st["mc_gen"])

    @torch.no_grad()
    def mc_uncertainty(self, images_u8, mask, gen):
        """Vote-ratio uncertainty of a batch over ``MC_VIEWS`` views of the
        train pipeline (no AutoAugment) drawn from ``gen`` (reference
        montecarlo + variance_ratio, rainbow_memory.py:244-285)."""
        preds = []
        for _ in range(MC_VIEWS):
            x = self._mc_pipeline(gen, images_u8)
            logits, _, _ = self._fwd(self.state.frozen, self.state.trainable,
                                     x, None)
            preds.append((logits + mask[None, :]).argmax(-1))
        return vote_ratio_uncertainty(torch.stack(preds), mask.shape[0])

    def _uncertainties(self, indices: np.ndarray) -> np.ndarray:
        bs = self.cfg.batchsize
        mask = self._tensor(self.vocab.logit_mask(), torch.float32)
        out = np.zeros((len(indices),), np.float64)
        for lo in range(0, len(indices), bs):
            chunk = indices[lo:lo + bs]
            imgs, labs = self.train_dataset.gather(chunk)
            imgs, labs, valid = pad_batch(imgs, labs, bs)
            u = self.mc_uncertainty(self._tensor(imgs), mask, self._mc_gen)
            out[lo:lo + valid] = u.cpu().numpy()[:valid]
        return out

    def _rebuild_memory_by_uncertainty(self):
        """Even-rank uncertainty sampling a class over memory + the task's
        samples (reference uncertainty_sampling, rainbow_memory.py:177-218)."""
        pool = np.unique(np.concatenate([
            self.memory.ordered_indices(),
            np.asarray(self._task_seen, np.int64)])) \
            if self._task_seen else self.memory.ordered_indices()
        if len(pool) == 0:
            return
        labels = self.train_dataset.targets[pool]
        classes = np.unique(labels)
        budget = max(self.memory.memory_size // max(len(classes), 1), 1)
        unc = self._uncertainties(pool)

        keep_idx, keep_lab = [], []
        for c in classes:
            sel = np.nonzero(labels == c)[0]
            ranked = sel[np.argsort(unc[sel])]
            take = min(budget, len(ranked))
            # an even spread over the uncertainty ranking (diversity)
            picks = ranked[np.linspace(0, len(ranked) - 1, take)
                           .astype(int)]
            keep_idx.extend(int(pool[p]) for p in picks)
            keep_lab.extend([int(c)] * take)
        keep_idx = keep_idx[:self.memory.memory_size]
        keep_lab = keep_lab[:self.memory.memory_size]
        self.memory.indices = keep_idx
        self.memory.labels = keep_lab
        self.memory.loss_history = [0.0] * len(keep_idx)
        self.memory.usage_count = [0] * len(keep_idx)

    def _memory_train_epochs(self):
        """Post-task memory training (reference online_memory_train,
        rainbow_memory.py:126-175): each epoch walks the memory in slot
        order ``len(memory) // batchsize`` times over, at
        ``memory_epoch_lr``; the tail batch runs unpadded, as the
        reference's DataLoader runs its short last batch (tiling would
        weigh the leading rows more), except on the data-parallel road,
        which needs whole batches: there it pads by tiling, as JAX's.
        Fewer samples than a batch: no epochs (the reference's iteration
        count is 0)."""
        cfg = self.cfg
        n = len(self.memory)
        iters = n // cfg.batchsize
        if n == 0 or iters == 0:
            return
        mask = self._tensor(self.vocab.logit_mask(), torch.float32)
        for epoch in range(int(cfg.memory_epoch)):
            self._set_lr(self.memory_epoch_lr(epoch, cfg.lr, cfg.dataset))
            mem = np.concatenate([self.memory.ordered_indices()] * iters)
            for lo in range(0, len(mem), cfg.batchsize):
                imgs, labs = self.train_dataset.gather(
                    mem[lo:lo + cfg.batchsize])
                dp = self._dp_mesh
                if dp is not None:
                    # the data-parallel road needs whole batches: the tail
                    # pads by tiling there (JAX ``:241-265``)
                    imgs, labs, _ = pad_batch(imgs, labs, cfg.batchsize)
                    imgs, labs = dp.local(imgs), dp.local(labs)
                self._train_step(self.state, self._batch(imgs, labs, mask))
