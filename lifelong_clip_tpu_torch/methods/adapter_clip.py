"""Online LoRA training of CLIP (``lora-clip``).

Counterpart of ``lifelong_clip_tpu/methods/adapter_clip.py:AdapterCLIP``
(reference ``methods/adapter_clip.py``) for the LoRA method on the image
tower: per-step class tables, cached class-text features, the replay concat,
optimizer reset at task boundaries, and eval against the exposed classes.
Adapter and MoE PEFT are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..models import build_clip, build_peft
from ..models.clip import cast_towers
from ..models.init import param_count
from ..utils.train_utils import make_optimizer
from .base import OnlineTrainer, pad_batch
from .engine import (TrainState, ce_on_probs_loss, make_eval_step,
                     make_text_feature_fn, make_train_step)

log = logging.getLogger("lifelong_clip_tpu_torch")


class AdapterCLIP(OnlineTrainer):
    """Trainer for lora-clip."""

    def setup_model(self):
        cfg = self.cfg
        dev = self.device
        self.params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=dev)
        self.peft_cfg = dataclasses.replace(cfg.peft, method="lora")
        self.peft = build_peft(self.next_gen(), self.clip_cfg, self.peft_cfg,
                               device=dev)
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        self.step_capacity = min(self.vocab.max_classes,
                                 cfg.batchsize + max(cfg.temp_batchsize, 0))

        total = self._estimate_steps()

        def make_opt(leaves):
            return make_optimizer(cfg.opt_name, leaves, cfg.lr,
                                  sched_name=cfg.sched_name,
                                  total_steps=total)

        # the towers are frozen: cast them to the compute dtype once
        frozen = cast_towers(self.params, self.compute_dtype)
        self.state = TrainState(trainable=self.peft, frozen=frozen,
                                make_opt=make_opt, gen=self.next_gen())
        log.info("backbone params: %d | trainable PEFT params: %d",
                 param_count(self.params), param_count(self.peft))

        use_autoaug = "autoaug" in cfg.transforms
        self._use_text_cache = not self.peft_cfg.on_text()
        if not self._use_text_cache:
            raise NotImplementedError(
                "LoRA on the text tower (uncached text features) is not "
                "ported yet (ROADMAP.md, queue A)")
        self._step_txt_cache = {}
        self._train_step = make_train_step(
            self.clip_cfg, self.peft_cfg, image_size=self.clip_cfg.image_size,
            mean=self.train_dataset.mean, std=self.train_dataset.std,
            use_autoaug=use_autoaug, compute_dtype=self.compute_dtype,
            loss_fn=ce_on_probs_loss if cfg.ce_on_probs else None)
        self._text_fn = make_text_feature_fn(
            self.clip_cfg, self.peft_cfg, compute_dtype=self.compute_dtype)
        self._eval_fn = make_eval_step(
            self.clip_cfg, self.peft_cfg, image_size=self.clip_cfg.image_size,
            mean=self.train_dataset.mean, std=self.train_dataset.std,
            compute_dtype=self.compute_dtype)
        self._txt_cache_key = None

    def _estimate_steps(self) -> int:
        n = len(self.train_dataset)
        return max(int(n / max(self.cfg.batchsize, 1)
                       * max(self.cfg.online_iter, 1)), 1)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # -- hot loop --------------------------------------------------------------
    def online_step(self, images, labels, indices):
        cfg = self.cfg
        if cfg.memory_size > 0 and len(self.memory) > 0 \
                and cfg.temp_batchsize > 0:
            mem_idx = self.memory.sample(cfg.temp_batchsize)
            m_images, m_labels = self.train_dataset.gather(mem_idx)
            images = np.concatenate([images, m_images], axis=0)
            labels = np.concatenate([labels, m_labels], axis=0)

        step_bs = cfg.batchsize + max(cfg.temp_batchsize, 0)
        images, labels, _ = pad_batch(images, labels, step_bs)

        if cfg.visible_classes == "batch":
            tokens, mask, y, slots = self.vocab.batch_table(
                labels, self.step_capacity)
        else:
            tokens = self.vocab.token_table
            mask = self.vocab.logit_mask()
            y = self.vocab.remap(labels)
            slots = np.where(self.vocab.exposed_mask,
                             np.arange(self.vocab.max_classes), -1)

        key = tuple(int(s) for s in slots)
        feats = self._step_txt_cache.get(key)
        if feats is None:
            feats = self._text_fn(self.state.frozen, self.state.trainable,
                                  self._tensor(tokens))
            if len(self._step_txt_cache) > 512:
                self._step_txt_cache.clear()
            self._step_txt_cache[key] = feats

        batch = {"images": self._tensor(images),
                 "labels": self._tensor(y, torch.int64),
                 "tokens": feats,
                 "mask": self._tensor(mask, torch.float32)}
        stats = {}
        for _ in range(max(int(cfg.online_iter), 1)):
            stats = self._train_step(self.state, batch)

        if cfg.memory_size > 0:
            for i, lab in zip(indices, labels[:len(indices)]):
                self.memory.reservoir_update(int(i), int(lab))
        return stats

    def online_before_task(self, task_id):
        # the reference rebuilds the optimizer at every task boundary
        # (online_before_task -> reset_opt, methods/adapter_clip.py:127)
        if task_id > 0:
            self.state.reset_optimizer()

    # -- eval -------------------------------------------------------------------
    def prepare_eval(self):
        key = (len(self.vocab), self.state.step)
        if self._txt_cache_key != key:
            self._txt_cache = self._text_fn(
                self.state.frozen, self.state.trainable,
                self._tensor(self.vocab.token_table))
            self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)
            self._txt_cache_key = key

    def predict(self, images):
        preds, _ = self._eval_fn(self.state.frozen, self.state.trainable,
                                 self._tensor(images), self._txt_cache,
                                 self._mask)
        return preds
