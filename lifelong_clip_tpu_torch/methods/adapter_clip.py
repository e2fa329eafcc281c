"""Online PEFT of CLIP: ``lora-clip``, ``adapter-clip``, ``moe-clip``.

Counterpart of ``lifelong_clip_tpu/methods/adapter_clip.py:AdapterCLIP``
(reference ``methods/adapter_clip.py``) for LoRA, bottleneck adapters or a
noisy-top-k mixture of adapters (MoE) on either tower or both
(``--peft_encoder``): per-step class tables, AutoAugment with the
dataset's policy, class-text features cached while the text tower is frozen
and recomputed in every step where it trains, the replay concat, optimizer
reset at task boundaries, and eval against the exposed classes. The MoE
step's gate noise comes from the train state's generator, which the
checkpoint keeps, so a resumed run draws what the uninterrupted one draws.

Meshes follow JAX's routing (``:60-85``, ``:209-219``): a pure
data-parallel mesh runs the fused kernels on each rank's rows; a model axis
runs train, text and eval passes on the ``"unfused"`` road with the frozen
towers split over the model group by heads and hidden units and, for
moe-clip, the experts split too (``parallel/mesh.py``). The kernels take
whole heads, as GSPMD cannot split JAX's opaque kernel calls: the road is
the design of a model axis, not a fallback.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..models import build_clip, build_peft
from ..models.clip import cast_towers
from ..models.init import param_count
from ..parallel.mesh import MODEL_AXIS, local_rows, model_parallel
from ..utils.train_utils import make_optimizer
from .base import OnlineTrainer, pad_batch
from .engine import (TrainState, ce_on_probs_loss, make_eval_step,
                     make_text_feature_fn, make_train_step, remat_fallback)

log = logging.getLogger("lifelong_clip_tpu_torch")


# method name -> the PEFT tree it trains (JAX adapter_clip.py:42-44)
PEFT_METHODS = {"lora-clip": "lora", "adapter-clip": "adapter",
                "moe-clip": "moe"}


class AdapterCLIP(OnlineTrainer):
    """Trainer for lora-clip, adapter-clip and moe-clip. ``_attn_impl``:
    the towers' road (``models/clip.py``), ``"unfused"`` under a model
    axis."""

    _attn_impl = "fused"

    def setup_model(self):
        cfg = self.cfg
        dev = self.device
        self.params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=dev)
        self.peft_cfg = dataclasses.replace(
            cfg.peft, method=PEFT_METHODS.get(cfg.method, cfg.peft.method))
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

        step_bs = cfg.batchsize + max(cfg.temp_batchsize, 0)
        self._dp_mesh = self.resolve_dp_mesh(step_bs, allow_model_axis=True)
        self._eval_dp_mesh = self.resolve_dp_mesh(cfg.test_batchsize,
                                                  allow_model_axis=True)
        tp = self.mesh is not None and self.mesh.shape[MODEL_AXIS] > 1
        if tp:
            self._attn_impl = "unfused"
        # the towers are frozen: cast them to the compute dtype once (and
        # under a model axis keep this rank's heads of them)
        frozen = self.place_state(cast_towers(self.params,
                                              self.compute_dtype))
        self.state = TrainState(trainable=self.peft, frozen=frozen,
                                make_opt=make_opt, gen=self.next_gen())
        log.info("backbone params: %d | trainable PEFT params: %d",
                 param_count(self.params), param_count(self.peft))

        use_autoaug = "autoaug" in cfg.transforms
        # image-only PEFT: a class set's text features are constant, so
        # they are cached outside the step; with LoRA on the text tower the
        # step runs both towers forward and backward
        self._use_text_cache = not self.peft_cfg.on_text()
        self._step_txt_cache = {}
        # remat (JAX adapter_clip.py:95-115): --remat, batches of 256 and
        # up, or remat_fallback's retry (fb) after the card runs out of
        # memory
        self._train_step = remat_fallback(lambda fb: make_train_step(
            self.clip_cfg, self.peft_cfg, image_size=self.clip_cfg.image_size,
            mean=self.train_dataset.mean, std=self.train_dataset.std,
            use_autoaug=use_autoaug,
            autoaug_policy=("cifar10" if "cifar" in cfg.dataset else
                            "svhn" if "svhn" in cfg.dataset else "imagenet"),
            cached_text=self._use_text_cache,
            compute_dtype=self.compute_dtype,
            loss_fn=ce_on_probs_loss if cfg.ce_on_probs else None,
            attn_impl=self._attn_impl, dp=self._dp_mesh,
            remat=cfg.remat or cfg.batchsize >= 256 or fb))
        self._text_fn = make_text_feature_fn(
            self.clip_cfg, self.peft_cfg, compute_dtype=self.compute_dtype,
            attn_impl=self._attn_impl)
        self._eval_fn = make_eval_step(
            self.clip_cfg, self.peft_cfg, image_size=self.clip_cfg.image_size,
            mean=self.train_dataset.mean, std=self.train_dataset.std,
            compute_dtype=self.compute_dtype, attn_impl=self._attn_impl)
        self._txt_cache_key = None

    def _estimate_steps(self) -> int:
        n = len(self.train_dataset)
        return max(int(n / max(self.cfg.batchsize, 1)
                       * max(self.cfg.online_iter, 1)), 1)

    # -- hot loop --------------------------------------------------------------
    def online_step(self, images, labels, indices):
        cfg = self.cfg
        if cfg.memory_size > 0 and len(self.memory) > 0 \
                and cfg.temp_batchsize > 0:
            # the prefetcher leaves images on the host when memory is on;
            # a caller's device tensor is concatenated on the device
            mem_idx = self.memory.sample(cfg.temp_batchsize)
            m_images, m_labels = self.train_dataset.gather(mem_idx)
            images = (torch.cat([images, self._tensor(m_images)])
                      if isinstance(images, torch.Tensor)
                      else np.concatenate([images, m_images], axis=0))
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

        if self._use_text_cache:
            key = tuple(int(s) for s in slots)
            feats = self._step_txt_cache.get(key)
            if feats is None:
                with model_parallel(self.mesh):
                    feats = self._text_fn(self.state.frozen,
                                          self.state.trainable,
                                          self._tensor(tokens))
                if len(self._step_txt_cache) > 512:
                    self._step_txt_cache.clear()
                self._step_txt_cache[key] = feats
            tokens_or_feats = feats
        else:
            tokens_or_feats = self._tensor(tokens, torch.int64)

        dp = self._dp_mesh
        batch = {"images": self._tensor(local_rows(images, dp)),
                 "labels": self._tensor(local_rows(y, dp), torch.int64),
                 "tokens": tokens_or_feats,
                 "mask": self._tensor(mask, torch.float32)}
        stats = {}
        with model_parallel(self.mesh):
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
            with model_parallel(self.mesh):
                self._txt_cache = self._text_fn(
                    self.state.frozen, self.state.trainable,
                    self._tensor(self.vocab.token_table))
            self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)
            self._txt_cache_key = key

    def predict(self, images):
        with model_parallel(self.mesh):
            preds, _ = self._eval_fn(self.state.frozen, self.state.trainable,
                                     self._tensor(images), self._txt_cache,
                                     self._mask)
        return preds
