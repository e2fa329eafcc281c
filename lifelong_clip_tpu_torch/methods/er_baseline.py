"""Experience replay (``er``) and naive finetuning (``Finetuning``).

Counterpart of ``lifelong_clip_tpu/methods/er_baseline.py`` (reference
``methods/er_baseline.py`` and ``methods/finetuning.py``): the classifier is
the CLIP vision tower and a linear head over ``max_classes`` logits, zeros
and fp32, whose logits are an fp32 product (TF32 stays off on the card, as
JAX computes them at ``Precision.HIGHEST``). ER trains the head on the
stream batch joined with reservoir-memory samples, with batch CutMix on
half of the steps under the default ``--transforms``; FT trains the whole
CLIP tree: its fp32 masters sit in the trainable tree and are cast to the
compute dtype inside the forward, so that their grads land on the fp32
leaves, and the vision blocks run the fused kernels' backward with the
weight grads (``base_grads=True``). The text tower gets no grad; it is in
the trainable tree all the same and AdamW decays it, as optax does
(``engine.fill_missing_grads``). The train step runs eagerly on the device
and updates the state in place. A data-parallel mesh runs the engine's
step on each rank's rows (JAX ``:107-123``; the stream batch and the
memory-epoch batch must both divide the data axis); the subclasses' own
steps (LwF's KD, EWC++, CLIB) run the whole batch on every rank, as JAX's
stay replicated.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from ..config import PEFTConfig
from ..models import build_clip
from ..models import clip as clip_fns
from ..models.clip import cast_towers
from ..models.init import param_count
from ..ops import preprocess
from ..parallel.mesh import local_rows
from ..utils.train_utils import make_optimizer, set_lr
from .base import OnlineTrainer, pad_batch
from .engine import TrainState, make_train_step, remat_fallback

log = logging.getLogger("lifelong_clip_tpu_torch")


def head_features(params, images, *, clip_cfg, compute_dtype,
                  base_grads=False, attn_impl="fused"):
    """The tower half of the classifier: CLIP image features,
    unit-normalized, fp32 (the tower -> head boundary value)."""
    img = clip_fns.encode_image(params, images, clip_cfg,
                                compute_dtype=compute_dtype,
                                attn_impl=attn_impl, base_grads=base_grads)
    return clip_fns.normalize(img).float()


def head_logits(trainable, img):
    """The head half: fp32 linear logits of the fp32 boundary features."""
    return img @ trainable["head"]["w"] + trainable["head"]["b"]


def head_forward(frozen, trainable, images, tokens, *, clip_cfg,
                 compute_dtype, attn_impl="fused"):
    """Classifier forward -> (logits, features, None). With a ``backbone``
    in the trainable tree (FT) the tower trains: it is read from there and
    the fused blocks compute its weight grads; else the frozen tower runs
    with none. ``tokens`` is unused (the head covers every slot)."""
    params = trainable.get("backbone") or frozen
    img = head_features(params, images, clip_cfg=clip_cfg,
                        compute_dtype=compute_dtype,
                        base_grads="backbone" in trainable,
                        attn_impl=attn_impl)
    return head_logits(trainable, img), img, None


class ER(OnlineTrainer):
    """Experience replay with reservoir memory and CutMix. ``attn_impl``:
    the tower's road (``models/clip.py``)."""

    train_backbone = False
    attn_impl = "fused"

    def make_opt(self, leaves):
        """The optimizer (JAX ``_make_tx``): the script's optimizer and
        schedule, over 10 000 steps as JAX's default. CLIB and RM give
        theirs."""
        cfg = self.cfg
        return make_optimizer(cfg.opt_name, leaves, cfg.lr,
                              sched_name=cfg.sched_name)

    def _set_lr(self, lr: float):
        """The learning rate of the next update on, moments kept."""
        set_lr(self.state.opt, self.state.sched, lr)

    def setup_model(self):
        cfg = self.cfg
        dev = self.device
        self.params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=dev)
        self.peft_cfg = PEFTConfig(method="none")
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        c, e = self.vocab.max_classes, self.clip_cfg.embed_dim
        trainable = {"head": {"w": torch.zeros(e, c, device=dev),
                              "b": torch.zeros(c, device=dev)}}
        if self.train_backbone:
            # fp32 masters, cast inside the forward; nothing stays frozen
            trainable["backbone"] = self.params
            frozen = {}
        else:
            # the tower is frozen: cast it to the compute dtype once
            frozen = cast_towers(self.params, self.compute_dtype)
        self.state = TrainState(trainable=trainable, frozen=frozen,
                                make_opt=self.make_opt, gen=self.next_gen())
        log.info("trainable params: %d", param_count(trainable))
        self._dp_mesh = self.resolve_dp_mesh(self._step_bs(), cfg.batchsize)
        self._eval_dp_mesh = self.resolve_dp_mesh(cfg.test_batchsize)

        self._fwd = functools.partial(
            head_forward, clip_cfg=self.clip_cfg,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)
        self.remat = cfg.remat or cfg.batchsize >= 256
        self._pipeline = preprocess.make_train_pipeline(
            self.clip_cfg.image_size, self.train_dataset.mean,
            self.train_dataset.std, use_autoaug="autoaug" in cfg.transforms,
            out_dtype=self.compute_dtype)
        self._eval_pipeline = preprocess.make_eval_pipeline(
            self.clip_cfg.image_size, self.train_dataset.mean,
            self.train_dataset.std, out_dtype=self.compute_dtype)
        self._train_step = self._make_step("cutmix" in cfg.transforms)
        # the head covers every max_classes slot; tokens unused
        self._dummy_tokens = torch.zeros(self.vocab.max_classes, 1,
                                         dtype=torch.int64, device=dev)

    def _make_step(self, use_cutmix: bool):
        """The engine's train step on the classifier forward; remat
        (JAX ``er_baseline.py:124-133``): ``--remat``, batches of 256 and
        up, or ``remat_fallback``'s retry after the card runs out of
        memory."""
        cfg = self.cfg
        return remat_fallback(lambda fb: make_train_step(
            self.clip_cfg, self.peft_cfg, image_size=self.clip_cfg.image_size,
            mean=self.train_dataset.mean, std=self.train_dataset.std,
            use_autoaug="autoaug" in cfg.transforms, use_cutmix=use_cutmix,
            compute_dtype=self.compute_dtype, forward_fn=self._fwd,
            remat=self.remat or fb, dp=self._dp_mesh))

    def replay_concat(self, images, labels):
        """The training batch (JAX ``:151-168``): with ``temp_batchsize``
        set, temp stream samples + (batchsize - temp) memory samples;
        otherwise a full stream batch + a full memory batch. A device
        tensor of stream images is joined on the device."""
        cfg = self.cfg
        if cfg.temp_batchsize > 0:
            images = images[:cfg.temp_batchsize]
            labels = labels[:cfg.temp_batchsize]
            mem_bs = max(cfg.batchsize - cfg.temp_batchsize, 0)
        else:
            mem_bs = cfg.batchsize
        if cfg.memory_size > 0 and len(self.memory) > 0 and mem_bs > 0:
            mem_idx = self.memory.sample(mem_bs)
            m_images, m_labels = self.train_dataset.gather(mem_idx)
            images = (torch.cat([images, self._tensor(m_images)])
                      if isinstance(images, torch.Tensor)
                      else np.concatenate([images, m_images], axis=0))
            labels = np.concatenate([labels, m_labels], axis=0)
        return images, labels

    def _step_bs(self) -> int:
        cfg = self.cfg
        if cfg.memory_size <= 0:
            return cfg.batchsize
        return cfg.batchsize if cfg.temp_batchsize > 0 \
            else cfg.batchsize * 2

    def _batch(self, images, labels, mask=None):
        """The step's batch on the device: uint8 images, labels remapped to
        class slots, the dummy token table and the exposure mask."""
        return {"images": self._tensor(images),
                "labels": self._tensor(self.vocab.remap(labels),
                                       torch.int64),
                "tokens": self._dummy_tokens,
                "mask": (self._tensor(self.vocab.logit_mask(), torch.float32)
                         if mask is None else mask)}

    def stream_batch(self, images, labels, dp=None):
        """The replay concat padded to the step's batch, on the device
        (this rank's rows under ``dp``)."""
        images, labels = self.replay_concat(images, labels)
        images, labels, _ = pad_batch(images, labels, self._step_bs())
        return self._batch(local_rows(images, dp), local_rows(labels, dp))

    def online_step(self, images, labels, indices):
        batch = self.stream_batch(images, labels, dp=self._dp_mesh)
        stats = {}
        for _ in range(max(int(self.cfg.online_iter), 1)):
            stats = self._train_step(self.state, batch)
        # the memory keeps stream samples: the labels before the concat
        self.update_memory(indices, labels)
        return stats

    def update_memory(self, indices, labels):
        if self.cfg.memory_size > 0:
            for i, lab in zip(indices, labels):
                self.memory.reservoir_update(int(i), int(lab))

    # -- eval -------------------------------------------------------------------
    def prepare_eval(self):
        self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)

    def predict(self, images):
        with torch.no_grad():
            x = self._eval_pipeline(self._tensor(images))
            logits, _, _ = self._fwd(self.state.frozen, self.state.trainable,
                                     x, None)
            return (logits + self._mask[None, :]).argmax(-1)


class FT(ER):
    """Naive online finetuning (reference ``methods/finetuning.py``): the
    whole CLIP tree and the head train; no replay memory."""

    train_backbone = True

    def update_memory(self, indices, labels):
        pass
