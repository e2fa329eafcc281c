"""MaPLe trainer (``maple``): online multi-modal prompt tuning.

Counterpart of ``lifelong_clip_tpu/methods/maple.py`` (reference
``methods/maple.py``): only the prompt learner trains; the class prompts are
"<init phrase> <classname>." for the classes visible in the step, kept in a
``ClassVocabulary`` whose template is the MaPLe prefix; the forward is
``models/maple.py:maple_forward`` over both towers inside the engine's train
step (its ``forward_fn``), with plain cross entropy on the masked logits.
A data-parallel mesh runs the step on each rank's rows (JAX ``:77-94``).
"""

from __future__ import annotations

import logging

import torch

from ..config import PEFTConfig
from ..models import build_clip
from ..models import clip as clip_fns
from ..models.clip import cast_towers
from ..models.init import param_count
from ..models.maple import (init_maple_params, maple_encode_image,
                            maple_encode_text, maple_forward)
from ..ops import preprocess
from ..parallel.mesh import local_rows
from ..utils import tokenizer as tok
from ..utils.class_vocab import ClassVocabulary
from ..utils.train_utils import make_optimizer
from .base import OnlineTrainer, pad_batch
from .engine import TrainState, make_train_step, remat_fallback

log = logging.getLogger("lifelong_clip_tpu_torch")

CTX_INIT = "a bad photo of a"


class MaPLe(OnlineTrainer):
    """Trainer for maple; ``_attn_impl``: the towers' road
    (``models/clip.py``)."""

    _attn_impl = "fused"
    n_ctx = 3
    prompt_depth = 3

    def setup_model(self):
        cfg = self.cfg
        dev = self.device
        self.params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=dev)
        self.peft_cfg = PEFTConfig(method="maple", n_ctx=self.n_ctx,
                                   prompt_depth=self.prompt_depth)
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        # class prompts "<ctx words> <classname>.": token positions
        # 1..1+n_ctx are replaced by the learnable ctx in the forward
        self.vocab = ClassVocabulary(
            self.train_dataset.class_names,
            max_classes=cfg.max_classes or self.n_classes,
            template=CTX_INIT + " {}.")
        ctx_tokens = tok.default_tokenizer().encode(CTX_INIT)
        if len(ctx_tokens) < self.n_ctx:
            raise ValueError(f"the init phrase {CTX_INIT!r} has "
                             f"{len(ctx_tokens)} tokens < n_ctx={self.n_ctx}")
        self.learner = init_maple_params(
            self.next_gen(), self.params, self.clip_cfg, n_ctx=self.n_ctx,
            depth=self.prompt_depth, ctx_init_tokens=ctx_tokens, device=dev)

        def make_opt(leaves):
            return make_optimizer(cfg.opt_name, leaves, cfg.lr,
                                  sched_name=cfg.sched_name)

        # the towers are frozen: cast them to the compute dtype once
        frozen = cast_towers(self.params, self.compute_dtype)
        self.state = TrainState(trainable=self.learner, frozen=frozen,
                                make_opt=make_opt, gen=self.next_gen())
        log.info("MaPLe trainable params: %d", param_count(self.learner))
        self.step_capacity = min(self.vocab.max_classes, cfg.batchsize)

        ccfg, dt, n_ctx = self.clip_cfg, self.compute_dtype, self.n_ctx
        impl = self._attn_impl
        self._dp_mesh = self.resolve_dp_mesh(cfg.batchsize)
        self._eval_dp_mesh = self.resolve_dp_mesh(cfg.test_batchsize)

        def fwd(frozen, trainable, images, tokens):
            return maple_forward(frozen, trainable, images, tokens, ccfg,
                                 n_ctx, dt, impl)

        mean, std = self.train_dataset.mean, self.train_dataset.std
        # remat as JAX maple.py:88-96: the whole forward checkpointed
        self._train_step = remat_fallback(lambda fb: make_train_step(
            ccfg, self.peft_cfg, image_size=ccfg.image_size, mean=mean,
            std=std, use_autoaug="autoaug" in cfg.transforms,
            compute_dtype=dt, forward_fn=fwd,
            remat=cfg.remat or cfg.batchsize >= 256 or fb, dp=self._dp_mesh))
        self._text_fn = make_maple_text_fn(ccfg, n_ctx, compute_dtype=dt,
                                           attn_impl=impl)
        self._eval_fn = make_maple_eval_step(ccfg, n_ctx, mean=mean, std=std,
                                             compute_dtype=dt, attn_impl=impl)
        self._txt_cache_key = None

    def online_before_task(self, task_id):
        # the reference rebuilds the optimizer at every task boundary
        # (methods/maple.py:138 + _trainer.py:536-538)
        if task_id > 0:
            self.state.reset_optimizer()

    def online_step(self, images, labels, indices):
        cfg = self.cfg
        images, labels, _ = pad_batch(images, labels, cfg.batchsize)
        if cfg.visible_classes == "batch":
            tokens, mask, y, _ = self.vocab.batch_table(labels,
                                                        self.step_capacity)
        else:
            tokens = self.vocab.token_table
            mask = self.vocab.logit_mask()
            y = self.vocab.remap(labels)
        dp = self._dp_mesh
        batch = {"images": self._tensor(local_rows(images, dp)),
                 "labels": self._tensor(local_rows(y, dp), torch.int64),
                 "tokens": self._tensor(tokens, torch.int64),
                 "mask": self._tensor(mask, torch.float32)}
        stats = {}
        for _ in range(max(int(cfg.online_iter), 1)):
            stats = self._train_step(self.state, batch)
        return stats

    def prepare_eval(self):
        key = (len(self.vocab), self.state.step)
        if self._txt_cache_key != key:
            self._txt_cache = self._text_fn(
                self.state.frozen, self.state.trainable,
                self._tensor(self.vocab.token_table, torch.int64))
            self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)
            self._txt_cache_key = key

    def predict(self, images):
        preds, _ = self._eval_fn(self.state.frozen, self.state.trainable,
                                 self._tensor(images), self._txt_cache,
                                 self._mask)
        return preds


def make_maple_text_fn(clip_cfg, n_ctx: int, *, compute_dtype=torch.bfloat16,
                       attn_impl: str = "fused"):
    """Class-token table -> normalized MaPLe text features (no grad)."""

    @torch.no_grad()
    def text_features(frozen, learner, tokens):
        return clip_fns.normalize(maple_encode_text(
            frozen, learner, tokens, clip_cfg, n_ctx, compute_dtype,
            attn_impl))

    return text_features


def make_maple_eval_step(clip_cfg, n_ctx: int, *, mean, std,
                         compute_dtype=torch.bfloat16,
                         attn_impl: str = "fused"):
    """Eval step (JAX ``methods/maple.py:108-124``): uint8 images resized
    and normalized, cached text features and the exposure mask ->
    (preds, logits)."""
    pipeline = preprocess.make_eval_pipeline(clip_cfg.image_size, mean, std,
                                             out_dtype=compute_dtype)

    @torch.no_grad()
    def eval_step(frozen, learner, images_u8, txt_features, mask):
        img = clip_fns.normalize(maple_encode_image(
            frozen, learner, pipeline(images_u8), clip_cfg, n_ctx,
            compute_dtype, attn_impl))
        scale = torch.exp(frozen["logit_scale"]).float()
        logits = scale * (img.float() @ txt_features.float().T) + mask[None, :]
        return logits.argmax(-1), logits

    return eval_step
