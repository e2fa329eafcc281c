"""The online-learning engine: one train step, one eval step, the text pass.

Counterpart of ``lifelong_clip_tpu/methods/engine.py`` on its single-device,
cached-text road: the vision tower with LoRA runs forward and backward
through the fused attention kernels (``base_grads=False``), logits go
against cached normalized class-text features, and a ``torch.optim``
optimizer updates the LoRA tree. The step runs eagerly (the JAX package
jits it); its state is an explicit ``TrainState`` object.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..config import CLIPConfig, PEFTConfig
from ..models import clip as clip_fns
from ..ops import preprocess


def tree_leaves(tree):
    """Tensors of a nested dict in a fixed (insertion) order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class TrainState:
    """Trainable (fp32 masters) and frozen trees, the optimizer over the
    trainable leaves, its schedule, the step count and the augmentation
    generator."""

    def __init__(self, *, trainable, frozen, make_opt: Callable,
                 gen: torch.Generator):
        self.trainable = trainable
        self.frozen = frozen
        self.make_opt = make_opt
        self.gen = gen
        self.step = 0
        for p in tree_leaves(trainable):
            p.requires_grad_(True)
        self.reset_optimizer()

    def reset_optimizer(self):
        """Fresh moments and a restarted schedule (``tx.init``)."""
        self.opt, self.sched = self.make_opt(tree_leaves(self.trainable))


def peft_forward_cached_text(frozen, trainable, images, txt_features,
                             clip_cfg: CLIPConfig, peft_cfg: PEFTConfig,
                             compute_dtype, attn_impl: str = "fused"):
    """Image-only-PEFT forward against precomputed normalized text
    features (``engine.py:145-167``)."""
    img = clip_fns.encode_image(
        frozen, images, clip_cfg,
        peft_cfg=peft_cfg if peft_cfg.on_vision() else None,
        peft=trainable.get("vision"), compute_dtype=compute_dtype,
        attn_impl=attn_impl, base_grads=False)
    img = clip_fns.normalize(img)
    scale = torch.exp(frozen["logit_scale"]).float()
    logits = scale * (img.float() @ txt_features.float().T)
    return logits, img, txt_features


def ce_on_probs_loss(logits, labels):
    """CE applied to softmaxed probs (``engine.py:170-179``); padded -inf
    class slots are excluded from both softmaxes."""
    probs = torch.softmax(logits, dim=-1)
    z = torch.where(torch.isfinite(logits), probs,
                    torch.full_like(probs, float("-inf")))
    return F.cross_entropy(z, labels)


def _default_loss(logits, labels):
    return F.cross_entropy(logits, labels)


def make_train_step(clip_cfg: CLIPConfig, peft_cfg: PEFTConfig, *,
                    image_size: int, mean, std, augment: bool = True,
                    use_autoaug: bool = False,
                    compute_dtype=torch.bfloat16, attn_impl: str = "fused",
                    forward_fn: Optional[Callable] = None,
                    loss_fn: Optional[Callable] = None):
    """Build the online train step ``step(state, batch) -> metrics``.

    batch dict (tensors on the device):
      images  (B, H, W, C) uint8 raw samples
      labels  (B,) int64, already remapped to class-table slots
      tokens  (K, E) cached normalized text features, or, with
              ``forward_fn``, whatever it takes: MaPLe's (K, ctx) class
              token table
      mask    (K,) f32, 0 on valid class slots, -inf on padding
    ``forward_fn(frozen, trainable, images, tokens) -> (logits, img, txt)``
    replaces the image-PEFT forward (JAX ``engine.py:233-236``).
    ``augment=False`` casts the raw uint8 straight to the compute dtype
    (``engine.py:277-278``). The step updates ``state`` in place.
    """
    pipeline = preprocess.make_train_pipeline(
        image_size, mean, std, use_autoaug=use_autoaug,
        out_dtype=compute_dtype) if augment else None
    fwd = forward_fn or functools.partial(
        peft_forward_cached_text, clip_cfg=clip_cfg, peft_cfg=peft_cfg,
        compute_dtype=compute_dtype, attn_impl=attn_impl)
    compute_loss = loss_fn or _default_loss

    def step(state: TrainState, batch):
        if pipeline is not None:
            images = pipeline(state.gen, batch["images"])
        else:
            images = batch["images"].to(compute_dtype)
        logits, _, _ = fwd(state.frozen, state.trainable, images,
                           batch["tokens"])
        logits = logits + batch["mask"][None, :]
        loss = compute_loss(logits, batch["labels"])
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.sched.step()
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return step


def make_text_feature_fn(clip_cfg: CLIPConfig, peft_cfg: PEFTConfig, *,
                         compute_dtype=torch.bfloat16,
                         attn_impl: str = "fused"):
    """Class-token table -> normalized text features; run once per change of
    the exposed class set."""

    @torch.no_grad()
    def text_features(frozen, trainable, tokens):
        txt = clip_fns.encode_text(
            frozen, tokens, clip_cfg,
            peft_cfg=peft_cfg if peft_cfg.on_text() else None,
            peft=(trainable or {}).get("text"),
            compute_dtype=compute_dtype, attn_impl=attn_impl)
        return clip_fns.normalize(txt)

    return text_features


def make_eval_step(clip_cfg: CLIPConfig, peft_cfg: PEFTConfig, *,
                   image_size: int, mean, std, compute_dtype=torch.bfloat16,
                   attn_impl: str = "fused"):
    """Eval step: uint8 images + cached text features -> (preds, logits)."""
    pipeline = preprocess.make_eval_pipeline(image_size, mean, std,
                                             out_dtype=compute_dtype)

    @torch.no_grad()
    def eval_step(frozen, trainable, images_u8, txt_features, mask):
        img = clip_fns.encode_image(
            frozen, pipeline(images_u8), clip_cfg,
            peft_cfg=peft_cfg if peft_cfg.on_vision() else None,
            peft=(trainable or {}).get("vision"),
            compute_dtype=compute_dtype, attn_impl=attn_impl)
        img = clip_fns.normalize(img)
        scale = torch.exp(frozen["logit_scale"]).float()
        logits = scale * (img.float() @ txt_features.float().T)
        logits = logits + mask[None, :]
        return logits.argmax(-1), logits

    return eval_step
