"""MVP-CLIP trainer (``mvp-clip``): mask and visual prompts with AFS/GSF.

Counterpart of ``lifelong_clip_tpu/methods/mvp_clip.py`` (reference
``methods/mvp_clip.py``). The per-sample text-feature gradients behind the
ignore and compensation scores (JAX: ``jax.vmap(jax.grad)`` of a
per-sample loss) are written in closed form: for the cross entropy of
``logit_c = scale * (img . txt_c) * m_c + class_mask_c`` the gradient with
respect to ``txt_c`` is ``(softmax_c - onehot_c) * scale * m_c * img``.
AFS divides the image features by the compensation score before the head,
GSF scales the mean loss by ``mean(ign ** gamma)`` (the reference's
broadcast quirk), and the prompt-pool similarity loss is added.

The text features do not depend on the trainable tree: the train step takes
them from a cache keyed by the step's class slots, which changes no value.
The e-prompt usage counts are a device tensor outside the optimizer; a
checkpoint keeps them (``checkpoint_extra``). A data-parallel mesh runs the
step on each rank's rows (JAX ``:38-64``, ``:118-209``): the batch-mean
text gradient and GSF's scale are the global batch's (averaged over the
data group), the contrastive term spans it (``models/mvp_clip.py``) and the
count increments are summed.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import CLIPConfig
from ..models import build_clip
from ..models import clip as clip_fns
from ..models.clip import cast_towers
from ..models.init import param_count
from ..models.mvp_clip import init_mvp_params, mvp_features, mvp_head
from ..ops import preprocess
from ..ops.attention import mm32
from ..parallel.mesh import local_rows
from ..utils.train_utils import make_optimizer
from .base import OnlineTrainer, pad_batch
from .engine import TrainState

log = logging.getLogger("lifelong_clip_tpu_torch")


def mvp_scores(img_f, txt_f, y, cls_mask, class_mask, scale, use_mask: bool,
               margin: float, dp=None):
    """(ign_score, cps_score) per sample from detached features (reference
    ``_compute_grads`` + ``_get_ignore`` / ``_get_compensation``). ``dp``:
    the data-parallel mesh; the batch-mean gradient is then the global
    batch's, the mean of the ranks' (equal shards)."""
    with torch.no_grad():
        img_n = clip_fns.normalize(img_f).float()
        txt_n = clip_fns.normalize(txt_f).float()
        logit = scale * mm32(img_n, txt_n.T)                       # (B, C)
        m = cls_mask.float()[:, :logit.shape[1]] if use_mask else None
        if m is not None:
            logit = logit * m
        logit = logit + class_mask[None, :]
        # d CE_b / d logit_bc, times d logit_bc / d txt_c = scale * m * img_b
        coef = torch.softmax(logit, -1) - F.one_hot(
            y, logit.shape[1]).float()
        coef = coef * scale if m is None else coef * scale * m      # (B, C)
        sample_grad = coef.gather(1, y[:, None]) * img_n            # (B, D)
        batch_grad = mm32(coef.T, img_n) / img_n.shape[0]           # (C, D)
        if dp is not None:
            dp.all_mean([batch_grad])
        batch_grad = batch_grad[y]                                  # (B, D)

        def cos(a, b, eps=1e-8):
            na = torch.linalg.vector_norm(a, dim=-1) + eps
            nb = torch.linalg.vector_norm(b, dim=-1) + eps
            return (a * b).sum(-1) / (na * nb)

        ign_score = 1.0 - cos(sample_grad, batch_grad)
        cps_score = 1.0 - cos(txt_n[y], img_n) + margin
    return ign_score, cps_score


def mvp_objective(frozen, mvp, count, images, batch, clip_cfg: CLIPConfig, *,
                  compute_dtype=torch.bfloat16, attn_impl: str = "fused",
                  use_mask: bool = False, use_contrastiv: bool = False,
                  use_afs: bool = False, use_gsf: bool = False,
                  use_last_layer: bool = False, alpha: float = 0.5,
                  gamma: float = 2.0, margin: float = 0.5,
                  remat: bool = False, dp=None):
    """The train objective (JAX ``CLIP_MVP.setup_model.step.objective``,
    ``:160-198``) on normalized images: returns (loss, logits, new_count).
    ``remat`` checkpoints the ``mvp_features`` call (JAX ``:146-150``): the
    backward recomputes the prompted tower instead of keeping its
    intermediates. ``dp``: the data-parallel mesh (``mvp_features``,
    ``mvp_scores``; GSF's scale is the global batch's mean).

    batch dict (tensors on the device):
      labels        (B,) int64, remapped to class-table slots
      txt           (K, E) text features of the step's class slots (raw
                    ``encode_text`` output; the head normalizes)
      mask          (K,) f32, 0 on valid class slots, -inf on padding
      slot_globals  (K,) int64 global class ids of the slots, -1 pad"""
    scale = torch.exp(frozen["logit_scale"]).float()
    txt, labels = batch["txt"], batch["labels"]
    feats = (functools.partial(torch.utils.checkpoint.checkpoint,
                               mvp_features, use_reentrant=False,
                               preserve_rng_state=False)
             if remat else mvp_features)
    img, cls_mask_full, sim_loss, new_count, _ = feats(
        frozen, mvp, count, images, clip_cfg, use_contrastiv=use_contrastiv,
        use_last_layer=use_last_layer, train=True,
        compute_dtype=compute_dtype, attn_impl=attn_impl, dp=dp)
    cls_mask = cls_mask_full[:, batch["slot_globals"].clamp(min=0)]
    ign, cps = mvp_scores(img, txt, labels, cls_mask, batch["mask"], scale,
                          use_mask, margin, dp=dp)
    img_used = img / cps[:, None].to(img.dtype) if use_afs else img
    logits = mvp_head(frozen, img_used, txt,
                      cls_mask=cls_mask if use_mask else None,
                      class_mask=batch["mask"], use_mask=use_mask)
    loss = F.cross_entropy(logits, labels)
    if use_gsf:
        # the reference's broadcast quirk (mvp_clip.py:273-276): the CE is
        # already mean-reduced when ign ** gamma meets it
        gsf_w = (ign ** gamma).mean()
        if dp is not None:   # a constant of the backward: ign has no grad
            dp.all_mean([gsf_w])
        loss = (1 - alpha) * loss + alpha * gsf_w * loss
    return loss + sim_loss, logits, new_count


def make_mvp_train_step(clip_cfg: CLIPConfig, *, image_size: int, mean, std,
                        use_autoaug: bool = False,
                        compute_dtype=torch.bfloat16, dp=None,
                        **objective_kw):
    """The online step ``step(state, batch, count) -> (new_count, metrics)``
    (JAX ``:152-217``): augmentation, ``mvp_objective`` on the batch (its
    dict plus ``images``, uint8 (B, H, W, C)), backward, optimizer update.
    ``objective_kw``: the method flags of ``mvp_objective`` and its
    ``remat``. ``dp``: the data-parallel mesh (the batch holds this rank's
    rows; the count increments are summed over the data group with the
    grads' all-reduce). The step updates ``state`` in place."""
    pipeline = preprocess.make_train_pipeline(
        image_size, mean, std, use_autoaug=use_autoaug,
        out_dtype=compute_dtype)
    objective = functools.partial(mvp_objective, clip_cfg=clip_cfg,
                                  compute_dtype=compute_dtype, dp=dp,
                                  **objective_kw)

    def step(state: TrainState, batch, count):
        gen = state.gen if dp is None else dp.fold_gen(state.gen)
        images = pipeline(gen, batch["images"])
        loss, logits, new_count = objective(state.frozen, state.trainable,
                                            count, images, batch)
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        stats = {"loss": loss.detach(), "acc": acc}
        new_count = new_count.detach()
        inc = [] if dp is None else [new_count - count]
        state.apply(loss, dp, mean=stats.values(), total=inc)
        return (count + inc[0] if inc else new_count), stats

    return step


def make_mvp_eval_step(clip_cfg: CLIPConfig, *, image_size: int, mean, std,
                       compute_dtype=torch.bfloat16, attn_impl: str = "fused",
                       use_mask: bool = False, use_contrastiv: bool = False,
                       use_last_layer: bool = False):
    """Eval step (JAX ``:234-249``): uint8 images, normalized text features,
    the exposure mask and the slot ids -> (preds, logits)."""
    pipeline = preprocess.make_eval_pipeline(image_size, mean, std,
                                             out_dtype=compute_dtype)

    @torch.no_grad()
    def eval_step(frozen, mvp, count, images_u8, txt_features, mask,
                  slot_ids):
        img, cls_mask_full, _, _, _ = mvp_features(
            frozen, mvp, count, pipeline(images_u8), clip_cfg,
            use_contrastiv=use_contrastiv, use_last_layer=use_last_layer,
            train=False, compute_dtype=compute_dtype, attn_impl=attn_impl)
        cls_mask = cls_mask_full[:, slot_ids.clamp(min=0)]
        logits = mvp_head(frozen, img, txt_features,
                          cls_mask=cls_mask if use_mask else None,
                          class_mask=mask, use_mask=use_mask)
        return logits.argmax(-1), logits

    return eval_step


def make_mvp_text_fn(clip_cfg: CLIPConfig, *, compute_dtype=torch.bfloat16,
                     attn_impl: str = "fused", normalized: bool = False):
    """Class-token table -> text features of the frozen text tower (the
    train step's raw features, or eval's normalized ones)."""

    @torch.no_grad()
    def text_features(frozen, tokens):
        txt = clip_fns.encode_text(frozen, tokens, clip_cfg,
                                   compute_dtype=compute_dtype,
                                   attn_impl=attn_impl)
        return clip_fns.normalize(txt) if normalized else txt

    return text_features


class CLIP_MVP(OnlineTrainer):
    """Trainer for mvp-clip. The flag defaults match the reference CLI
    (all off); ``main.py`` maps ``--use_mask`` and the like onto these
    class attributes, and ``scripts/mvp_clip.sh`` turns on mask and
    contrastive."""

    use_mask = False
    use_contrastiv = False
    use_afs = False
    use_gsf = False
    use_last_layer = False
    alpha = 0.5
    gamma = 2.0
    margin = 0.5
    task_num = 10   # e-prompt pool size (reference mvp_clip.py:26)
    _attn_impl = "fused"   # the towers' road (models/clip.py)

    def setup_model(self):
        cfg = self.cfg
        dev = self.device
        self.params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=dev)
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        # the reference never passes task_num, so the pool is 10 whatever
        # n_tasks is (JAX mvp_clip.py:102-105)
        self.e_pool = self.task_num
        self.mvp = init_mvp_params(self.next_gen(), self.clip_cfg,
                                   e_pool=self.e_pool,
                                   num_classes=self.vocab.max_classes,
                                   device=dev)
        self.count = torch.zeros(self.e_pool, device=dev)

        def make_opt(leaves):
            return make_optimizer(cfg.opt_name, leaves, cfg.lr,
                                  sched_name=cfg.sched_name)

        # the towers are frozen: cast them to the compute dtype once
        frozen = cast_towers(self.params, self.compute_dtype)
        self.state = TrainState(trainable=self.mvp, frozen=frozen,
                                make_opt=make_opt, gen=self.next_gen())
        log.info("MVP trainable params: %d", param_count(self.mvp))
        self.step_capacity = min(self.vocab.max_classes, cfg.batchsize)

        flags = dict(use_mask=self.use_mask,
                     use_contrastiv=self.use_contrastiv,
                     use_last_layer=self.use_last_layer,
                     attn_impl=self._attn_impl)
        ccfg, dt = self.clip_cfg, self.compute_dtype
        self._dp_mesh = self.resolve_dp_mesh(cfg.batchsize)
        self._eval_dp_mesh = self.resolve_dp_mesh(cfg.test_batchsize)
        self._train_step = make_mvp_train_step(
            ccfg, image_size=ccfg.image_size, mean=self.train_dataset.mean,
            std=self.train_dataset.std,
            use_autoaug="autoaug" in cfg.transforms, compute_dtype=dt,
            dp=self._dp_mesh, use_afs=self.use_afs, use_gsf=self.use_gsf,
            alpha=self.alpha,
            gamma=self.gamma, margin=self.margin,
            # JAX mvp_clip.py:146-150: no OOM fallback for this step
            remat=cfg.remat or cfg.batchsize >= 256, **flags)
        self._eval_fn = make_mvp_eval_step(
            ccfg, image_size=ccfg.image_size, mean=self.train_dataset.mean,
            std=self.train_dataset.std, compute_dtype=dt, **flags)
        self._step_text_fn = make_mvp_text_fn(ccfg, compute_dtype=dt,
                                              attn_impl=self._attn_impl)
        self._text_fn = make_mvp_text_fn(ccfg, compute_dtype=dt,
                                         attn_impl=self._attn_impl,
                                         normalized=True)
        self._step_txt_cache = {}
        self._txt_cache_n = -1

    # the e-prompt usage counts live outside TrainState: without them a
    # resumed run would restart the pool's selection statistics at zero
    def checkpoint_extra(self):
        extra = super().checkpoint_extra()
        extra["mvp_clip"] = {"count": self.count.detach().cpu()}
        return extra

    def restore_extra(self, extra):
        super().restore_extra(extra)
        st = (extra or {}).get("mvp_clip")
        if st:
            self.count = st["count"].to(self.device)

    def online_step(self, images, labels, indices):
        cfg = self.cfg
        images, labels, _ = pad_batch(images, labels, cfg.batchsize)
        if cfg.visible_classes == "batch":
            tokens, mask, y, slot_globals = self.vocab.batch_table(
                labels, self.step_capacity)
        else:
            tokens = self.vocab.token_table
            mask = self.vocab.logit_mask()
            y = self.vocab.remap(labels)
            slot_globals = np.where(self.vocab.exposed_mask,
                                    np.arange(self.vocab.max_classes), -1)
        key = tuple(int(s) for s in slot_globals)
        txt = self._step_txt_cache.get(key)
        if txt is None:
            txt = self._step_text_fn(self.state.frozen, self._tensor(tokens))
            if len(self._step_txt_cache) > 512:
                self._step_txt_cache.clear()
            self._step_txt_cache[key] = txt
        dp = self._dp_mesh
        batch = {"images": self._tensor(local_rows(images, dp)),
                 "labels": self._tensor(local_rows(y, dp), torch.int64),
                 "txt": txt,
                 "mask": self._tensor(mask, torch.float32),
                 "slot_globals": self._tensor(slot_globals, torch.int64)}
        stats = {}
        for _ in range(max(int(cfg.online_iter), 1)):
            self.count, stats = self._train_step(self.state, batch,
                                                 self.count)
        return stats

    def prepare_eval(self):
        if self._txt_cache_n != len(self.vocab):
            self._txt_cache = self._text_fn(
                self.state.frozen, self._tensor(self.vocab.token_table))
            self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)
            # exposed slot i is mask column (global slot) i
            self._slot_ids = self._tensor(
                np.where(self.vocab.exposed_mask,
                         np.arange(self.vocab.max_classes), -1), torch.int64)
            self._txt_cache_n = len(self.vocab)

    def predict(self, images):
        preds, _ = self._eval_fn(self.state.frozen, self.state.trainable,
                                 self.count, self._tensor(images),
                                 self._txt_cache, self._mask, self._slot_ids)
        return preds


class CLIP_MVP_Full(CLIP_MVP):
    """MVP with every option on (mask, contrastive, AFS, GSF) and the
    full-depth query pass."""
    use_mask = True
    use_contrastiv = True
    use_afs = True
    use_gsf = True
    use_last_layer = True
