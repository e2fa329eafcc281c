"""Learning without Forgetting (``lwf``): distillation from the model of the
step before.

Counterpart of ``lifelong_clip_tpu/methods/lwf.py`` (reference
``methods/lwf.py``): until the first snapshot a plain cross-entropy step
(no CutMix: the reference computes ``do_cutmix`` and drops it); after it,
cross entropy plus ``kd_hp`` = 0.2 times a temperature-2 distillation term
over the raw logits of both models, at the full logit width and with no
exposure mask on either side. The snapshot of the trainable tree is taken
after each ``online_step``'s ``online_iter`` loop, and a checkpoint keeps
it. Where no backbone trains, the old and the new head read the same
frozen tower features: the KD step runs the tower once and both heads on
its output (the logits equal those of two tower passes bit for bit; a
test holds that), where JAX runs two passes; a trained backbone runs the
old tree's pass beside the new one's.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .engine import remat_fallback, tree_map
from .er_baseline import ER, head_features, head_logits


def kd_loss(raw, old_logits, tau: float):
    """Mean over rows of the cross entropy of the old model's softened
    distribution against the new one's, both at temperature ``tau``."""
    log_p = torch.log_softmax(raw / tau, dim=-1)
    q = torch.softmax(old_logits / tau, dim=-1)
    return -(q * log_p).sum(-1).mean()


def _snapshot(tree):
    return tree_map(lambda p: p.detach().clone(), tree)


class LwF(ER):

    kd_temperature = 2.0
    kd_hp = 0.2   # reference lwf.py:26

    def setup_model(self):
        super().setup_model()
        # the reference LwF never applies CutMix (lwf.py:144-147)
        self._train_step = self._make_step(False)
        self._kd_step = remat_fallback(lambda fb: functools.partial(
            self.kd_step, remat=self.remat or fb))
        self._old_trainable = None

    def kd_logits(self, frozen, trainable, old_trainable, images,
                  remat=False):
        """(new raw logits, old raw logits). Head-only training runs the
        frozen tower once for both heads; a trained backbone runs the old
        tree's pass without grad beside the new one's (checkpointed under
        remat)."""
        if "backbone" not in trainable:
            img = head_features(frozen, images, clip_cfg=self.clip_cfg,
                                compute_dtype=self.compute_dtype,
                                attn_impl=self.attn_impl)
            with torch.no_grad():
                old = head_logits(old_trainable, img)
            return head_logits(trainable, img), old
        with torch.no_grad():
            old = self._fwd(frozen, old_trainable, images, None)[0]
        if remat:
            raw = torch.utils.checkpoint.checkpoint(
                self._fwd, frozen, trainable, images, None,
                use_reentrant=False, preserve_rng_state=False)[0]
        else:
            raw = self._fwd(frozen, trainable, images, None)[0]
        return raw, old

    def kd_step(self, state, batch, old_trainable, remat=False):
        """One update on cross entropy + kd_hp x KD (JAX ``kd_step``)."""
        images = self._pipeline(state.gen, batch["images"])
        raw, old = self.kd_logits(state.frozen, state.trainable,
                                  old_trainable, images, remat)
        logits = raw + batch["mask"][None, :]
        loss = F.cross_entropy(logits, batch["labels"]) + \
            self.kd_hp * kd_loss(raw, old, self.kd_temperature)
        state.apply(loss)
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    def online_step(self, images, labels, indices):
        # the first task's steps ride the data-parallel road; the KD step
        # runs the whole batch on every rank
        batch = self.stream_batch(
            images, labels,
            dp=self._dp_mesh if self._old_trainable is None else None)
        stats = {}
        for _ in range(max(int(self.cfg.online_iter), 1)):
            if self._old_trainable is None:
                stats = self._train_step(self.state, batch)
            else:
                stats = self._kd_step(self.state, batch,
                                      self._old_trainable)
        # every iteration of the next step distills from this post-step
        # model (reference lwf.py:50-51)
        self._old_trainable = _snapshot(self.state.trainable)
        self.update_memory(indices, labels)
        return stats

    # -- the KD teacher lives outside the train state: without it a resumed
    # run trains with no distillation until the next snapshot
    def checkpoint_extra(self):
        extra = super().checkpoint_extra()
        extra["lwf"] = {"old_trainable": None if self._old_trainable is None
                        else tree_map(lambda p: p.cpu(),
                                      self._old_trainable)}
        return extra

    def restore_extra(self, extra):
        super().restore_extra(extra)
        st = (extra or {}).get("lwf")
        if st:
            self._old_trainable = None if st["old_trainable"] is None \
                else tree_map(lambda p: p.to(self.device),
                              st["old_trainable"])
