"""CLIB (``clib``): memory-only training with sample-wise importance and an
adaptive learning rate.

Counterpart of ``lifelong_clip_tpu/methods/clib.py`` (reference
``methods/clib.py``): each stream sample enters the memory through
``ReplayMemory.clib_update``; training batches come from the memory only;
every ``imp_update_period`` updates a per-sample loss sweep over the whole
memory (under the eval transform) feeds the ``others_loss_decrease``
attribution; and the learning rate alternates between a high and a low
value, a Welch t-test (scipy) deciding when the pair moves
(``_adaptive_lr``, on the host). The optimizer is AdamW with optax's
defaults (weight decay 1e-4, eps 1e-8) whatever ``--opt_name`` says.

While the tower is frozen its eval-transform features are constants of the
dataset index, so the sweep runs the head alone over a device buffer of
features, one row a memory slot: the incoming batch's features are
computed once a step and scattered into the slots ``clib_update`` wrote (a
sentinel slot drops the rest), and slots the buffer misses (a restored
memory) are recomputed in chunks of 256 rows. A trained backbone takes
the slow road: full forwards over the memory, in chunks of 256.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import ttest_ind

from .base import pad_batch
from .er_baseline import ER, head_features, head_logits


class CLIB(ER):

    ema_ratio = 0.90

    def make_opt(self, leaves):
        """optax.adamw's defaults (JAX ``clib.py:37-44``): torch's AdamW
        decays by 1e-2 unless told."""
        opt = torch.optim.AdamW(leaves, lr=self.cfg.lr, weight_decay=1e-4,
                                eps=1e-8)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)

    def setup_model(self):
        cfg = self.cfg
        self._lr_high = cfg.lr
        # reference clib.py:37: low_lr = lr_step * lr
        self._lr_low = cfg.lr_step * cfg.lr
        super().setup_model()
        # the slot feature buffer; the host keeps the slot -> index map
        self._feat_buf = None
        self._slot_index = None
        self._inc_pos = {}
        self._inc_feats = None
        self._feats_cacheable = "backbone" not in self.state.trainable

        # adaptive LR state (reference clib.py:134-195)
        self._lr_is_high = True
        self._high_hist, self._low_hist = [], []
        self._prev_losses = None
        self._train_count = 0
        self._imp_counter = 0
        self._loss_sweep = None        # the last raw sweep (reference loss)
        self._dropped_idx = []         # slots written since the LR period
        self._mem_dropped_idx = []     # slots written since the last sweep
        self._set_lr(self._lr_high)

    # -- the steps -------------------------------------------------------------
    def clib_step(self, state, batch):
        """One update on a memory batch (JAX ``clib.py:58-77``)."""
        images = self._pipeline(state.gen, batch["images"])
        logits, _, _ = self._fwd(state.frozen, state.trainable, images, None)
        logits = logits + batch["mask"][None, :]
        loss = F.cross_entropy(logits, batch["labels"])
        state.apply(loss)
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    @torch.no_grad()
    def eval_feats(self, tower, images_u8):
        """Boundary features of uint8 images under the eval transform."""
        return head_features(tower, self._eval_pipeline(images_u8),
                             clip_cfg=self.clip_cfg,
                             compute_dtype=self.compute_dtype,
                             attn_impl=self.attn_impl)

    @torch.no_grad()
    def head_losses(self, feats, labels, mask):
        logits = head_logits(self.state.trainable, feats) + mask[None, :]
        return F.cross_entropy(logits, labels, reduction="none")

    @staticmethod
    @torch.no_grad()
    def scatter_feats(buf, feats, pos, slots):
        """``buf[slots[i]] = feats[pos[i]]``; a slot of ``len(buf)`` (the
        sentinel) drops its row."""
        live = slots < buf.shape[0]
        buf[slots[live]] = feats[pos[live]]

    # -- checkpoint: without it a resumed run resets the adaptive-LR state
    # machine and attributes its first sweep against an empty one
    def checkpoint_extra(self):
        return {"clib": {
            "lr_high": self._lr_high, "lr_low": self._lr_low,
            "lr_is_high": self._lr_is_high,
            "high_hist": list(self._high_hist),
            "low_hist": list(self._low_hist),
            "prev_losses": None if self._prev_losses is None
            else np.asarray(self._prev_losses).tolist(),
            "train_count": self._train_count,
            "imp_counter": self._imp_counter,
            "loss_sweep": None if self._loss_sweep is None
            else np.asarray(self._loss_sweep).tolist(),
            "dropped_idx": list(self._dropped_idx),
            "mem_dropped_idx": list(self._mem_dropped_idx),
            "previous_slots": list(self.memory.previous_slots),
        }}

    def restore_extra(self, extra):
        st = (extra or {}).get("clib")
        if not st:
            return
        self._lr_high = st["lr_high"]
        self._lr_low = st["lr_low"]
        self._lr_is_high = st["lr_is_high"]
        self._high_hist = list(st["high_hist"])
        self._low_hist = list(st["low_hist"])
        self._prev_losses = None if st["prev_losses"] is None \
            else np.asarray(st["prev_losses"], np.float64)
        self._train_count = st["train_count"]
        self._imp_counter = st["imp_counter"]
        self._loss_sweep = None if st["loss_sweep"] is None \
            else np.asarray(st["loss_sweep"], np.float64)
        self._dropped_idx = list(st["dropped_idx"])
        self._mem_dropped_idx = list(st["mem_dropped_idx"])
        self.memory.previous_slots = list(st["previous_slots"])
        self._set_lr(self._lr_high if self._lr_is_high else self._lr_low)

    # -- hot loop ----------------------------------------------------------------
    def online_step(self, images, labels, indices):
        """Memory insertion, then memory-only training with a loss sweep
        and the adaptive-LR check after every update (reference
        clib.py:48-64)."""
        cfg = self.cfg
        mask = self._tensor(self.vocab.logit_mask(), torch.float32)
        if self._feats_cacheable:
            # the incoming batch's features, on the device; the sweep
            # scatters the rows clib_update inserts
            step_imgs, _, _ = pad_batch(images, labels, cfg.batchsize)
            self._inc_feats = self.eval_feats(self.state.frozen,
                                              self._tensor(step_imgs))
            self._inc_pos = {int(idx): i for i, idx in enumerate(indices)}
        order = self.vocab.exposed
        for idx, lab in zip(indices, labels):
            slot = self.memory.clib_update(int(idx), int(lab), order)
            # reference clib.py:81-87: every written slot lands on both
            # dropped lists
            self._dropped_idx.append(slot)
            self._mem_dropped_idx.append(slot)

        stats = {}
        for _ in range(max(int(cfg.online_iter), 1)):
            mem_idx, slots = self.memory.sample_with_slots(cfg.batchsize)
            if len(mem_idx) == 0:
                return {}
            self.memory.mark_used(slots)
            m_images, m_labels = self.train_dataset.gather(mem_idx)
            m_images, m_labels, _ = pad_batch(m_images, m_labels,
                                              cfg.batchsize)
            stats = self.clib_step(self.state,
                                   self._batch(m_images, m_labels, mask))
            self._samplewise_loss_update()
            self._adaptive_lr()
        return stats

    def _samplewise_loss_update(self, batch_cap: int = 256):
        """EMA-refresh the loss history over the whole memory every
        ``imp_update_period`` updates (reference clib.py:216-244)."""
        self._imp_counter += 1
        if self._imp_counter % max(self.cfg.imp_update_period, 1) != 0:
            return
        n = len(self.memory)
        if n == 0:
            return
        idx = self.memory.ordered_indices()
        labels = np.asarray(self.memory.labels)
        mask = self._tensor(self.vocab.logit_mask(), torch.float32)
        all_losses = self._memory_losses(idx, labels, mask, batch_cap)
        # the sweep-over-sweep change feeds the attribution (slots replaced
        # since the last sweep masked out); the raw sweep becomes the loss
        prev = self._loss_sweep if self._loss_sweep is not None \
            else np.empty((0,), np.float64)
        self.memory.clib_loss_update(all_losses, prev,
                                     dropped_slots=self._mem_dropped_idx,
                                     ema_ratio=self.ema_ratio)
        self._mem_dropped_idx = []
        self._loss_sweep = all_losses

    def _memory_losses(self, idx, labels, mask, batch_cap: int):
        """Per-sample loss over the memory under the eval transform (JAX
        ``clib.py:262-340``): the head over the slot feature buffer, its
        stale rows refreshed first; or, with a trained backbone, full
        forwards in chunks of ``batch_cap`` rows, every chunk dispatched
        before any is read back."""
        n = len(idx)
        if self._feats_cacheable:
            return self._cached_losses(idx, labels, mask, batch_cap)
        all_losses = np.zeros((n,), np.float64)
        tower = self.state.trainable.get("backbone") or self.state.frozen
        in_flight = []
        for lo in range(0, n, batch_cap):
            imgs, _ = self.train_dataset.gather(idx[lo:lo + batch_cap])
            labs = labels[lo:lo + batch_cap]
            imgs, labs, valid = pad_batch(imgs, labs, batch_cap)
            feats = self.eval_feats(tower, self._tensor(imgs))
            y = self._tensor(self.vocab.remap(labs), torch.int64)
            in_flight.append((lo, valid, self.head_losses(feats, y, mask)))
        for lo, valid, dev in in_flight:
            all_losses[lo:lo + valid] = dev.cpu().numpy()[:valid]
        return all_losses

    def _cached_losses(self, idx, labels, mask, batch_cap: int):
        n = len(idx)
        if self._feat_buf is None:
            m = max(self.memory.memory_size, n, 1)
            m = -(-m // batch_cap) * batch_cap
            self._feat_buf = torch.zeros(m, self.clip_cfg.embed_dim,
                                         device=self.device)
            self._slot_index = np.full((m,), -1, np.int64)
        m = self._feat_buf.shape[0]
        cur = np.full((m,), -1, np.int64)
        cur[:n] = idx
        stale = np.nonzero(cur != self._slot_index)[0]
        stale = stale[cur[stale] >= 0]
        if len(stale):
            pos = np.asarray([self._inc_pos.get(int(cur[s]), -1)
                              for s in stale], np.int64)
            rest = stale
            if (pos >= 0).any() and self._inc_feats is not None:
                k = int(self._inc_feats.shape[0])
                sl = np.full((k,), m, np.int64)       # m: the sentinel
                pp = np.zeros((k,), np.int64)
                from_inc = stale[pos >= 0]
                sl[:len(from_inc)] = from_inc
                pp[:len(from_inc)] = pos[pos >= 0]
                self.scatter_feats(self._feat_buf, self._inc_feats,
                                   self._tensor(pp), self._tensor(sl))
                rest = stale[pos < 0]
            # slots the last incoming batch does not cover (a restored or
            # pre-filled memory): recompute their features in chunks
            for lo in range(0, len(rest), batch_cap):
                chunk = rest[lo:lo + batch_cap]
                imgs, _ = self.train_dataset.gather(cur[chunk])
                pad = batch_cap - len(chunk)
                if pad:
                    imgs = np.concatenate([imgs, imgs[:1].repeat(pad, 0)], 0)
                feats = self.eval_feats(self.state.frozen,
                                        self._tensor(imgs))
                sl = np.full((batch_cap,), m, np.int64)
                sl[:len(chunk)] = chunk
                self.scatter_feats(self._feat_buf, feats,
                                   torch.arange(batch_cap,
                                                device=self.device),
                                   self._tensor(sl))
            self._slot_index = cur
        labs = np.zeros((m,), labels.dtype)
        labs[:n] = labels
        losses = self.head_losses(
            self._feat_buf, self._tensor(self.vocab.remap(labs), torch.int64),
            mask)
        return losses.cpu().numpy().astype(np.float64)[:n]

    def _adaptive_lr(self, significance: float = 0.05):
        """Reference clib.py:134-195 ``adaptive_lr``: the loss decrease of
        each period leaves out the slots replaced since the last period
        boundary; on a significant t-test the LR pair re-centres
        geometrically and the high/low phase flips a second time."""
        cfg = self.cfg
        period = cfg.lr_period or 10
        min_iter = cfg.lr_length or 10
        # gated on the importance-update counter (clib.py:135)
        if self._imp_counter % max(cfg.imp_update_period, 1) != 0:
            return
        self._train_count += 1
        cur = self._loss_sweep
        if cur is None or len(cur) == 0:      # clib.py:137
            return
        if self._train_count % period != 0:
            return
        if self._prev_losses is not None and self._train_count > 20:
            k = len(self._prev_losses)
            keep = np.ones(len(cur), bool)
            if self._dropped_idx:
                d = np.asarray(self._dropped_idx, np.int64)
                keep[d[d < len(cur)]] = False
            decrease = float(np.mean((self._prev_losses[:k] -
                                      cur[:k])[keep[:k]]))
            hist = self._high_hist if self._lr_is_high else self._low_hist
            hist.append(decrease)
            if len(hist) > min_iter:
                del hist[0]
        self._prev_losses = cur
        self._lr_is_high = not self._lr_is_high
        self._set_lr(self._lr_high if self._lr_is_high else self._lr_low)
        self._dropped_idx = []                # clib.py:162

        if (len(self._high_hist) == len(self._low_hist)
                and len(self._high_hist) >= min_iter):
            _, p = ttest_ind(self._low_hist, self._high_hist,
                             equal_var=False, alternative="greater")
            step = cfg.lr_step
            if p < significance:      # the low LR decreased the loss more
                self._lr_high = self._lr_low
                self._lr_low *= step
            elif p > 1 - significance:  # the high LR wins
                self._lr_low = self._lr_high
                self._lr_high /= step
            else:
                return
            self._high_hist, self._low_hist = [], []
            # clib.py:169-195: re-centring toggles the phase again
            self._lr_is_high = not self._lr_is_high
            self._set_lr(self._lr_high if self._lr_is_high
                         else self._lr_low)
