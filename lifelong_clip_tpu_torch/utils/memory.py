"""Episodic replay memory for online continual learning.

Host-side index bookkeeping (O(memory_size) integers — the right place for
it; actual sample tensors are gathered on device at batch-build time).
Covers the reference's ``Memory`` (``utils/memory.py:8-100``): per-class
counts, CLIB loss-history EMA + class-balanced replacement, and the
reservoir policy the ER-family methods implement inline
(``methods/er_baseline.py:55-94``, ``methods/adapter_clip.py:210-247``).

Determinism: updates draw from a seeded ``numpy.random.Generator``. Under
multi-host SPMD every host runs the same seeded stream, so memories stay
identical without the reference's rank-0 broadcast + barrier dance
(``methods/adapter_clip.py:229-239``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class ReplayMemory:
    """Reservoir / class-balanced episodic memory over dataset indices."""

    def __init__(self, memory_size: int, seed: int = 0):
        self.memory_size = memory_size
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.indices: List[int] = []     # dataset indices
        self.labels: List[int] = []      # class ids
        self.seen = 0
        # CLIB bookkeeping (reference utils/memory.py:29-75)
        self.loss_history: List[float] = []
        self.usage_count: List[int] = []
        self.others_loss_decrease: List[float] = []
        self.previous_slots: List[int] = []

    def __len__(self) -> int:
        return len(self.indices)

    # -- reservoir policy (ER family) ---------------------------------------
    def reservoir_update(self, sample_idx: int, label: int) -> int:
        """Classic reservoir sampling; returns slot written or -1."""
        self.seen += 1
        if len(self.indices) < self.memory_size:
            self._append(sample_idx, label)
            return len(self.indices) - 1
        j = int(self.rng.integers(0, self.seen))
        if j < self.memory_size:
            self._replace(j, sample_idx, label)
            return j
        return -1

    # -- class-balanced random policy (Rainbow Memory, reference
    #    methods/rainbow_memory.py:91-108) ----------------------------------
    def balanced_random_update(self, sample_idx: int, label: int,
                               class_order: Optional[Sequence[int]] = None
                               ) -> int:
        """Reference RM replacement (rainbow_memory.py:96-108): count the
        incoming sample's class IN, evict a RANDOM slot of the
        most-populated class (argmax ties break toward the earliest class
        in ``class_order`` — the reference's exposure-ordered cls_list),
        then insert. The reference never skips: the incoming sample is
        always stored, possibly evicting its own class.

        The slot draw comes from a dedicated ``torch.Generator`` (r4;
        same protocol-RNG rationale as utils/stream.py) so a harness can
        stream-match the reference's ``torch.randint`` draw exactly.
        ``class_order`` defaults to first-seen order in memory, which
        equals exposure order for every class that reached memory."""
        self.seen += 1
        if len(self.indices) < self.memory_size:
            self._append(sample_idx, label)
            return len(self.indices) - 1
        labels = np.asarray(self.labels)
        if class_order is None:
            order = list(dict.fromkeys(self.labels))
            if int(label) not in order:
                order.append(int(label))
        else:
            order = [int(c) for c in class_order]
        counts = np.asarray([(labels == c).sum() for c in order], np.int64)
        counts[order.index(int(label))] += 1
        # intent patch: the argmax winner can hold ZERO stored slots (the
        # +1 incoming class ties at 1 and wins the earliest-exposed
        # tie-break while absent from memory) — the reference then indexes
        # an empty cand_idx and crashes (rainbow_memory.py:104-105);
        # restrict to classes that actually have a slot to evict
        stored = counts.copy()
        stored[order.index(int(label))] -= 1
        counts[stored == 0] = -1
        heavy = order[int(np.argmax(counts))]
        slots = np.nonzero(labels == heavy)[0]
        j = int(slots[self._slot_randint(len(slots))])
        self._replace(j, sample_idx, label)
        return j

    def _slot_randint(self, n: int) -> int:
        """One draw from the dedicated torch CPU generator (reference
        update_memory's ``torch.randint(0, len(cand_idx), (1,))``)."""
        import torch
        if not hasattr(self, "_torch_gen"):
            self._torch_gen = torch.Generator().manual_seed(self._seed)
        return int(torch.randint(0, n, (1,), generator=self._torch_gen))

    # -- CLIB: replace the sample whose training contribution is least
    #    (reference methods/clib.py:66-87 + utils/memory.py:29-75) ----------
    #
    # Eviction scores are ``others_loss_decrease`` — per-slot bookkeeping
    # of how much the memory loss decreased while the slot was in the
    # training batch — NOT the slot's own loss. New slots start at the
    # mean score of their class (0 for a first-of-class sample,
    # reference memory.py:42-46/58-63). Two shipped reference defects are
    # patched per their evident intent (PARITY.md "CLIB machinery"):
    # memory.cls_list is never populated (add_new_class is ``pass``,
    # making replace_data crash on the empty tensor; the intended growth
    # is spelled out in the commented lines memory.py:25-27), so class
    # bookkeeping here follows the trainer's exposure order; and
    # memory.previous_idx is never populated (the CLIB-lineage sampler
    # that recorded trained-on slots was lost in vendoring, leaving
    # update_loss_history a no-op), so ``mark_used`` restores that
    # plumbing.
    def clib_update(self, sample_idx: int, label: int,
                    class_order: Sequence[int]) -> int:
        """Insert/replace; returns the slot written. ``class_order`` is
        the exposure-ordered class-id list (the reference's
        exposed_classes, which indexes cls_count in clib.py:76-78)."""
        self.seen += 1
        old = np.asarray(self.others_loss_decrease, np.float64)
        if len(self.indices) < self.memory_size:
            labels = np.asarray(self.labels)
            same = np.nonzero(labels == label)[0] if len(labels) else []
            # reference memory.py:42-46: first-of-class -> 0, else the
            # mean score of the existing same-class slots
            score = 0.0 if len(same) == 0 else float(old[same].mean())
            self._append(sample_idx, label)
            self.others_loss_decrease.append(score)
            return len(self.indices) - 1
        labels = np.asarray(self.labels)
        order = [int(c) for c in class_order]
        # reference clib.py:75-78: class frequencies in exposure order,
        # counting the incoming sample; argmax takes the FIRST max, i.e.
        # ties break toward earlier-exposed classes
        counts = np.asarray([(labels == c).sum() for c in order], np.int64)
        counts[order.index(int(label))] += 1
        cls = order[int(np.argmax(counts))]
        cand = np.nonzero(labels == cls)[0]
        j = int(cand[np.argmin(old[cand])])
        self._replace(j, sample_idx, label)
        # reference memory.py:51-63: score seeded AFTER the label swap —
        # first-of-class -> mean of every score (incl. the replaced
        # slot's old one), else mean over same-class slots except j
        labels = np.asarray(self.labels)
        same = np.nonzero(labels == label)[0]
        same = same[same != j]
        self.others_loss_decrease[j] = float(old.mean()) if len(same) == 0 \
            else float(old[same].mean())
        return j

    def mark_used(self, slots):
        """Record slots trained on since the last loss sweep (the
        reference's memory.previous_idx — intent plumbing, see above)."""
        self.previous_slots.extend(int(s) for s in np.atleast_1d(slots))

    def clib_loss_update(self, loss, prev_loss, dropped_slots=None,
                         ema_ratio: float = 0.90):
        """Attribute the sweep-over-sweep memory loss change to the slots
        trained on since the last sweep (reference memory.py:65-75,
        update_loss_history): a scalar mean loss change over non-dropped
        slots, EMA'd into ``others_loss_decrease`` at the used slots.
        Also keeps ``loss_history`` = the raw sweep (the reference's
        trainer-held ``self.loss``, clib.py:243) for checkpointing."""
        loss = np.asarray(loss, np.float64)
        self.loss_history = [float(l) for l in loss]
        prev = np.asarray(self.previous_slots, np.int64)
        self.previous_slots = []
        if len(prev) == 0:
            return
        prev_loss = np.asarray(prev_loss, np.float64)
        if dropped_slots is None:
            loss_diff = float(np.mean(loss - prev_loss))
        elif len(prev_loss) > 0:
            mask = np.ones(len(loss), bool)
            d = np.asarray(dropped_slots, np.int64)
            mask[d[d < len(loss)]] = False
            k = len(prev_loss)
            # intent patch: when EVERY tracked slot was replaced since the
            # last sweep (batchsize*imp_update_period > memory_size) the
            # reference takes the mean of an empty slice — a NaN that EMAs
            # permanently into others_loss_decrease and degenerates the
            # argmin eviction (reference memory.py:65-75). Attribute 0
            # instead, the same value its own len(prev_loss)==0 branch uses.
            loss_diff = float(np.mean((loss[:k] - prev_loss)[mask[:k]])) \
                if mask[:k].any() else 0.0
        else:
            loss_diff = 0.0
        old = np.asarray(self.others_loss_decrease, np.float64)
        difference = loss_diff - float(old[prev].mean()) / len(prev)
        # numpy fancy-index -= applies once per unique slot, matching
        # torch's index_put(accumulate=False) in the reference
        old[prev] -= (1 - ema_ratio) * difference
        self.others_loss_decrease = [float(x) for x in old]

    # -- sampling -----------------------------------------------------------
    def sample(self, batch_size: int) -> np.ndarray:
        """Random replay batch of dataset indices (MemoryBatchSampler,
        reference utils/memory.py:115-128). Samples with replacement when
        memory is smaller than the batch."""
        if not self.indices:
            return np.empty((0,), np.int64)
        replace = len(self.indices) < batch_size
        pick = self.rng.choice(len(self.indices), size=batch_size,
                               replace=replace)
        return np.asarray(self.indices, np.int64)[pick]

    def sample_with_slots(self, batch_size: int):
        """Like ``sample`` but also returns the memory slots drawn, for
        CLIB's trained-on attribution (``mark_used``)."""
        if not self.indices:
            return np.empty((0,), np.int64), np.empty((0,), np.int64)
        replace = len(self.indices) < batch_size
        pick = self.rng.choice(len(self.indices), size=batch_size,
                               replace=replace)
        return np.asarray(self.indices, np.int64)[pick], pick

    def class_balance_weights(self) -> np.ndarray:
        """Inverse-frequency weights per stored sample (memory.py:77-81)."""
        labels = np.asarray(self.labels)
        counts = np.bincount(labels)
        return 1.0 / counts[labels]

    def ordered_indices(self) -> np.ndarray:
        return np.asarray(self.indices, np.int64)

    # -- internals ----------------------------------------------------------
    def _append(self, sample_idx, label, loss=None):
        self.indices.append(int(sample_idx))
        self.labels.append(int(label))
        self.loss_history.append(float(loss) if loss is not None else 0.0)
        self.usage_count.append(0)

    def _replace(self, j, sample_idx, label, loss=None):
        self.indices[j] = int(sample_idx)
        self.labels[j] = int(label)
        self.loss_history[j] = float(loss) if loss is not None else 0.0
        self.usage_count[j] = 0

    # -- checkpoint state ----------------------------------------------------
    def state_dict(self):
        st = {"memory_size": self.memory_size,
              "indices": list(self.indices),
              "labels": list(self.labels),
              "seen": self.seen,
              "loss_history": list(self.loss_history),
              "others_loss_decrease": list(self.others_loss_decrease),
              "rng_state": self.rng.bit_generator.state}
        if hasattr(self, "_torch_gen"):  # RM eviction-draw stream (r4)
            st["torch_gen_state"] = np.asarray(
                self._torch_gen.get_state())
        return st

    def load_state_dict(self, st):
        self.memory_size = st["memory_size"]
        self.indices = list(st["indices"])
        self.labels = list(st["labels"])
        self.seen = st["seen"]
        self.loss_history = list(st["loss_history"])
        self.others_loss_decrease = list(
            st.get("others_loss_decrease", [0.0] * len(self.indices)))
        self.previous_slots = []
        self.usage_count = [0] * len(self.indices)
        self.rng.bit_generator.state = st["rng_state"]
        if st.get("torch_gen_state") is not None:
            import torch
            self._torch_gen = torch.Generator()
            self._torch_gen.set_state(
                torch.from_numpy(np.asarray(st["torch_gen_state"])))
