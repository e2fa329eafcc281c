"""Dynamic class vocabulary with jit-stable fixed-capacity buffers.

The hardest impedance mismatch between online CL and XLA (SURVEY §7 hard
part 1): the exposed class set grows as the stream reveals classes
(reference ``_trainer.add_new_class``, ``methods/_trainer.py:404-416``),
but jitted programs need static shapes. This module keeps a padded
``(max_classes, context_length)`` token table + validity mask; logits are
computed against the full table and masked with -inf on unexposed slots
(the trick the reference already uses for MVP, ``methods/mvp_clip.py:47``).

Tokenization happens once per class on first exposure — killing the
reference's per-step re-tokenization of every class name
(``models/adapter_clip.py:102-104``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .tokenizer import CONTEXT_LENGTH, tokenize


class ClassVocabulary:
    """Tracks exposed classes; owns the padded class-token table."""

    def __init__(self,
                 all_class_names: Sequence[str],
                 max_classes: int = 0,
                 template: str = "a bad photo of a {}.",
                 context_length: int = CONTEXT_LENGTH):
        self.all_class_names = list(all_class_names)
        self.max_classes = max_classes or len(self.all_class_names)
        self.template = template
        self.context_length = context_length

        self.exposed: List[int] = []              # global class ids, order
        self._pos = {}                            # global id -> slot
        self.token_table = np.zeros((self.max_classes, context_length),
                                    np.int32)
        self.exposed_mask = np.zeros((self.max_classes,), bool)

    def __len__(self):
        return len(self.exposed)

    @property
    def exposed_names(self) -> List[str]:
        return [self.all_class_names[c] for c in self.exposed]

    def expose(self, labels: Sequence[int]) -> bool:
        """Register newly seen global class ids; returns True if any new."""
        new = False
        for y in np.asarray(labels).ravel():  # order-preserving (slot order
            y = int(y)                        # = first-exposure order)
            if y not in self._pos:
                slot = len(self.exposed)
                if slot >= self.max_classes:
                    raise RuntimeError("max_classes capacity exceeded")
                self._pos[y] = slot
                self.exposed.append(y)
                text = self.template.format(self.all_class_names[y])
                self.token_table[slot] = tokenize(
                    [text], self.context_length)[0]
                self.exposed_mask[slot] = True
                new = True
        return new

    def max_token_pos(self) -> int:
        """Largest EOT position any class in this vocabulary can produce
        (tokenizes every known class name through the template, once).
        Static per run — lets jitted consumers slice sequences to the
        shortest length that still covers every pooled position."""
        if not hasattr(self, "_max_token_pos"):
            toks = tokenize(
                [self.template.format(n) for n in self.all_class_names],
                self.context_length)
            self._max_token_pos = int(np.asarray(toks).argmax(-1).max())
        return self._max_token_pos

    def remap(self, labels: Sequence[int]) -> np.ndarray:
        """Global class ids -> exposed slot ids (vectorized gather; replaces
        the per-element Python loop at reference adapter_clip.py:75-76)."""
        lut = np.full((max(self._pos, default=0) + 1,), -1, np.int64)
        for g, s in self._pos.items():
            lut[g] = s
        return lut[np.asarray(labels)]

    def logit_mask(self) -> np.ndarray:
        """(max_classes,) additive mask: 0 on exposed slots, -inf on pads."""
        return np.where(self.exposed_mask, 0.0, -np.inf).astype(np.float32)

    def batch_table(self, batch_labels: Sequence[int], capacity: int):
        """Batch-visible class view (``--visible_classes batch``,
        reference methods/adapter_clip.py:53-61).

        Returns (tokens (capacity, ctx), mask (capacity,), remapped labels
        into the batch-local list, exposed-slot ids per batch slot
        (capacity,) with -1 padding — for consumers indexed in exposure
        order, e.g. MVP's per-prompt class mask). Classes are ordered by
        first occurrence in the exposed list for determinism.
        """
        uniq = sorted({int(y) for y in np.asarray(batch_labels)},
                      key=lambda y: self._pos[y])
        if len(uniq) > capacity:
            raise RuntimeError(
                f"batch has {len(uniq)} classes > capacity {capacity}")
        tokens = np.zeros((capacity, self.context_length), np.int32)
        mask = np.full((capacity,), -np.inf, np.float32)
        exposed_slots = np.full((capacity,), -1, np.int64)
        local = {}
        for i, y in enumerate(uniq):
            tokens[i] = self.token_table[self._pos[y]]
            mask[i] = 0.0
            exposed_slots[i] = self._pos[y]
            local[y] = i
        labels = np.asarray([local[int(y)] for y in
                             np.asarray(batch_labels)], np.int64)
        return tokens, mask, labels, exposed_slots

    # -- checkpoint state ----------------------------------------------------
    def state_dict(self):
        return {"exposed": list(self.exposed)}

    def load_state_dict(self, st):
        self.exposed = []
        self._pos = {}
        self.token_table[:] = 0
        self.exposed_mask[:] = False
        self.expose(st["exposed"])
