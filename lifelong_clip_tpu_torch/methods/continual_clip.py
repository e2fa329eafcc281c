"""Zero-shot frozen CLIP ("continual-clip").

Counterpart of ``lifelong_clip_tpu/methods/continual_clip.py`` (reference
``methods/continual_clip.py`` + ``models/continual_clip.py``): no training;
evaluation classifies against the text features of the exposed class names,
refreshed only when new classes appear. Both towers run forward only,
through the fused attention kernel. The trainer has no ``state``: the run
loop, the checkpoint and resume take it without one. Under a mesh eval's
rows split over the data axis (JAX ``:30-37``) and a model axis splits the
towers by heads on the ``"unfused"`` road, as the adapter family's.
"""

from __future__ import annotations

import torch

from ..config import PEFTConfig
from ..models import build_clip
from ..models.clip import cast_towers
from ..parallel.mesh import MODEL_AXIS, model_parallel
from .base import OnlineTrainer
from .engine import make_eval_step, make_text_feature_fn


class ContinualCLIP(OnlineTrainer):
    """Zero-shot CLIP; ``_attn_impl``: the towers' road
    (``models/clip.py``), ``"unfused"`` under a model axis."""

    _attn_impl = "fused"

    def setup_model(self):
        cfg = self.cfg
        params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=self.device)
        self.peft_cfg = PEFTConfig(method="none")
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        self._eval_dp_mesh = self.resolve_dp_mesh(cfg.test_batchsize,
                                                  allow_model_axis=True)
        tp = self.mesh is not None and self.mesh.shape[MODEL_AXIS] > 1
        if tp:
            self._attn_impl = "unfused"
        # the towers are never updated: cast them to the compute dtype once
        self.params = self.place_state(cast_towers(params,
                                                   self.compute_dtype))
        self._text_fn = make_text_feature_fn(
            self.clip_cfg, self.peft_cfg, compute_dtype=self.compute_dtype,
            attn_impl=self._attn_impl)
        self._eval_fn = make_eval_step(
            self.clip_cfg, self.peft_cfg, image_size=self.clip_cfg.image_size,
            mean=self.train_dataset.mean, std=self.train_dataset.std,
            compute_dtype=self.compute_dtype, attn_impl=self._attn_impl)
        self._txt_cache = None
        self._txt_cache_n = -1

    def online_step(self, images, labels, indices):
        # zero-shot: exposure tracking only (reference
        # methods/continual_clip.py:21-44 returns (-1, -1))
        return {}

    def prepare_eval(self):
        if self._txt_cache_n != len(self.vocab):
            with model_parallel(self.mesh):
                self._txt_cache = self._text_fn(
                    self.params, None, self._tensor(self.vocab.token_table))
            self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)
            self._txt_cache_n = len(self.vocab)

    def predict(self, images):
        with model_parallel(self.mesh):
            preds, _ = self._eval_fn(self.params, None, self._tensor(images),
                                     self._txt_cache, self._mask)
        return preds
