"""Post-run zero-shot evaluation on held-out datasets.

Counterpart of ``lifelong_clip_tpu/methods/zero_shot_eval.py`` (reference
``--zero_shot_evaluation``, ``methods/_trainer.py:391-401`` +
``setup_zero_shot_dataset:175-193``): after the online run, classify other
datasets zero-shot by their class names through the trainer's towers, with
its trained PEFT trees where it has them. Under a mesh it runs as the
trainer's eval: rows split over the data axis with the predictions
all-gathered, a model axis on the ``"unfused"`` road, and rank 0 alone
appends to result.txt.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..data.registry import get_dataset
from ..models import clip as clip_fns
from ..ops import preprocess
from ..parallel.mesh import gather_rows, local_rows, model_parallel
from ..utils.metrics import per_class_counts
from ..utils.tokenizer import tokenize
from .base import pad_batch

log = logging.getLogger("lifelong_clip_tpu_torch")


@torch.no_grad()
def run_zero_shot_eval(trainer, dataset_names, *,
                       synthetic_fallback: bool = False,
                       template: str = "a bad photo of a {}."):
    """Evaluate the trainer's model zero-shot on each named dataset; append
    ``Dataset:{name} | test_acc:{acc:.4f}`` to its result.txt. Returns
    {name: accuracy}; a dataset that cannot be loaded is skipped with a
    warning."""
    state = getattr(trainer, "state", None)
    frozen = state.frozen if state is not None else trainer.params
    trainable = (state.trainable if state is not None else None) or {}
    cfg, peft_cfg = trainer.clip_cfg, trainer.peft_cfg
    dt = trainer.compute_dtype
    dp, mesh = trainer._eval_dp_mesh, trainer.mesh
    attn = getattr(trainer, "_attn_impl", "fused")

    results = {}
    for name in dataset_names:
        try:
            ds = get_dataset(name, trainer.cfg.data_dir, train=False,
                             synthetic_fallback=synthetic_fallback)
        except Exception as e:
            log.warning("zero-shot: skipping %s (%s)", name, e)
            continue
        tokens = tokenize([template.format(c) for c in ds.class_names])
        # text-side PEFT applies here too: the reference evaluates through
        # the adapted model (_trainer.py:391-401)
        with model_parallel(mesh):
            txt = clip_fns.normalize(clip_fns.encode_text(
                frozen, trainer._tensor(tokens, torch.int64), cfg,
                peft_cfg=peft_cfg if peft_cfg.on_text() else None,
                peft=trainable.get("text"), compute_dtype=dt,
                attn_impl=attn)).float()
        scale = torch.exp(frozen["logit_scale"]).float()
        pipeline = preprocess.make_eval_pipeline(cfg.image_size, ds.mean,
                                                 ds.std, out_dtype=dt)
        bs = trainer.cfg.test_batchsize
        correct = np.zeros((ds.n_classes,), np.int64)
        total = np.zeros((ds.n_classes,), np.int64)
        for lo in range(0, len(ds), bs):
            imgs, labels = ds.gather(np.arange(lo, min(lo + bs, len(ds))))
            # tail batches tile to the full batch shape
            imgs, _, n = pad_batch(imgs, labels, bs)
            with model_parallel(mesh):
                img = clip_fns.normalize(clip_fns.encode_image(
                    frozen, pipeline(trainer._tensor(local_rows(imgs, dp))),
                    cfg,
                    peft_cfg=peft_cfg if peft_cfg.on_vision() else None,
                    peft=trainable.get("vision"), compute_dtype=dt,
                    attn_impl=attn))
            preds = (scale * (img.float() @ txt.T)).argmax(-1)
            if dp is not None:
                preds = gather_rows(preds, dp)
            c, t = per_class_counts(preds[:n].cpu().numpy(), labels,
                                    ds.n_classes)
            correct += c
            total += t
        acc = float(correct.sum() / max(total.sum(), 1))
        results[name] = acc
        log.info("zero-shot %s: acc %.4f (%d samples)", name, acc,
                 int(total.sum()))
        if not trainer.is_main:
            continue
        with open(os.path.join(trainer.result_dir(), "result.txt"),
                  "a") as f:
            f.write(f"Dataset:{name} | test_acc:{acc:.4f}\n")
    return results
