"""Model registry: preset name or checkpoint -> (params, PEFT trees).

Counterpart of ``lifelong_clip_tpu/models/__init__.py``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ..config import CLIPConfig, PEFTConfig, resolve_clip_preset
from .init import init_clip_params, param_count  # noqa: F401
from .peft import init_peft

log = logging.getLogger("lifelong_clip_tpu_torch")


def build_clip(model_name: str = "ViT-B/16",
               pretrained_path: Optional[str] = None,
               gen: Optional[torch.Generator] = None, device=None):
    """CLIP params on ``device`` (``None``: the GPU): from the checkpoint at
    ``pretrained_path`` when that file exists (``models/convert.py``; the
    architecture is the checkpoint's), else a seeded init of the preset, as
    JAX ``build_clip`` (reference ``clip_loader.load`` minus the
    download)."""
    if pretrained_path and os.path.exists(pretrained_path):
        from .convert import load_clip_params
        return load_clip_params(pretrained_path, device=device)
    if pretrained_path:
        log.warning("no checkpoint at %s: random init of %s", pretrained_path,
                    model_name)
    cfg = resolve_clip_preset(model_name)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return init_clip_params(gen, cfg, device=device), cfg


def build_peft(gen: torch.Generator, clip_cfg: CLIPConfig,
               peft_cfg: PEFTConfig, device=None):
    if peft_cfg.method == "none":
        return {"vision": None, "text": None}
    return init_peft(gen, clip_cfg, peft_cfg, device=device)
