"""Model registry: preset name -> (params, PEFT trees).

Counterpart of ``lifelong_clip_tpu/models/__init__.py``. Loading a
pretrained checkpoint (``models/convert.py``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import CLIPConfig, PEFTConfig, resolve_clip_preset
from .init import init_clip_params, param_count  # noqa: F401
from .peft import init_peft


def build_clip(model_name: str = "ViT-B/16",
               pretrained_path: Optional[str] = None,
               gen: Optional[torch.Generator] = None, device=None):
    """Seeded-init CLIP params for a preset, on ``device`` (``None``: the
    GPU)."""
    if pretrained_path:
        raise NotImplementedError(
            "pretrained checkpoints (models/convert.py) are not ported yet "
            "(ROADMAP.md, queue A)")
    cfg = resolve_clip_preset(model_name)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return init_clip_params(gen, cfg, device=device), cfg


def build_peft(gen: torch.Generator, clip_cfg: CLIPConfig,
               peft_cfg: PEFTConfig, device=None):
    if peft_cfg.method == "none":
        return {"vision": None, "text": None}
    return init_peft(gen, clip_cfg, peft_cfg, device=device)
