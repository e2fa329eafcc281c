"""PEFT parameter trees for the towers: LoRA.

Counterpart of ``lifelong_clip_tpu/models/peft.py`` (``init_lora``): per
block a fused-qkv LoRA (A and B xavier-uniform, reference
``models/clip/lora.py:437-455``) and an out-projection LoRA (A
kaiming-uniform, B zeros, ``lora.py:119-127``), layer-stacked. Adapter and
MoE trees are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import math

import torch

from ..config import CLIPConfig, PEFTConfig
from ..device import resolve_device


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) \
        * bound


def _kaiming_uniform(gen, shape, fan_in, a=math.sqrt(5)):
    gain = math.sqrt(2.0 / (1 + a * a))
    return _uniform(gen, shape, gain * math.sqrt(3.0 / fan_in))


def _xavier_uniform(gen, shape, fan_in, fan_out):
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def init_lora(gen: torch.Generator, layers: int, width: int, cfg: PEFTConfig):
    r = cfg.lora_r
    return {
        "a_in": _xavier_uniform(gen, (layers, width, r), width, r),
        "b_in": _xavier_uniform(gen, (layers, r, 3 * width), r, 3 * width),
        "a_out": _kaiming_uniform(gen, (layers, width, r), width),
        "b_out": torch.zeros(layers, r, width),
    }


def init_tower_peft(gen, layers: int, width: int, cfg: PEFTConfig):
    if cfg.method == "lora":
        return {"lora": init_lora(gen, layers, width, cfg)}
    if cfg.method in ("adapter", "moe"):
        raise NotImplementedError(
            f"{cfg.method} PEFT is not ported yet (ROADMAP.md, queue A)")
    raise ValueError(f"unknown tower PEFT method {cfg.method!r}")


def init_peft(gen, clip_cfg: CLIPConfig, cfg: PEFTConfig, device=None):
    """Returns {'vision': tree|None, 'text': tree|None} per PEFTConfig, on
    ``device`` (``None``: the GPU)."""
    device = resolve_device(device)

    def place(tree):
        return None if tree is None else {
            k: {n: a.to(device) for n, a in v.items()} for k, v in tree.items()}

    vision = (init_tower_peft(gen, clip_cfg.vision_layers,
                              clip_cfg.vision_width, cfg)
              if cfg.on_vision() else None)
    text = (init_tower_peft(gen, clip_cfg.text_layers, clip_cfg.text_width,
                            cfg)
            if cfg.on_text() else None)
    return {"vision": place(vision), "text": place(text)}
