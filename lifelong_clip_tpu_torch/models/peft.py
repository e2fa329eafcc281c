"""PEFT parameter trees for the towers: LoRA, bottleneck adapters, MoE.

Counterpart of ``lifelong_clip_tpu/models/peft.py``, layer-stacked as
there: per block a fused-qkv LoRA (A and B xavier-uniform, reference
``models/clip/lora.py:437-455``) and an out-projection LoRA (A
kaiming-uniform, B zeros, ``lora.py:119-127``); a bottleneck adapter
(``w_down`` (L, D, k) kaiming-uniform, ``b_down`` (L, k), ``w_up`` (L, k, D)
and ``b_up`` (L, D) zeros; reference ``models/clip/adapter.py:36-50``); or a
noisy-top-k mixture of such adapters (``router`` and ``w_noise`` (L, D, E)
zeros, the experts' leaves stacked on axis 1, (L, E, ...); reference
``_MoA``, ``model.py:445-636``).
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


def init_adapter(gen: torch.Generator, layers: int, width: int,
                 cfg: PEFTConfig):
    """Bottleneck adapter per block: down kaiming-uniform, up and biases
    zeros; the fixed ``adapter_scale`` is applied in the forward."""
    k = cfg.adapter_dim
    return {
        "w_down": _kaiming_uniform(gen, (layers, width, k), width),
        "b_down": torch.zeros(layers, k),
        "w_up": torch.zeros(layers, k, width),
        "b_up": torch.zeros(layers, width),
    }


def init_moe(gen: torch.Generator, layers: int, width: int, cfg: PEFTConfig):
    """Noisy-top-k mixture of ``moe_experts`` adapters: router and noise
    weights zeros, each expert as ``init_adapter``."""
    e = cfg.moe_experts
    experts = [init_adapter(gen, layers, width, cfg) for _ in range(e)]
    return {
        "router": torch.zeros(layers, width, e),
        "w_noise": torch.zeros(layers, width, e),
        "experts": {k: torch.stack([x[k] for x in experts], dim=1)
                    for k in experts[0]},   # each leaf (layers, experts, ...)
    }


def init_tower_peft(gen, layers: int, width: int, cfg: PEFTConfig):
    if cfg.method == "lora":
        return {"lora": init_lora(gen, layers, width, cfg)}
    if cfg.method == "adapter":
        return {"adapter": init_adapter(gen, layers, width, cfg)}
    if cfg.method == "moe":
        return {"moe": init_moe(gen, layers, width, cfg)}
    raise ValueError(f"unknown tower PEFT method {cfg.method!r}")


def init_peft(gen, clip_cfg: CLIPConfig, cfg: PEFTConfig, device=None):
    """Returns {'vision': tree|None, 'text': tree|None} per PEFTConfig, on
    ``device`` (``None``: the GPU)."""
    device = resolve_device(device)

    def place(tree):
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        return None if tree is None else tree.to(device)

    vision = (init_tower_peft(gen, clip_cfg.vision_layers,
                              clip_cfg.vision_width, cfg)
              if cfg.on_vision() else None)
    text = (init_tower_peft(gen, clip_cfg.text_layers, clip_cfg.text_width,
                            cfg)
            if cfg.on_text() else None)
    return {"vision": place(vision), "text": place(text)}
