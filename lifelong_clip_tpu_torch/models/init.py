"""Seeded parameter initialization for the CLIP towers.

Counterpart of ``lifelong_clip_tpu/models/init.py``: the OpenAI CLIP scheme
(per-depth scaled normals) in the same layer-stacked layout, drawn from a
``torch.Generator``. The draws differ from ``jax.random``'s; tests that need
equal weights go through ``bridge.params_from_numpy`` instead.
"""

from __future__ import annotations

import math

import torch

from ..config import CLIPConfig
from ..device import resolve_device
from .resnet import init_rn_params


def _normal(gen, shape, std):
    return std * torch.randn(shape, generator=gen, dtype=torch.float32)


def _ln(*shape):
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def _blocks(gen, layers: int, width: int):
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    return {
        "ln_1": _ln(layers, width),
        "attn": {
            "w_qkv": _normal(gen, (layers, width, 3 * width), attn_std),
            "b_qkv": torch.zeros(layers, 3 * width),
            "w_out": _normal(gen, (layers, width, width), proj_std),
            "b_out": torch.zeros(layers, width),
        },
        "ln_2": _ln(layers, width),
        "mlp": {
            "w_fc": _normal(gen, (layers, width, 4 * width), fc_std),
            "b_fc": torch.zeros(layers, 4 * width),
            "w_proj": _normal(gen, (layers, 4 * width, width), proj_std),
            "b_proj": torch.zeros(layers, width),
        },
    }


def _text_tree(gen, cfg: CLIPConfig):
    tw = cfg.text_width
    return {
        "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02),
        "pos_embed": _normal(gen, (cfg.context_length, tw), 0.01),
        "blocks": _blocks(gen, cfg.text_layers, tw),
        "ln_final": _ln(tw),
        "text_projection": _normal(gen, (tw, cfg.embed_dim), tw ** -0.5),
    }


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig, device=None):
    """Seeded params on ``device`` (``None``: the GPU); ``cfg.tower ==
    "rn"`` draws a ModifiedResNet vision tree (``resnet.init_rn_params``)."""
    if cfg.tower == "rn":
        return {"vision": init_rn_params(gen, cfg, device=device),
                **_to({"text": _text_tree(gen, cfg),
                       "logit_scale": torch.tensor(math.log(1.0 / 0.07))},
                      resolve_device(device))}
    vw = cfg.vision_width
    vscale = vw ** -0.5
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    params = {
        "vision": {
            "patch_kernel": _normal(gen, (patch_dim, vw), vscale),
            "class_embedding": _normal(gen, (vw,), vscale),
            "pos_embed": _normal(gen, (cfg.vision_seq_len, vw), vscale),
            "ln_pre": _ln(vw),
            "blocks": _blocks(gen, cfg.vision_layers, vw),
            "ln_post": _ln(vw),
            "proj": _normal(gen, (vw, cfg.embed_dim), vscale),
        },
        "text": _text_tree(gen, cfg),
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32),
    }
    return _to(params, resolve_device(device))


def param_count(tree) -> int:
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_count(v) for v in tree)
    return tree.numel()
