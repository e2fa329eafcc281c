"""Read an OpenAI CLIP checkpoint into the port's parameter layout.

Counterpart of ``lifelong_clip_tpu/models/convert.py`` (reference loader
``models/clip/clip_loader.py:83-139`` + ``build_model``,
``models/clip/model.py:1005-1062``): accept a TorchScript archive or a plain
state dict, infer the architecture from the tensors' shapes, and produce
the layer-stacked parameter dicts of ``models/init.py``. The file is read
on the CPU and the result moved to the requested device. Nothing is
downloaded: the checkpoint must be on disk (``--pretrained_path``).

Both of the reference's branches are ported: ViT checkpoints, and
ModifiedResNet ones (RN50 ...) whose vision tree ``resnet.py`` reads
(``rn_state_dict_to_vision``); ``timm_vit_to_params`` reads a timm ViT
state dict (the vit-prompt methods' backbone) into the vision tree as a
library function, as in JAX, where no main path calls it.
"""

from __future__ import annotations

import zipfile

import torch

from ..config import CLIPConfig
from ..device import resolve_device
from .resnet import rn_state_dict_to_vision
from .resnet import tree_to as _to


def _load_state_dict(path: str):
    """str -> fp32 CPU tensor. A TorchScript archive is loaded as a module
    and its ``state_dict`` taken; a plain file as tensors only."""
    obj = (torch.jit.load(path, map_location="cpu").state_dict()
           if _is_jit_archive(path)
           else torch.load(path, map_location="cpu", weights_only=True))
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.float() for k, v in obj.items()}


def _is_jit_archive(path: str) -> bool:
    try:
        with zipfile.ZipFile(path) as zf:
            return any(n.endswith("constants.pkl") for n in zf.namelist())
    except (zipfile.BadZipFile, OSError):
        return False


def infer_config(sd) -> CLIPConfig:
    """Shape-driven architecture inference (reference model.py:1005-1044).

    ViT checkpoints are identified by ``visual.proj`` (``build_model:1006``);
    otherwise the ModifiedResNet branch reads the stage depths from the
    ``visual.layerN`` key families (``:1019-1033``)."""
    text_width = sd["ln_final.weight"].shape[0]
    text_kw = dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=len({k.split(".")[2] for k in sd
                         if k.startswith("transformer.resblocks")}),
    )
    if "visual.proj" not in sd:   # ModifiedResNet
        width = sd["visual.layer1.0.conv1.weight"].shape[0]
        grid = int(round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
        return CLIPConfig(
            image_size=grid * 32,
            patch_size=32,   # unused by the tower; keeps grid_size defined
            vision_width=width,
            vision_layers=tuple(
                len({k.split(".")[2] for k in sd
                     if k.startswith(f"visual.layer{b}.")})
                for b in (1, 2, 3, 4)),
            vision_heads=width * 32 // 64,
            tower="rn",
            **text_kw)
    vision_width = sd["visual.conv1.weight"].shape[0]
    patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    return CLIPConfig(
        image_size=grid * patch_size,
        patch_size=patch_size,
        vision_width=vision_width,
        # layer index is the 4th component: visual.transformer.resblocks.N
        vision_layers=len({k.split(".")[3] for k in sd
                           if k.startswith("visual.transformer.resblocks")}),
        vision_heads=vision_width // 64,
        **text_kw)


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


# (tree path, state-dict suffix, transposed): torch's Linear weights are
# (out, in) acting as x @ W.T; the port keeps x @ W
_BLOCK_KEYS = (
    (("ln_1", "scale"), "ln_1.weight", False),
    (("ln_1", "bias"), "ln_1.bias", False),
    (("attn", "w_qkv"), "attn.in_proj_weight", True),
    (("attn", "b_qkv"), "attn.in_proj_bias", False),
    (("attn", "w_out"), "attn.out_proj.weight", True),
    (("attn", "b_out"), "attn.out_proj.bias", False),
    (("ln_2", "scale"), "ln_2.weight", False),
    (("ln_2", "bias"), "ln_2.bias", False),
    (("mlp", "w_fc"), "mlp.c_fc.weight", True),
    (("mlp", "b_fc"), "mlp.c_fc.bias", False),
    (("mlp", "w_proj"), "mlp.c_proj.weight", True),
    (("mlp", "b_proj"), "mlp.c_proj.bias", False),
)


def _stack_blocks(sd, prefix: str, layers: int):
    out = {}
    for (group, name), suffix, transposed in _BLOCK_KEYS:
        per_layer = [sd[f"{prefix}.resblocks.{i}.{suffix}"]
                     for i in range(layers)]
        out.setdefault(group, {})[name] = torch.stack(
            [a.T if transposed else a for a in per_layer])
    return out


def _text_params(sd, cfg: CLIPConfig):
    return {
        "token_embedding": sd["token_embedding.weight"],
        "pos_embed": sd["positional_embedding"],
        "blocks": _stack_blocks(sd, "transformer", cfg.text_layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }


def state_dict_to_params(sd, cfg: CLIPConfig = None, device=None):
    """Returns (params, cfg) on ``device`` (``None``: the GPU). ``sd``: str
    -> fp32 tensor state dict of an OpenAI CLIP ViT or ModifiedResNet."""
    cfg = cfg or infer_config(sd)
    if cfg.tower == "rn":
        params = {"vision": rn_state_dict_to_vision(sd),
                  "text": _text_params(sd, cfg),
                  "logit_scale": sd["logit_scale"].reshape(())}
        return _to(params, resolve_device(device)), cfg
    conv = sd["visual.conv1.weight"]  # (W, 3, P, P)
    # the patch vectors are flattened (ph, pw, c): reorder the kernel to match
    params = {
        "vision": {
            "patch_kernel": conv.permute(2, 3, 1, 0).reshape(
                -1, conv.shape[0]),
            "class_embedding": sd["visual.class_embedding"],
            "pos_embed": sd["visual.positional_embedding"],
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _stack_blocks(sd, "visual.transformer",
                                    cfg.vision_layers),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": sd["visual.proj"],
        },
        "text": _text_params(sd, cfg),
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    return _to(params, resolve_device(device)), cfg


def load_clip_params(path: str, device=None):
    """Checkpoint file -> (params on ``device``, cfg)."""
    return state_dict_to_params(_load_state_dict(path), device=device)


# (tree path, timm suffix, transposed) of a timm ViT block
_TIMM_BLOCK_KEYS = (
    (("ln_1", "scale"), "norm1.weight", False),
    (("ln_1", "bias"), "norm1.bias", False),
    (("attn", "w_qkv"), "attn.qkv.weight", True),
    (("attn", "b_qkv"), "attn.qkv.bias", False),
    (("attn", "w_out"), "attn.proj.weight", True),
    (("attn", "b_out"), "attn.proj.bias", False),
    (("ln_2", "scale"), "norm2.weight", False),
    (("ln_2", "bias"), "norm2.bias", False),
    (("mlp", "w_fc"), "mlp.fc1.weight", True),
    (("mlp", "b_fc"), "mlp.fc1.bias", False),
    (("mlp", "w_proj"), "mlp.fc2.weight", True),
    (("mlp", "b_proj"), "mlp.fc2.bias", False),
)


def timm_vit_to_params(sd, cfg: CLIPConfig = None, device=None):
    """A timm ViT state dict (``blocks.N.attn.qkv.weight`` ...; str -> fp32
    tensor) -> ``({'vision', 'logit_scale'}, cfg, head)`` on ``device``
    (JAX ``convert.py:175-240``; the reference's L2P/DualPrompt/MVP
    backbone, ``vit_base_patch16_224``). The qkv, proj and fc weights are
    transposed to ``x @ W``; the patch projection's bias becomes
    ``patch_bias``; ``ln_pre`` and ``proj`` are identities (timm has
    neither; ``cfg.use_ln_pre`` is False); the classifier head
    (``head.weight/bias``) comes back separately as ``{'w' (D, C), 'b'}``,
    or None. Without ``cfg`` it is inferred with exact GELU and no
    ln_pre."""
    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    width = sd["cls_token"].shape[-1]
    conv = sd["patch_embed.proj.weight"]     # (W, 3, P, P)
    if cfg is None:
        grid = int(round((sd["pos_embed"].shape[-2] - 1) ** 0.5))
        cfg = CLIPConfig(embed_dim=width, vision_width=width,
                         vision_layers=layers, vision_heads=width // 64,
                         patch_size=conv.shape[-1],
                         image_size=grid * conv.shape[-1], act="gelu",
                         use_ln_pre=False)
    blocks = {}
    for (group, name), suffix, transposed in _TIMM_BLOCK_KEYS:
        per_layer = [sd[f"blocks.{i}.{suffix}"] for i in range(layers)]
        blocks.setdefault(group, {})[name] = torch.stack(
            [a.T if transposed else a for a in per_layer])
    pos = sd["pos_embed"]
    vision = {
        "patch_kernel": conv.permute(2, 3, 1, 0).reshape(-1, width),
        **({"patch_bias": sd["patch_embed.proj.bias"]}
           if "patch_embed.proj.bias" in sd else {}),
        "class_embedding": sd["cls_token"].reshape(-1),
        "pos_embed": pos[0] if pos.dim() == 3 else pos,
        "ln_pre": {"scale": torch.ones(width), "bias": torch.zeros(width)},
        "blocks": blocks,
        "ln_post": _ln(sd, "norm"),
        "proj": torch.eye(width),
    }
    head = None
    if "head.weight" in sd:
        head = _to({"w": sd["head.weight"].T, "b": sd["head.bias"]},
                   resolve_device(device))
    params = {"vision": vision, "logit_scale": torch.tensor(0.0)}
    return _to(params, resolve_device(device)), cfg, head
