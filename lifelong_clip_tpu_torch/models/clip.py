"""CLIP image and text towers as functions of parameter dicts.

Counterpart of ``lifelong_clip_tpu/models/clip.py``: one block
implementation, with LoRA coming from an optional layer-stacked parameter
subtree; depth is a Python loop over the stacked layers (the JAX package
scans). Compute dtype policy as there: bf16 operands with fp32 LayerNorm,
softmax and accumulation (``_cast_tree``).

The attention half of every block goes through
``ops/fused_block_attn.py:fused_ln_attention_block`` (``attn_impl="fused"``,
the default; the JAX package's ``"pallas"``), whose CUDA kernels run on the
card and whose plain version runs on the CPU; ``attn_impl="unfused"`` (the
JAX ``"xla"`` road) composes LN and ``ops/attention.multi_head_attention``.
Adapter and MoE PEFT and KV-prefix prompts are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import CLIPConfig, PEFTConfig
from ..ops.attention import causal_mask, linear, mm32, multi_head_attention
from ..ops.fused_block_attn import fused_ln_attention_block

ATTN_IMPLS = ("fused", "unfused")


def layer_norm(x, p, eps: float = 1e-5):
    """LayerNorm computed in fp32 and cast back (reference model.py:194-200)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block(x, blk, n_heads: int, mask, peft_cfg: Optional[PEFTConfig], peft,
           attn_impl: str, act: str = "quick_gelu", base_grads: bool = True):
    """One residual attention block (vanilla or LoRA).

    ``base_grads=False`` asserts the block's own weights are frozen: the
    fused kernel's backward then skips their grads."""
    lora = None
    if peft is not None and peft_cfg is not None:
        if peft_cfg.method != "lora":
            raise NotImplementedError(
                f"{peft_cfg.method} PEFT blocks are not ported yet "
                "(ROADMAP.md, queue A)")
        lora = dict(peft["lora"], scaling=peft_cfg.lora_alpha / peft_cfg.lora_r)
    if attn_impl == "fused":
        arrays = None if lora is None else {
            k: lora[k] for k in ("a_in", "b_in", "a_out", "b_out")}
        y = fused_ln_attention_block(
            x, blk["ln_1"]["scale"], blk["ln_1"]["bias"],
            blk["attn"]["w_qkv"], blk["attn"]["b_qkv"],
            blk["attn"]["w_out"], blk["attn"]["b_out"], n_heads,
            float(lora["scaling"]) if lora is not None else 0.0, mask, arrays,
            base_grads)
    elif attn_impl == "unfused":
        h = layer_norm(x, blk["ln_1"])
        y = x + multi_head_attention(h, blk["attn"], n_heads, mask=mask,
                                     lora=lora)
    else:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    return _mlp_half(y, blk, act)


def _mlp_half(x, blk, act):
    """Second block half: x + MLP(LN2(x))."""
    h = layer_norm(x, blk["ln_2"])
    m = _ACTS[act](linear(h, blk["mlp"]["w_fc"], blk["mlp"]["b_fc"]))
    return x + linear(m, blk["mlp"]["w_proj"], blk["mlp"]["b_proj"])


def transformer(x, blocks, n_heads: int, *, mask=None,
                peft_cfg: Optional[PEFTConfig] = None, peft=None,
                attn_impl: str = "fused", act: str = "quick_gelu",
                base_grads: bool = True):
    """Run the layer-stacked residual blocks in order."""
    n_layers = blocks["attn"]["w_qkv"].shape[0]
    for i in range(n_layers):
        x = _block(x, _layer(blocks, i), n_heads, mask, peft_cfg,
                   _layer(peft, i), attn_impl, act, base_grads)
    return x


def cast_tree(tree, dtype):
    """fp32 leaves -> ``dtype`` (other leaves untouched, as ``_cast_tree``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def cast_towers(params, dtype):
    """Cast the frozen towers once (they are never updated); the logit scale
    stays fp32 as the JAX step reads it from the uncast tree."""
    return {k: cast_tree(v, dtype) if k in ("vision", "text") else v
            for k, v in params.items()}


def extract_patches(images, patch_size: int):
    """(B, H, W, 3) -> (B, N, P*P*3) patch vectors, flattened (ph, pw, c)."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def _no_prompts(layer_prompts):
    if layer_prompts is not None:
        raise NotImplementedError("KV-prefix prompts are not ported yet "
                                  "(ROADMAP.md, queues A and B)")


def encode_image(params, images, cfg: CLIPConfig, *,
                 peft_cfg: Optional[PEFTConfig] = None, peft=None,
                 layer_prompts=None, compute_dtype=torch.bfloat16,
                 attn_impl: str = "fused", base_grads: bool = True):
    """Vision tower. ``images``: (B, H, W, 3) normalized floats. Returns the
    projected CLS embedding (B, embed_dim) in ``compute_dtype``."""
    _no_prompts(layer_prompts)
    if cfg.tower != "vit":
        raise NotImplementedError("the ModifiedResNet tower is not ported "
                                  "yet (ROADMAP.md, queue A)")
    cd = compute_dtype
    v = cast_tree(params["vision"], cd)
    pv = cast_tree(peft, cd)
    x = extract_patches(images.to(cd), cfg.patch_size)
    x = mm32(x, v["patch_kernel"]).to(cd)
    if "patch_bias" in v:
        x = x + v["patch_bias"].to(cd)
    cls = v["class_embedding"].to(cd).expand(x.shape[0], 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    x = x + v["pos_embed"].to(cd)
    if cfg.use_ln_pre:
        x = layer_norm(x, v["ln_pre"])
    x = transformer(x, v["blocks"], cfg.vision_heads,
                    peft_cfg=peft_cfg if (peft_cfg and peft_cfg.on_vision())
                    else None,
                    peft=pv, attn_impl=attn_impl, act=cfg.act,
                    base_grads=base_grads)
    pooled = layer_norm(x[:, :1], v["ln_post"])[:, 0]
    return mm32(pooled, v["proj"]).to(cd)


def encode_text(params, tokens, cfg: CLIPConfig, *,
                peft_cfg: Optional[PEFTConfig] = None, peft=None,
                layer_prompts=None, compute_dtype=torch.bfloat16,
                attn_impl: str = "fused", base_grads: bool = True):
    """Text tower. ``tokens``: (B, context_length) integer ids. Pools at the
    EOT position (argmax of the ids, reference model.py:941-956)."""
    _no_prompts(layer_prompts)
    cd = compute_dtype
    t = cast_tree(params["text"], cd)
    pt = cast_tree(peft, cd)
    tokens = tokens.long()
    x = t["token_embedding"][tokens].to(cd)
    x = x + t["pos_embed"].to(cd)
    mask = causal_mask(cfg.context_length, device=x.device)
    x = transformer(x, t["blocks"], cfg.text_heads, mask=mask,
                    peft_cfg=peft_cfg if (peft_cfg and peft_cfg.on_text())
                    else None,
                    peft=pt, attn_impl=attn_impl, act=cfg.act,
                    base_grads=base_grads)
    x = layer_norm(x, t["ln_final"])
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return mm32(pooled, t["text_projection"]).to(cd)


def normalize(x, eps: float = 1e-8):
    x32 = x.float()
    return (x32 / (torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
                   + eps)).to(x.dtype)
