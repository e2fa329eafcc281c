"""MaPLe: multi-modal prompt learning over the CLIP towers.

Counterpart of ``lifelong_clip_tpu/models/maple.py`` (reference
``models/maple.py`` and the MaPLe blocks of ``models/maple_clip/model.py``):

* text side: token embeddings at positions 1..1+n_ctx replaced by a
  learnable ctx (initialised from the embeddings of "a bad photo of a"); at
  layers 1..depth-1 those positions are replaced again by per-depth compound
  prompts;
* vision side: n_ctx visual ctx tokens (a linear projection of the text
  ctx, text width -> vision width) appended at the tail of the sequence
  before ``ln_pre``, and replaced at layers 1..depth-1 by projections of the
  compound prompts;
* every compound projection starts from one shared initialisation.

The depth loop is a Python loop over the layer-stacked blocks (the JAX
package scans with the replacement as per-layer data). Each block runs
through ``models/clip.py:_block`` with no PEFT and ``base_grads=False``: on
the fused road the vision tower (T = 1 + patches + n_ctx) and the text tower
(causal, T = context length) take ``fused_ln_attention_block``. Randomness
comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from ..config import CLIPConfig
from ..ops.attention import causal_mask, mm32
from . import clip as clip_fns


def init_maple_params(gen: torch.Generator, frozen, clip_cfg: CLIPConfig,
                      n_ctx: int = 3, depth: int = 3, ctx_init_tokens=None,
                      device=None):
    """The MultiModalPromptLearner tree, fp32 on ``device``.

    ``ctx_init_tokens``: int token ids of the init phrase; ctx starts from
    their embeddings in ``frozen`` (reference maple.py:93-101). Linear
    layers take torch ``nn.Linear``'s default init; the compound projections
    share one, tiled over depth - 1 (reference ``_get_clones``)."""
    tw, vw = clip_cfg.text_width, clip_cfg.vision_width
    emb = frozen["text"]["token_embedding"]
    device = emb.device if device is None else device
    if ctx_init_tokens is not None and len(ctx_init_tokens) >= n_ctx:
        ctx = emb[torch.as_tensor(list(ctx_init_tokens[:n_ctx]),
                                  device=emb.device)].float().clone()
    else:
        ctx = 0.02 * torch.randn(n_ctx, tw, generator=gen)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    def linear_init(fan_in, fan_out):
        # kaiming-uniform(a=sqrt 5) weight, uniform bias
        w = uniform((fan_in, fan_out), math.sqrt(6.0 / fan_in) / math.sqrt(2.0))
        return w, uniform((fan_out,), 1.0 / math.sqrt(fan_in))

    proj_w, proj_b = linear_init(tw, vw)
    cw, cb = linear_init(tw, vw)
    d = max(depth - 1, 0)
    compound_text = 0.02 * torch.randn(d, n_ctx, tw, generator=gen)
    tree = {"ctx": ctx, "proj_w": proj_w, "proj_b": proj_b,
            "compound_text": compound_text,
            "compound_proj_w": cw[None].repeat(d, 1, 1),
            "compound_proj_b": cb[None].repeat(d, 1)}
    return {k: v.to(device=device, dtype=torch.float32).contiguous()
            for k, v in tree.items()}


def _replacement_arrays(layers: int, prompts, n_ctx: int, dim: int, dtype):
    """(depth - 1, n_ctx, D) prompts -> per-layer values (L, n_ctx, D) and
    flags (L,): layer i in 1..depth-1 is replaced by prompts[i - 1]. Prompt
    depth beyond the tower is dropped (shallow test towers)."""
    d = min(prompts.shape[0], layers - 1)
    zero = torch.zeros(n_ctx, dim, dtype=dtype, device=prompts.device)
    rows = [zero] + [prompts[i].to(dtype) for i in range(max(d, 0))]
    rows += [zero] * (layers - len(rows))
    flags = [0 < i <= d for i in range(layers)]
    return torch.stack(rows), flags


def _scan_with_replacement(x, blocks, n_heads, mask, replace, n_ctx,
                           where: str, attn_impl: str = "fused"):
    """Run the blocks in order; before a flagged layer replace the prompt
    token positions: ``where="tail"`` the last n_ctx tokens (vision),
    ``"post_sos"`` tokens 1..1+n_ctx (text). Layer 0 is never flagged. The
    learner's grads reach the replaced positions through dx; the frozen
    blocks get none."""
    vals, flags = replace
    for i, flag in enumerate(flags):
        if flag:
            rep = vals[i][None].expand(x.shape[0], *vals.shape[1:]).to(
                x.dtype)
            if where == "tail":
                x = torch.cat([x[:, :-n_ctx], rep], 1)
            else:
                x = torch.cat([x[:, :1], rep, x[:, 1 + n_ctx:]], 1)
        x = clip_fns._block(x, clip_fns._layer(blocks, i), n_heads, mask,
                            None, None, attn_impl, base_grads=False)
    return x


def maple_encode_text(frozen, learner, tokens, clip_cfg: CLIPConfig,
                      n_ctx: int, compute_dtype=torch.bfloat16,
                      attn_impl: str = "fused"):
    """Text tower with the ctx spliced at 1..1+n_ctx and the compound
    replacement. ``tokens`` embed the init phrase at those positions, so
    EOT argmax pooling is unchanged."""
    cd = compute_dtype
    t = clip_fns.cast_tree(frozen["text"], cd)
    tokens = tokens.long()
    x = t["token_embedding"][tokens].to(cd)
    ctx = learner["ctx"].to(cd)[None].expand(x.shape[0], n_ctx, x.shape[-1])
    x = torch.cat([x[:, :1], ctx, x[:, 1 + n_ctx:]], 1)
    x = x + t["pos_embed"].to(cd)
    mask = causal_mask(clip_cfg.context_length, device=x.device)
    replace = _replacement_arrays(clip_cfg.text_layers,
                                  learner["compound_text"], n_ctx,
                                  clip_cfg.text_width, cd)
    x = _scan_with_replacement(x, t["blocks"], clip_cfg.text_heads, mask,
                               replace, n_ctx, "post_sos", attn_impl)
    x = clip_fns.layer_norm(x, t["ln_final"])
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return mm32(pooled, t["text_projection"]).to(cd)


def maple_encode_image(frozen, learner, images, clip_cfg: CLIPConfig,
                       n_ctx: int, compute_dtype=torch.bfloat16,
                       attn_impl: str = "fused"):
    """Vision tower with the visual ctx appended before ``ln_pre`` and the
    deep prompts replacing it per layer; both projections in fp32."""
    cd = compute_dtype
    v = clip_fns.cast_tree(frozen["vision"], cd)
    x = clip_fns.extract_patches(images.to(cd), clip_cfg.patch_size)
    x = mm32(x, v["patch_kernel"]).to(cd)
    cls = v["class_embedding"].to(cd).expand(x.shape[0], 1,
                                             clip_cfg.vision_width)
    x = torch.cat([cls, x], 1) + v["pos_embed"].to(cd)
    visual_ctx = mm32(learner["ctx"], learner["proj_w"]) + learner["proj_b"]
    visual_ctx = visual_ctx.to(cd)[None].expand(x.shape[0], n_ctx,
                                                clip_cfg.vision_width)
    x = clip_fns.layer_norm(torch.cat([x, visual_ctx], 1), v["ln_pre"])
    deep_visual = mm32(learner["compound_text"], learner["compound_proj_w"]) \
        + learner["compound_proj_b"][:, None, :]
    replace = _replacement_arrays(clip_cfg.vision_layers, deep_visual, n_ctx,
                                  clip_cfg.vision_width, cd)
    x = _scan_with_replacement(x, v["blocks"], clip_cfg.vision_heads, None,
                               replace, n_ctx, "tail", attn_impl)
    pooled = clip_fns.layer_norm(x[:, :1], v["ln_post"])[:, 0]
    return mm32(pooled, v["proj"]).to(cd)


def maple_forward(frozen, learner, images, tokens, clip_cfg: CLIPConfig,
                  n_ctx: int, compute_dtype=torch.bfloat16,
                  attn_impl: str = "fused"):
    """Both towers: (logits (B, C) fp32, image feats, text feats)."""
    img = clip_fns.normalize(maple_encode_image(
        frozen, learner, images, clip_cfg, n_ctx, compute_dtype, attn_impl))
    txt = clip_fns.normalize(maple_encode_text(
        frozen, learner, tokens, clip_cfg, n_ctx, compute_dtype, attn_impl))
    scale = torch.exp(frozen["logit_scale"]).float()
    return scale * mm32(img, txt.T), img, txt
