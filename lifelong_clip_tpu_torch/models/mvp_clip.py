"""MVP on CLIP: mask and visual prompt pools, as functions of tensors.

Counterpart of ``lifelong_clip_tpu/models/mvp_clip.py`` (reference
``models/mvp_clip.py:CLIP_MVP``):

* frozen CLIP; learnables are a key pool (E, D), a per-prompt class mask
  (E, num_classes) initialised to -1, a shared g-prompt and a per-task
  e-prompt pool;
* the query is the CLS feature of a promptless pass without grad;
* e-prompt selection by the smallest cosine distance to the keys, scaled by
  the usage counts in contrastive mode; the count buffer is a device tensor
  updated by ``bincount``;
* g-prompts at layers (0, 1) x 5 tokens, the selected e-prompt at layers
  (2, 3, 4) x 20 tokens, realised as masked KV-prefix slots with
  ``prompt_ln=True``: on the fused road every layer of the prompted pass
  runs ``ops/fused_block_attn.py:fused_prefix_attention_block`` at P = 20;
* the head: cosine logits x logit_scale, the per-sample mask
  ``sigmoid(m) * 2``, and the similarity loss.

Randomness comes from an explicit ``torch.Generator``. Under a
data-parallel mesh (``dp``, JAX's ``dp_axis``) the contrastive term spans
the global batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CLIPConfig
from . import clip as clip_fns
from ..ops.attention import mm32
from ..parallel import mesh as mesh_lib

POS_G = (0, 1)
POS_E = (2, 3, 4)
LEN_G = 5
LEN_E = 20


def init_mvp_params(gen: torch.Generator, clip_cfg: CLIPConfig, *,
                    e_pool: int, num_classes: int, len_g: int = LEN_G,
                    len_e: int = LEN_E, device=None):
    """Learnable tree (reference ``__init__:82-104``): keys and prompts
    standard normal, the class mask -1; fp32 on ``device``."""
    d = clip_cfg.vision_width

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    return {
        "key": randn(e_pool, d),
        "mask": torch.full((e_pool, num_classes), -1.0, device=device),
        "g_prompts": randn(1, len(POS_G) * len_g, d),
        "e_prompts": randn(e_pool, len(POS_E) * len_e, d),
    }


def _cos(a, b, eps=1e-8):
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + eps)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + eps)
    return (a * b).sum(-1)


def _vit_prelude(frozen, images, cfg: CLIPConfig, compute_dtype):
    """The vision tower in ``compute_dtype`` and its token sequence before
    the blocks."""
    v = clip_fns.cast_tree(frozen["vision"], compute_dtype)
    return clip_fns.vit_embed(v, images, cfg, compute_dtype), v


def layer_prompts(slices, batch: int, layers: int, p_max: int, d: int,
                  dtype, device):
    """The padded (L, B, p_max, D) prompt tokens and the (L, p_max) valid
    mask from ``(layer, (B, n, D) tokens)`` slices; a later slice at a
    layer replaces an earlier one (JAX's ``.at[].set``), and positions
    beyond the tower's depth are dropped (small test towers)."""
    valid = np.zeros((layers, p_max), bool)
    rows = [torch.zeros(batch, p_max, d, dtype=dtype, device=device)
            for _ in range(layers)]
    for layer, val in slices:
        if layer >= layers:
            continue
        n = val.shape[1]
        pad = torch.zeros(batch, p_max - n, d, dtype=dtype, device=device)
        rows[layer] = torch.cat([val.to(dtype), pad], 1)
        valid[layer, :n] = True
    return torch.stack(rows), valid


def _layer_prompt_tensors(mvp, sel_e, batch: int, layers: int, len_g: int,
                          len_e: int, dtype, pos_g=POS_G, pos_e=POS_E):
    """``layer_prompts`` of the g slices at ``pos_g`` and the selected e
    slices at ``pos_e``."""
    d = mvp["g_prompts"].shape[-1]
    g = mvp["g_prompts"][0].reshape(len(pos_g), len_g, d)
    e = sel_e.reshape(batch, len(pos_e), len_e, d)
    slices = [(layer, g[i][None].expand(batch, len_g, d))
              for i, layer in enumerate(pos_g)]
    slices += [(layer, e[:, i]) for i, layer in enumerate(pos_e)]
    return layer_prompts(slices, batch, layers, max(len_g, len_e), d, dtype,
                         mvp["g_prompts"].device)


def mvp_features(frozen, mvp, count, images, cfg: CLIPConfig, *,
                 use_contrastiv: bool = False, use_last_layer: bool = True,
                 train: bool = True, query_ln: bool = True,
                 compute_dtype=torch.bfloat16, attn_impl: str = "fused",
                 dp=None):
    """Returns (image_feats, per-sample class mask, similarity_loss,
    new_count, selected idx), as the JAX function.

    ``query_ln``: apply the tower's final LN to the query CLS token
    (reference ``models/mvp_clip.py:218``). ``dp``: the data-parallel
    mesh of the step (JAX's ``dp_axis``): the contrastive term's count
    mass is all-gathered, so the (B, B) cross terms span the global batch,
    and ``pos`` and ``anchor`` are averaged over the data group before the
    log; ``new_count`` holds this rank's increments (the step sums
    them)."""
    x, v = _vit_prelude(frozen, images, cfg, compute_dtype)
    b = x.shape[0]

    # promptless query pass, no grad (reference forward_features:196-218)
    with torch.no_grad():
        q_blocks = v["blocks"] if use_last_layer else \
            clip_fns._all_but_last(v["blocks"])
        q = clip_fns.transformer(x, q_blocks, cfg.vision_heads, act=cfg.act,
                                 attn_impl=attn_impl, base_grads=False)
        query = clip_fns.layer_norm(q[:, :1], v["ln_post"])[:, 0] \
            if query_ln else q[:, 0]

    # e-prompt selection (reference :224-254)
    distance = 1.0 - _cos(query[:, None, :].float(), mvp["key"][None])
    mass = (count + 1.0) if use_contrastiv else torch.ones_like(count)
    idx = torch.argmin(distance * mass[None, :], dim=-1)
    sel_dist = distance.gather(1, idx[:, None])[:, 0]
    sel_e = mvp["e_prompts"][idx]
    sel_mask = mvp["mask"][idx]

    if use_contrastiv:
        key_dist = 1.0 - _cos(mvp["key"][:, None, :], mvp["key"][None])
        # the reference's broadcast quirk (mvp_clip.py:241-247): every
        # sample's distances are rescaled by every OTHER sample's count mass
        # too, and the mean runs over the (B, B) cross terms
        m = mass[idx]
        kd = key_dist[idx]
        if dp is not None:
            m = mesh_lib.gather_rows(m, dp)
        pos = torch.exp(kd[:, None, :] / m[None, :, None]).mean()
        anchor = torch.exp(sel_dist[:, None] / m[None, :]).mean()
        if dp is not None:
            pos, anchor = mesh_lib.mean_over(pos, dp), \
                mesh_lib.mean_over(anchor, dp)
        similarity_loss = -torch.log(pos / (anchor + pos) + 1e-6)
    else:
        similarity_loss = sel_dist.mean()

    new_count = count
    if train:
        new_count = count + torch.bincount(
            idx, minlength=count.shape[0]).to(count.dtype)

    vals, valid = _layer_prompt_tensors(mvp, sel_e, b, cfg.vision_layers,
                                        LEN_G, LEN_E, compute_dtype)
    h = clip_fns.transformer(x, v["blocks"], cfg.vision_heads,
                             layer_prompts=vals, layer_prompt_valid=valid,
                             prompt_ln=True, act=cfg.act,
                             attn_impl=attn_impl, base_grads=False)
    pooled = clip_fns.layer_norm(h[:, :1], v["ln_post"])[:, 0]
    img = mm32(pooled, v["proj"]).to(compute_dtype)
    cls_mask = torch.sigmoid(sel_mask.float()) * 2.0
    return img, cls_mask, similarity_loss, new_count, idx


def mvp_head(frozen, img_feats, txt_feats, cls_mask=None, class_mask=None,
             use_mask: bool = True):
    """Cosine head, the per-sample prompt mask and the exposure mask
    (reference ``forward_head:266-280`` and the trainer's masking)."""
    img = clip_fns.normalize(img_feats).float()
    txt = clip_fns.normalize(txt_feats).float()
    scale = torch.exp(frozen["logit_scale"]).float()
    logits = scale * mm32(img, txt.T)
    if use_mask and cls_mask is not None:
        logits = logits * cls_mask[:, :logits.shape[1]]
    if class_mask is not None:
        logits = logits + class_mask[None, :]
    return logits
