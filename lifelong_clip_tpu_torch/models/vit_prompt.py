"""Prompt pools of the ViT prompt-tuning family (L2P, DualPrompt).

Counterpart of ``lifelong_clip_tpu/models/vit_prompt.py`` (reference
``models/l2p.py``, ``models/dualprompt.py``): key-matched prompt selection
with the frequency-diversified score, and the two ways the selected prompts
enter the frozen vision tower:

* L2P splices them after the CLS token (``l2p_forward``): the prompted pass
  is the plain block at T = 1 + S * plen + N, so on the fused road its
  attention halves run ``ops/fused_block_attn.py:fused_ln_attention_block``;
* DualPrompt appends the g- and e-prompts per layer and truncates them
  (``dualprompt_forward``): masked KV-prefix slots with ``prompt_ln=True``,
  so every layer runs ``fused_prefix_attention_block``.

The backbone is the config's: on ``vit_base_patch16_224`` exact GELU, a bias
on the patch projection (when the weights have one) and no ln_pre, as
``models/clip.py:vit_embed`` reads the config.
"""

from __future__ import annotations

import torch

from ..config import CLIPConfig
from . import clip as clip_fns
from ..ops.attention import mm32
from .mvp_clip import _vit_prelude, layer_prompts


def init_prompt_pool(gen: torch.Generator, pool_size: int, prompt_len: int,
                     dim: int, device=None):
    """key (pool, D) and prompts (pool, plen, D) ~ U(-1, 1), fp32 (JAX
    ``:27``, reference l2p.py:51-56)."""
    def uniform(*shape):
        return (2.0 * torch.rand(*shape, generator=gen) - 1.0).to(device)

    return {"key": uniform(pool_size, dim),
            "prompts": uniform(pool_size, prompt_len, dim)}


def _unit(a, eps=1e-8):
    """``a / (norm(a) + eps)`` in a's dtype, rounded where
    ``jnp.linalg.norm`` rounds a bf16 array: the squares in bf16, their sum
    in fp32 and rounded once, the root in bf16."""
    n = (a * a).float().sum(-1, keepdim=True).to(a.dtype).sqrt()
    return a / (n + eps)


def top_k_indices(score, k: int):
    """Indices of the ``k`` largest entries of each row, ordered as
    ``jax.lax.top_k`` orders them: by value, equal values lowest index
    first (a stable sort; ``torch.topk`` promises no order among equal
    values)."""
    return torch.sort(score, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def pool_select(pool, query, frequency, selection_size: int, *,
                diversified: bool, train: bool):
    """Top-S key match, the smallest 1 - cos distance, scaled in training by
    the L1-normalized usage frequency when ``diversified`` (JAX ``:37``).
    Returns (similarity (B, S), selected prompts (B, S, plen, D), counts
    (pool,) fp32)."""
    match = 1.0 - mm32(_unit(query).float(), _unit(pool["key"]).float().T)
    if train and diversified:
        freq = frequency.float() / (frequency.float().sum() + 1e-8)
        score = match * freq[None, :]
    else:
        score = match
    topk = top_k_indices(-score, selection_size)
    sim = match.gather(1, topk)
    sel = pool["prompts"][topk]
    counts = torch.bincount(topk.reshape(-1),
                            minlength=pool["key"].shape[0]).float()
    return sim, sel, counts


def vit_query(frozen, images, cfg: CLIPConfig, compute_dtype,
              attn_impl: str = "fused"):
    """The frozen promptless CLS query, without grad (JAX ``:71``,
    reference l2p.py:145-150). Returns (query (B, D), the token sequence
    before the blocks, the vision tree in ``compute_dtype``)."""
    x, v = _vit_prelude(frozen, images, cfg, compute_dtype)
    with torch.no_grad():
        q = clip_fns.transformer(x, v["blocks"], cfg.vision_heads,
                                 act=cfg.act, attn_impl=attn_impl,
                                 base_grads=False)
        query = clip_fns.layer_norm(q[:, :1], v["ln_post"])[:, 0]
    return query, x, v


def _head(pooled, head):
    return mm32(pooled.float(), head["w"]) + head["b"].float()


def l2p_forward(frozen, trainable, images, cfg: CLIPConfig, *, frequency,
                selection_size: int, prompt_len: int, train: bool,
                diversified: bool = True, compute_dtype=torch.bfloat16,
                attn_impl: str = "fused"):
    """L2P (JAX ``:82``): the selected prompts plus ``pos_embed[0]``
    spliced after CLS; the head reads the mean of the prompt tokens'
    outputs. Returns (logits (B, C) fp32, mean similarity, counts)."""
    query, x, v = vit_query(frozen, images, cfg, compute_dtype, attn_impl)
    sim, sel, counts = pool_select(trainable["pool"], query, frequency,
                                   selection_size, diversified=diversified,
                                   train=train)
    b, n_p = x.shape[0], selection_size * prompt_len
    sp = sel.reshape(b, n_p, -1) + v["pos_embed"][:1].float()
    x = torch.cat([x[:, :1], sp.to(x.dtype), x[:, 1:]], 1)
    h = clip_fns.transformer(x, v["blocks"], cfg.vision_heads, act=cfg.act,
                             attn_impl=attn_impl, base_grads=False)
    h = clip_fns.layer_norm(h, v["ln_post"])
    # JAX's mean of a bf16 array accumulates in fp32 and rounds once
    pooled = h[:, 1:n_p + 1].float().mean(1).to(h.dtype)
    return _head(pooled, trainable["head"]), sim.mean(), counts


def dualprompt_forward(frozen, trainable, images, cfg: CLIPConfig, *,
                       e_frequency, pos_g, pos_e, len_g: int, len_e: int,
                       train: bool, compute_dtype=torch.bfloat16,
                       attn_impl: str = "fused"):
    """DualPrompt in prompt-tuning mode (JAX ``:107``): the g-prompt (a
    pool of one) at ``pos_g``, the query-selected e-prompt at ``pos_e``,
    each plus ``pos_embed[0]``, as masked KV-prefix slots through each
    block's ln_1 (``prompt_ln``); the head reads the CLS output. Returns
    (logits (B, C) fp32, e similarity, e counts)."""
    query, x, v = vit_query(frozen, images, cfg, compute_dtype, attn_impl)
    b, d = x.shape[0], x.shape[-1]
    _, g_sel, _ = pool_select(trainable["g_pool"], query,
                              torch.ones(1, device=x.device), 1,
                              diversified=False, train=train)
    sim, e_sel, counts = pool_select(trainable["e_pool"], query, e_frequency,
                                     1, diversified=False, train=train)
    pos0 = v["pos_embed"][:1].float()
    g = (g_sel.reshape(b, len(pos_g), len_g, d) + pos0).to(compute_dtype)
    e = (e_sel.reshape(b, len(pos_e), len_e, d) + pos0).to(compute_dtype)
    slices = [(layer, g[:, i]) for i, layer in enumerate(pos_g)]
    slices += [(layer, e[:, i]) for i, layer in enumerate(pos_e)]
    vals, valid = layer_prompts(slices, b, cfg.vision_layers,
                                max(len_g, len_e), d, compute_dtype, x.device)
    h = clip_fns.transformer(x, v["blocks"], cfg.vision_heads,
                             layer_prompts=vals, layer_prompt_valid=valid,
                             prompt_ln=True, act=cfg.act,
                             attn_impl=attn_impl, base_grads=False)
    pooled = clip_fns.layer_norm(h[:, :1], v["ln_post"])[:, 0]
    return _head(pooled, trainable["head"]), sim.mean(), counts
