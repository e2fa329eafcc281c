"""ProtoCLIP: prompt-pool CLIP with CoPL visual prompts, as functions of
tensors.

Counterpart of ``lifelong_clip_tpu/models/proto_clip.py`` (reference
``models/proto_clip.py`` + ``models/clip/zoo.py``):

* learnable ``text_key`` (P, D) and ``text_prompt`` (P, n_ctx, D) pools;
  each sample's top-k prompts by image-feature similarity are spliced after
  [SOS] of every class prompt "x" * k * n_ctx + " classname." and the text
  tower runs per (sample, class) pair;
* the CoPL module: per-layer (0-6) pools of (prompt, key, attention)
  triplets synthesize asymmetric (Ek, Ev) prefix tokens from the frozen
  promptless query, with per-task pool slices (earlier slices frozen) and
  a Gram-Schmidt re-orthogonalization at task switches (on the host);
* prefix sharing: under the causal mask the [SOS] + ctx prefix is the same
  for every class of a sample, so it runs once per sample (kernel #1's op
  at T = lp, collecting each block's input), and only each class's S-token
  suffix runs per pair (``_suffix_pass_grouped``). On the fused road all C
  suffixes of a sample are one flat C * S-token row through
  ``fused_prefix_attention_block`` with pk = pv = ln_1(state) and a
  block-diagonal (C * S, lp + C * S) mask, as JAX's ``fused_body``; the
  ``"unfused"`` road is JAX's einsum ``body``. Both checkpoint each layer.

The image tower's CoPL prefixes run through ``fused_prefix_attention_block``
with pk != pv (P = 4; layers past the pool's 7 have no live slot). JAX's
``LLC_FUSED_ROWS_SUFFIX`` / ``LLC_SUFFIX_REMAT`` knobs (TPU tiling and an
ablation) are not carried over.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np
import torch
import torch.utils.checkpoint

from ..config import CLIPConfig
from . import clip as clip_fns
from ..ops.attention import causal_mask, mm32
from ..ops.fused_block_attn import fused_prefix_attention_block
from .mvp_clip import _vit_prelude
from .vit_prompt import top_k_indices

COPL_LAYERS = (0, 1, 2, 3, 4, 5, 6)
COPL_POOL = 100
COPL_LEN = 8  # Ek 4 + Ev 4


def init_proto_params(gen: torch.Generator, clip_cfg: CLIPConfig, *,
                      num_prompt: int = 10, n_ctx: int = 12,
                      copl_pool: int = COPL_POOL, copl_len: int = COPL_LEN,
                      device=None):
    """Text pools normal(0, 0.02); CoPL pools U(-1, 1), orthonormalized
    (JAX ``:37``; reference zoo.py:30-46); fp32 on ``device``."""
    tw, vw = clip_cfg.text_width, clip_cfg.vision_width
    n_l = len(COPL_LAYERS)

    def uniform(*shape):
        return (2.0 * torch.rand(*shape, generator=gen) - 1.0).numpy()

    copl = {"p": uniform(n_l, copl_pool, copl_len, vw),
            "k": uniform(n_l, copl_pool, vw),
            "a": uniform(n_l, copl_pool, vw)}
    return {
        "text_key": (0.02 * torch.randn(num_prompt, tw, generator=gen)
                     ).to(device),
        "text_prompt": (0.02 * torch.randn(num_prompt, n_ctx, tw,
                                           generator=gen)).to(device),
        "copl": {k: torch.from_numpy(gram_schmidt(v)).to(device)
                 for k, v in copl.items()},
    }


def gram_schmidt(t: np.ndarray) -> np.ndarray:
    """Orthonormalize pool vectors on the host (JAX ``:62``; reference
    zoo.py:207-263): leading dims batch, the last axes flattened; fp32."""
    shp = t.shape
    flat = t.reshape(shp[0], shp[1], -1) if t.ndim > 2 else t[None]
    out = np.zeros_like(flat)
    for layer in range(flat.shape[0]):
        basis = []
        for i in range(flat.shape[1]):
            v = flat[layer, i].astype(np.float64)
            for b in basis:
                v = v - np.dot(v, b) * b
            n = np.linalg.norm(v)
            if n > 1e-10:
                v = v / n
            else:
                v = np.random.default_rng(i).normal(size=v.shape)
                v /= np.linalg.norm(v)
            basis.append(v)
            out[layer, i] = v
    return (out.reshape(shp) if t.ndim > 2 else out[0]).astype(np.float32)


def copl_prefixes(copl, query, layers: int, *, task_count: int,
                  n_tasks: int, train: bool, dtype):
    """Per-layer (Ek, Ev) prefix tokens synthesized from the fp32 query (B,
    D) (JAX ``:87``; reference zoo.py:95-110): in training the current
    task's pool slice is live and the earlier ones frozen (no grad); eval
    uses every slice up to the current task. Returns ({'k', 'v'} (L, B, P,
    D) in ``dtype``, the (L, P) valid mask)."""
    pool = copl["k"].shape[1]
    pt = pool // max(n_tasks, 1)
    s, f = task_count * pt, (task_count + 1) * pt
    idx = torch.arange(pool, device=query.device)
    live = (idx >= s) & (idx < f) if train else torch.zeros_like(idx,
                                                                  dtype=bool)
    use = idx < f
    n_live = sum(1 for layer in COPL_LAYERS if layer < layers)

    def eff(p, extra_dims):
        m = live.reshape((1, -1) + (1,) * extra_dims)
        return torch.where(m, p, p.detach())

    k_eff = eff(copl["k"][:n_live], 1)                    # (C, P, D)
    a_eff = eff(copl["a"][:n_live], 1)
    p_eff = eff(copl["p"][:n_live], 2)                    # (C, P, 2h, D)
    aq = query[None, :, None, :] * a_eff[:, None]         # (C, B, P, D)
    w = torch.einsum("cbpd,cpd->cbp", clip_fns.normalize(aq),
                     clip_fns.normalize(k_eff))
    w = torch.where(use[None, None, :], w, torch.zeros_like(w))
    pr = torch.einsum("cbp,cpld->cbld", w, p_eff)
    half = pr.shape[2] // 2
    b, d = query.shape[0], copl["p"].shape[-1]
    pad = torch.zeros(layers - n_live, b, half, d, dtype=dtype,
                      device=query.device)
    ek = torch.cat([pr[:, :, :half].to(dtype), pad], 0)
    ev = torch.cat([pr[:, :, half:].to(dtype), pad], 0)
    valid = np.zeros((layers, half), bool)
    valid[:n_live] = True
    return {"k": ek, "v": ev}, valid


def proto_encode_image(frozen, proto, images, cfg: CLIPConfig, *,
                       task_count: int, n_tasks: int, train: bool,
                       compute_dtype=torch.bfloat16,
                       attn_impl: str = "fused"):
    """The image tower with CoPL prefix prompts, queried by a frozen
    promptless pass (JAX ``:139``): normalized (B, E) in
    ``compute_dtype``. Both passes use the blocks' QuickGELU, as JAX's."""
    x, v = _vit_prelude(frozen, images, cfg, compute_dtype)
    with torch.no_grad():
        q = clip_fns.transformer(x, v["blocks"], cfg.vision_heads,
                                 attn_impl=attn_impl, base_grads=False)
        query = clip_fns.layer_norm(q[:, :1], v["ln_post"])[:, 0].float()
    prompts, valid = copl_prefixes(proto["copl"], query, cfg.vision_layers,
                                   task_count=task_count, n_tasks=n_tasks,
                                   train=train, dtype=compute_dtype)
    h = clip_fns.transformer(x, v["blocks"], cfg.vision_heads,
                             layer_prompts=prompts, layer_prompt_valid=valid,
                             attn_impl=attn_impl, base_grads=False)
    pooled = clip_fns.layer_norm(h[:, :1], v["ln_post"])[:, 0]
    img = mm32(pooled, v["proj"])
    return clip_fns.normalize(img.to(compute_dtype))


def encode_text_embeddings(frozen, embeds, eot_pos, cfg: CLIPConfig,
                           compute_dtype=torch.bfloat16,
                           attn_impl: str = "fused"):
    """The text tower over built token embeddings (JAX ``:163``), each
    block checkpointed (the batch is B * C pairs): (N, E) in
    ``compute_dtype``."""
    t = clip_fns.cast_tree(frozen["text"], compute_dtype)
    x = embeds.to(compute_dtype) + t["pos_embed"].to(compute_dtype)
    x = clip_fns.transformer(
        x, t["blocks"], cfg.text_heads,
        mask=causal_mask(cfg.context_length, device=x.device), remat=True,
        attn_impl=attn_impl, base_grads=False)
    x = clip_fns.layer_norm(x, t["ln_final"])
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos.long()]
    return mm32(pooled, t["text_projection"]).to(compute_dtype)


def proto_text_features(frozen, proto, img_feats, class_tokens,
                        cfg: CLIPConfig, *, top_k: int, n_ctx: int,
                        suffix_len=None, compute_dtype=torch.bfloat16,
                        attn_impl: str = "fused"):
    """Normalized per-(sample, class) text features (B, C, E) with each
    sample's top-k prompts spliced in, and the (B, k) selection (JAX
    ``:186``). ``suffix_len`` S turns on prefix sharing
    (``_prefix_shared_text``); None runs B * C full 77-token passes."""
    prob = mm32(img_feats.float(), proto["text_key"].float().T)
    indices = top_k_indices(prob, min(top_k, prob.shape[1]))
    sel = proto["text_prompt"][indices]                  # (B, k, n_ctx, D)
    ctx = sel.reshape(img_feats.shape[0], -1, sel.shape[-1])
    txt = text_features_for_ctx(frozen, ctx, class_tokens, cfg,
                                suffix_len=suffix_len,
                                compute_dtype=compute_dtype,
                                attn_impl=attn_impl)
    return txt, indices


def text_features_for_ctx(frozen, ctx, class_tokens, cfg: CLIPConfig, *,
                          suffix_len=None, compute_dtype=torch.bfloat16,
                          attn_impl: str = "fused"):
    """Normalized (B, C, E) text features for spliced ctx tokens (B, lp -
    1, D) (JAX ``:223``); B is samples (training) or prompt combinations
    (the eval cache)."""
    b, lp = ctx.shape[0], 1 + ctx.shape[1]
    class_tokens = class_tokens.long()
    eot = class_tokens.argmax(-1)                        # (C,)
    c = class_tokens.shape[0]
    if suffix_len is not None and lp + suffix_len < cfg.context_length:
        return clip_fns.normalize(_prefix_shared_text(
            frozen, ctx, class_tokens, eot, lp, int(suffix_len), cfg,
            compute_dtype, attn_impl))
    embeds = frozen["text"]["token_embedding"][class_tokens]  # (C, 77, D)
    pairs = embeds[None].expand(b, c, *embeds.shape[1:])
    ctx_bc = ctx[:, None].expand(b, c, *ctx.shape[1:]).to(embeds.dtype)
    pairs = torch.cat([pairs[:, :, :1], ctx_bc, pairs[:, :, lp:]], 2)
    txt = encode_text_embeddings(
        frozen, pairs.reshape(b * c, *pairs.shape[2:]), eot.repeat(b), cfg,
        compute_dtype, attn_impl)
    return clip_fns.normalize(txt).reshape(b, c, -1)


def prompt_combinations(num_prompt: int, top_k: int, cap: int = 1024):
    """All ordered top-k prompt selections, or (None, None) past ``cap``
    (JAX ``:256``): (combos (n, k) int32, lookup (P ** k,) int32) with
    ``lookup[fold(tuple)]`` its combo row, -1 for impossible tuples."""
    k = min(top_k, num_prompt)
    combos = list(permutations(range(num_prompt), k))
    if len(combos) > cap:
        return None, None
    lookup = np.full((num_prompt ** k,), -1, np.int32)
    for row, tup in enumerate(combos):
        flat = 0
        for v in tup:
            flat = flat * num_prompt + v
        lookup[flat] = row
    return np.asarray(combos, np.int32), lookup


def fold_selection(indices, num_prompt: int):
    """Base-P fold of (B, k) index tuples -> (B,) ids in
    ``prompt_combinations``'s lookup layout (JAX ``:284``)."""
    flat = torch.zeros(indices.shape[0], dtype=torch.int64,
                       device=indices.device)
    for m in range(indices.shape[1]):
        flat = flat * num_prompt + indices[:, m].long()
    return flat


def _prefix_shared_text(frozen, ctx, class_tokens, eot, lp: int, s: int,
                        cfg: CLIPConfig, compute_dtype, attn_impl):
    """Prefix-shared per-(sample, class) text encoding (JAX ``:294``):
    unnormalized (B, C, E). The prefix pass is the plain block under a
    causal (lp, lp) mask, collecting each block's input for the suffix
    pass."""
    t = clip_fns.cast_tree(frozen["text"], compute_dtype)
    emb_table = t["token_embedding"]
    pos = t["pos_embed"].to(compute_dtype)
    b, c, d = ctx.shape[0], class_tokens.shape[0], emb_table.shape[-1]
    # the BPE vocab ends <|startoftext|>, <|endoftext|>: SOT = vocab - 2
    sos = emb_table[cfg.vocab_size - 2][None, None].expand(b, 1, d)
    prefix = torch.cat([sos.to(compute_dtype), ctx.to(compute_dtype)], 1) \
        + pos[:lp]
    # the last block's output is no layer's input: the pass stops before
    # it (jit drops it in JAX)
    last, states = clip_fns.transformer(
        prefix, clip_fns._all_but_last(t["blocks"]), cfg.text_heads,
        mask=causal_mask(lp, device=prefix.device), collect_inputs=True,
        attn_impl=attn_impl, base_grads=False)
    states = torch.cat([states, last[None]])                 # (L, B, lp, D)
    suffix = emb_table[class_tokens[:, lp:lp + s]].to(compute_dtype) \
        + pos[lp:lp + s]                                     # (C, S, D)
    x = _suffix_pass_grouped(t, suffix[None].expand(b, c, s, d), states,
                             cfg.text_heads, act=cfg.act,
                             attn_impl=attn_impl)
    x = clip_fns.layer_norm(x, t["ln_final"])
    eot_s = (eot - lp).clamp(0, s - 1)
    pooled = x[:, torch.arange(c, device=x.device), eot_s]  # (B, C, D)
    return mm32(pooled, t["text_projection"]).to(compute_dtype)


def suffix_mask(c: int, s: int, lp: int, device=None):
    """The flat suffix row's additive (C * S, lp + C * S) mask: token (c, j)
    sees the whole prefix and positions (c, <= j) of its own class."""
    row_c = torch.arange(c, device=device).repeat_interleave(s)
    row_j = torch.arange(s, device=device).repeat(c)
    ok = (row_c[:, None] == row_c[None, :]) & \
        (row_j[None, :] <= row_j[:, None])
    cols = torch.where(ok, 0.0, float("-inf"))
    return torch.cat([torch.zeros(c * s, lp, device=device), cols], 1)


def _fused_suffix_layer(h, blk, state, n_heads: int, act: str, mask):
    """One layer of the suffix pass on the fused road (JAX ``fused_body``,
    ``:380-413``): every sample's C suffixes as one flat C * S-token row
    through the prefix op, pk = pv = ln_1(state) (B, lp, D) projected once
    a sample."""
    b, c, s, d = h.shape
    pre = clip_fns.layer_norm(state, blk["ln_1"]).to(h.dtype)
    y = fused_prefix_attention_block(
        h.reshape(b, c * s, d), pre, pre, blk["ln_1"]["scale"],
        blk["ln_1"]["bias"], blk["attn"]["w_qkv"], blk["attn"]["b_qkv"],
        blk["attn"]["w_out"], blk["attn"]["b_out"], n_heads, mask, False)
    return clip_fns._mlp_half(y, blk, act).reshape(b, c, s, d)


def _einsum_suffix_layer(h, blk, state, n_heads: int, act: str, mask):
    """One layer of the suffix pass on the plain road (JAX ``body``,
    ``:415-465``): the per-sample prefix K/V projected once and broadcast
    over the C classes inside the attention products."""
    del mask
    b, c, s, d = h.shape
    dh = d // n_heads
    scale = dh ** -0.5
    causal = causal_mask(s, device=h.device)
    w_qkv, b_qkv = blk["attn"]["w_qkv"], blk["attn"]["b_qkv"]
    pre = clip_fns.layer_norm(state, blk["ln_1"])            # (B, lp, D)
    kv_pre = (mm32(pre, w_qkv[:, d:]) + b_qkv[d:].float()).to(pre.dtype)
    lp = kv_pre.shape[1]
    k_pre = kv_pre[..., :d].reshape(b, lp, n_heads, dh)
    v_pre = kv_pre[..., d:].reshape(b, lp, n_heads, dh)
    hn = clip_fns.layer_norm(h, blk["ln_1"])
    qkv = (mm32(hn, w_qkv) + b_qkv.float()).to(h.dtype)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, c, s, n_heads, dh)
               for i in range(3))
    f = torch.float32
    sc_pre = torch.einsum("bcshe,blhe->bchsl", q.to(f), k_pre.to(f)) * scale
    sc_suf = torch.einsum("bcshe,bcthe->bchst", q.to(f), k.to(f)) * scale \
        + causal
    probs = torch.softmax(torch.cat([sc_pre, sc_suf], -1), -1)
    p_pre, p_suf = (probs[..., :lp].to(v.dtype).to(f),
                    probs[..., lp:].to(v.dtype).to(f))
    ctx = (torch.einsum("bchsl,blhe->bcshe", p_pre, v_pre.to(f))
           + torch.einsum("bchst,bcthe->bcshe", p_suf, v.to(f)))
    ctx = ctx.reshape(b, c, s, d).to(h.dtype)
    out = mm32(ctx, blk["attn"]["w_out"]) + blk["attn"]["b_out"].float()
    return clip_fns._mlp_half(h + out.to(h.dtype), blk, act)


def _suffix_pass_grouped(t, suf, states, n_heads: int,
                         act: str = "quick_gelu", attn_impl: str = "fused"):
    """The text tower over the class suffixes (B, C, S, D) with each
    sample's prefix states (L, B, lp, D) as KV prefixes (JAX ``:343``):
    suffix queries see the whole prefix and their own class's suffix
    causally. Each layer is checkpointed (JAX's default ``full`` policy):
    B * C pairs would otherwise keep every layer's intermediates."""
    b, c, s, _ = suf.shape
    layer = (_fused_suffix_layer if attn_impl == "fused"
             else _einsum_suffix_layer)
    mask = (suffix_mask(c, s, states.shape[2], device=suf.device)
            if attn_impl == "fused" else None)
    h = suf
    for i in range(states.shape[0]):
        h = torch.utils.checkpoint.checkpoint(
            layer, h, clip_fns._layer(t["blocks"], i), states[i], n_heads,
            act, mask, use_reentrant=False, preserve_rng_state=False)
    return h


def choose_suffix_len(max_token_pos: int, lp: int, context_length: int):
    """The static suffix length for prefix sharing, or None (JAX ``:504``):
    max EOT - lp + 1 tokens must fit whole in the window, bucketed to 8."""
    need = max_token_pos - lp + 1
    if need <= 0:
        return None
    cap = context_length - lp - 1
    s = min(max(-(-need // 8) * 8, 8), cap)
    return s if s >= need else None


def proto_logits(frozen, img_feats, txt_feats_bc):
    """``exp(logit_scale) * sum_e img * txt_c`` per class (JAX ``:520``)."""
    scale = torch.exp(frozen["logit_scale"]).float()
    return scale * torch.einsum("be,bce->bc", img_feats.float(),
                                txt_feats_bc.float())
