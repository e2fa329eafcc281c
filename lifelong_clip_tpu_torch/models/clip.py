"""CLIP image and text towers as functions of parameter dicts.

Counterpart of ``lifelong_clip_tpu/models/clip.py``: one block
implementation, with LoRA, a bottleneck adapter or a mixture of adapters
(MoE) coming from an optional layer-stacked parameter subtree; depth is a
Python loop over the stacked layers (the JAX package scans). Compute dtype
policy as there: bf16 operands with fp32 LayerNorm, softmax and
accumulation (``_cast_tree``).

On ``attn_impl="fused"`` (the default; the JAX package's ``"pallas"``) the
attention half of a block goes, as in JAX ``_block``, through
``ops/fused_block_attn.py:fused_ln_attention_block`` when it has no prompts
and no mask or a square one, through ``fused_prefix_attention_block`` when
it has KV-prefix prompts, no LoRA and a mask that op takes, and otherwise
(a KV prefix with LoRA, any other mask) through LN and
``ops/attention.multi_head_attention`` on the flash-attention op. Each op's
CUDA kernels run on the card and its plain version on the CPU.
``attn_impl="unfused"`` (the JAX ``"xla"`` road) composes LN and
``multi_head_attention`` on plain PyTorch. The adapter and the MoE are
applied outside the attention op, as in JAX (``_block``, ``_mlp_half``), so
their blocks run the same kernels. ``clip_forward`` runs both towers, PEFT
on either. ``encode_text`` takes KV-prefix prompts as JAX does (each
query sees every prompt slot and the tokens up to its own), on the same
roads. ``encode_image`` runs the ModifiedResNet tower
(``models/resnet.py``) for ``cfg.tower == "rn"``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import CLIPConfig, PEFTConfig
from ..ops.attention import causal_mask, linear, mm32, multi_head_attention
from ..ops.fused_block_attn import (fused_ln_attention_block,
                                    fused_prefix_attention_block)
from ..ops.moe import moe_adapter_apply
from ..parallel import mesh as mesh_lib
from .resnet import rn_encode_image

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


def _all_but_last(tree):
    """A layer-stacked tree without its last layer."""
    if isinstance(tree, dict):
        return {k: _all_but_last(v) for k, v in tree.items()}
    return tree[:-1]


def _adapter_apply(y, p, scale: float):
    """Bottleneck adapter delta ``scale * up(relu(down(y)))`` (reference
    ``models/clip/adapter.py:53-73``, no inner LayerNorm; the caller adds
    the residual). Biases are added and ``scale`` applied in fp32, with
    one rounding to y's dtype at the end, as JAX ``_adapter_apply``."""
    h = torch.relu(mm32(y, p["w_down"]) + p["b_down"].float()).to(y.dtype)
    out = mm32(h, p["w_up"]) + p["b_up"].float()
    return (scale * out).to(y.dtype)


def _block(x, blk, n_heads: int, mask, peft_cfg: Optional[PEFTConfig], peft,
           attn_impl: str, act: str = "quick_gelu", base_grads: bool = True,
           kv_prefix=None, prompt_ln: bool = False, moe_noise=None):
    """One residual attention block (vanilla, LoRA, adapter, MoE or
    KV-prefixed).

    ``kv_prefix``: (B, P, D) prompt tokens joining the keys' and values'
    source, or a dict ``{'k', 'v'}`` of two. ``prompt_ln`` passes them
    through the block's ln_1 first (MVP's append-then-truncate prompts,
    JAX ``models/clip.py:111-113``). ``base_grads=False`` asserts the
    block's own weights are frozen: the fused kernels' backward then skips
    their grads. ``moe_noise``: the MoE gates' (B, E) noise draws (train
    steps), or None for clean gates."""
    if kv_prefix is not None and prompt_ln:
        kv_prefix = ({k: layer_norm(v, blk["ln_1"])
                      for k, v in kv_prefix.items()}
                     if isinstance(kv_prefix, dict)
                     else layer_norm(kv_prefix, blk["ln_1"]))
    lora = adapter = moe = None
    if peft is not None and peft_cfg is not None:
        if peft_cfg.method == "lora":
            lora = dict(peft["lora"],
                        scaling=peft_cfg.lora_alpha / peft_cfg.lora_r)
        elif peft_cfg.method == "adapter":
            adapter = peft.get("adapter")
        elif peft_cfg.method == "moe":
            moe = peft.get("moe")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    if attn_impl == "fused" and mesh_lib.tensor_parallel() is not None:
        # the kernels take whole heads: a model axis runs the plain road,
        # as GSPMD cannot split JAX's opaque kernel calls
        raise ValueError("a model-axis mesh runs attn_impl='unfused'")
    t = x.shape[1]
    square_mask = mask is None or (mask.dim() <= 2 and mask.shape[-1] == t)
    if attn_impl == "fused" and kv_prefix is None and square_mask:
        arrays = None if lora is None else {
            k: lora[k] for k in ("a_in", "b_in", "a_out", "b_out")}
        y = fused_ln_attention_block(
            x, blk["ln_1"]["scale"], blk["ln_1"]["bias"],
            blk["attn"]["w_qkv"], blk["attn"]["b_qkv"],
            blk["attn"]["w_out"], blk["attn"]["b_out"], n_heads,
            float(lora["scaling"]) if lora is not None else 0.0, mask, arrays,
            base_grads)
        if adapter is not None:
            # the adapter reads the attention delta, bf16 y - x (JAX :148)
            y = y + _adapter_apply(y - x, adapter, peft_cfg.adapter_scale)
        return _mlp_half(y, blk, act, adapter, moe, peft_cfg, moe_noise)
    if attn_impl == "fused" and kv_prefix is not None and lora is None:
        pk, pv = ((kv_prefix["k"], kv_prefix["v"])
                  if isinstance(kv_prefix, dict) else (kv_prefix, kv_prefix))
        m2 = _prefix_kernel_mask(mask, t + pk.shape[1])
        if m2 is not False:
            y = fused_prefix_attention_block(
                x, pk, pv, blk["ln_1"]["scale"], blk["ln_1"]["bias"],
                blk["attn"]["w_qkv"], blk["attn"]["b_qkv"],
                blk["attn"]["w_out"], blk["attn"]["b_out"], n_heads, m2,
                base_grads)
            if adapter is not None:
                y = y + _adapter_apply(y - x, adapter,
                                       peft_cfg.adapter_scale)
            return _mlp_half(y, blk, act, adapter, moe, peft_cfg,
                             moe_noise)
    # the general road (JAX ``_block:175-190``): LN, then MHA with keys and
    # values from [prefix; h], on the flash op ("fused") or sdpa ("unfused")
    h = layer_norm(x, blk["ln_1"])
    x_kv = None
    if isinstance(kv_prefix, dict):
        x_kv = (torch.cat([kv_prefix["k"].to(h.dtype), h], 1),
                torch.cat([kv_prefix["v"].to(h.dtype), h], 1))
    elif kv_prefix is not None:
        x_kv = torch.cat([kv_prefix.to(h.dtype), h], 1)
    a = multi_head_attention(
        h, blk["attn"], n_heads, x_kv=x_kv, mask=mask, lora=lora,
        impl="flash" if attn_impl == "fused" else "plain")
    if adapter is not None:
        a = a + _adapter_apply(a, adapter, peft_cfg.adapter_scale)
    return _mlp_half(x + a, blk, act, adapter, moe, peft_cfg, moe_noise)


def _prefix_kernel_mask(mask, s_len):
    """The mask as the prefix kernel op takes it (leading singleton
    dimensions squeezed, JAX ``models/clip.py:156-162``), or False where it
    cannot take it: a mask that is not <= 2-D over S = P + T keys."""
    m2 = mask
    if m2 is not None and m2.dim() > 2 and all(
            s == 1 for s in m2.shape[:-2]):
        m2 = m2.reshape(m2.shape[-2:]) if m2.shape[-2] != 1 \
            else m2.reshape(m2.shape[-1:])
    if m2 is None or (m2.dim() <= 2 and m2.shape[-1] == s_len):
        return m2
    return False


def _mlp_half(x, blk, act, adapter=None, moe=None, peft_cfg=None,
              moe_noise=None):
    """Second block half: x + MLP(LN2(x)), plus the adapter's delta of the
    MLP output or the MoE's delta, which gates on x[:, 0] of this half's
    input (the post-attention stream; reference ``_MoA.forward``,
    ``model.py:596-636``)."""
    h = layer_norm(x, blk["ln_2"])
    mlp = blk["mlp"]
    tp = mesh_lib.tensor_parallel()
    if tp is None:
        m = _ACTS[act](linear(h, mlp["w_fc"], mlp["b_fc"]))
        m = linear(m, mlp["w_proj"], mlp["b_proj"])
    else:
        # this rank's hidden units: column-parallel up, row-parallel down,
        # the partial sums reduced over the model group before the bias
        m = _ACTS[act](linear(mesh_lib.copy_to_model(h, tp), mlp["w_fc"],
                              mlp["b_fc"]))
        m = (mesh_lib.reduce_from_model(mm32(m, mlp["w_proj"]), tp)
             + mlp["b_proj"].float()).to(h.dtype)
    if adapter is not None:
        m = m + _adapter_apply(m, adapter, peft_cfg.adapter_scale)
    if moe is not None:
        m = m + moe_adapter_apply(x, moe, peft_cfg, noise=moe_noise)
    return x + m


def transformer(x, blocks, n_heads: int, *, mask=None,
                peft_cfg: Optional[PEFTConfig] = None, peft=None,
                layer_prompts=None, layer_prompt_valid=None,
                attn_impl: str = "fused", act: str = "quick_gelu",
                prompt_ln: bool = False, base_grads: bool = True,
                remat: bool = False, moe_noise=None,
                collect_inputs: bool = False):
    """Run the layer-stacked residual blocks in order.

    ``layer_prompts`` (L, B, P, D), or (L, P, D) broadcast over the batch,
    or a dict ``{'k', 'v'}`` of such: per-layer KV-side prefix tokens.
    ``layer_prompt_valid`` (L, P) bool marks each layer's live slots; dead
    slots get -inf in a (1, 1, P + T) mask added to ``mask``
    (JAX ``models/clip.py:280-311``). ``prompt_ln``: see ``_block``.
    ``remat=True`` checkpoints each block, as JAX wraps the scan body in
    ``jax.checkpoint`` (``:323-335``): the backward recomputes the block's
    forward instead of keeping its intermediates. ``moe_noise`` (L, B, E):
    each layer's MoE gate noise (JAX draws one key a layer, ``:272-279``);
    it reaches the blocks only when ``peft_cfg`` is the MoE's.
    ``collect_inputs=True`` returns ``(x, states)`` with ``states`` (L, B,
    T, D) each block's input (JAX ``:227-240, 313-320``; ProtoCLIP's
    prefix pass); under ``remat`` they are the checkpoints' inputs, kept
    anyway."""
    n_layers = blocks["attn"]["w_qkv"].shape[0]
    if peft_cfg is None or peft_cfg.method != "moe":
        moe_noise = None
    pmask = None
    if layer_prompts is not None:
        def bcast(lp):
            return lp[:, None].expand(lp.shape[0], x.shape[0],
                                      *lp.shape[1:]) if lp.dim() == 3 else lp
        layer_prompts = ({k: bcast(v) for k, v in layer_prompts.items()}
                         if isinstance(layer_prompts, dict)
                         else bcast(layer_prompts))
        if layer_prompt_valid is not None:
            valid = torch.as_tensor(layer_prompt_valid, device=x.device)
            prefix = torch.where(valid, 0.0, float("-inf"))
            pmask = torch.cat([prefix, torch.zeros(
                prefix.shape[0], x.shape[1], device=x.device)], 1)
            pmask = pmask[:, None, None, :]   # (L, 1, 1, P + T)
    inputs = []
    for i in range(n_layers):
        if collect_inputs:
            inputs.append(x)
        m = mask
        if pmask is not None:
            m = pmask[i] if m is None else m + pmask[i]
        args = (x, _layer(blocks, i), n_heads, m, peft_cfg, _layer(peft, i),
                attn_impl, act, base_grads, _layer(layer_prompts, i),
                prompt_ln, _layer(moe_noise, i))
        # the blocks draw no random numbers (the MoE noise is an input): no
        # RNG state to replay
        x = (torch.utils.checkpoint.checkpoint(
            _block, *args, use_reentrant=False, preserve_rng_state=False)
            if remat else _block(*args))
    return (x, torch.stack(inputs)) if collect_inputs else x


def cast_tree(tree, dtype):
    """fp32 leaves -> ``dtype`` (other leaves untouched, as ``_cast_tree``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def cast_towers(params, dtype):
    """Cast the frozen towers once (they are never updated); the logit scale
    stays fp32 as the JAX step reads it from the uncast tree, and so does a
    ModifiedResNet vision tree, whose convolutions cast their kernels a
    call and whose BatchNorm runs in fp32 (JAX ``resnet.py``)."""
    return {k: cast_tree(v, dtype)
            if k == "text" or (k == "vision" and "stem" not in v) else v
            for k, v in params.items()}


def extract_patches(images, patch_size: int):
    """(B, H, W, 3) -> (B, N, P*P*3) patch vectors, flattened (ph, pw, c)."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def vit_embed(v, images, cfg: CLIPConfig, cd):
    """Patch embedding, class token, positions and ln_pre of the vision
    tower ``v`` (already in ``cd``): the token sequence (B, 1 + N, D)."""
    if cfg.tower != "vit":
        raise ValueError("the ModifiedResNet tower has no token sequence")
    x = extract_patches(images.to(cd), cfg.patch_size)
    x = mm32(x, v["patch_kernel"]).to(cd)
    if "patch_bias" in v:
        x = x + v["patch_bias"].to(cd)
    cls = v["class_embedding"].to(cd).expand(x.shape[0], 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    x = x + v["pos_embed"].to(cd)
    if cfg.use_ln_pre:
        x = layer_norm(x, v["ln_pre"])
    return x


def encode_image(params, images, cfg: CLIPConfig, *,
                 peft_cfg: Optional[PEFTConfig] = None, peft=None,
                 layer_prompts=None, compute_dtype=torch.bfloat16,
                 attn_impl: str = "fused", base_grads: bool = True,
                 remat: bool = False, moe_noise=None, depth_runner=None):
    """Vision tower. ``images``: (B, H, W, 3) normalized floats;
    ``layer_prompts``: raw KV-prefix tokens per layer; ``remat``: checkpoint
    each block (``transformer``); ``moe_noise``: (L, B, E) MoE gate noise.
    ``depth_runner`` replaces ``transformer`` with the same signature (JAX
    ``:380,411-420``; ``parallel/pipeline.py:pipelined_transformer``); it
    gets ``remat`` and ``moe_noise`` only when they are set.
    The PEFT tree is cast to ``compute_dtype`` (JAX ``_cast_tree``).
    Returns the projected CLS embedding (B, embed_dim) in
    ``compute_dtype``. ``cfg.tower == "rn"`` runs the ModifiedResNet tower
    (``resnet.rn_encode_image``, JAX ``:392-397``), which takes no PEFT
    tree and no prompts."""
    cd = compute_dtype
    if cfg.tower == "rn":
        if peft is not None or layer_prompts is not None:
            raise ValueError("the ModifiedResNet tower takes no PEFT or "
                             "prompt tree")
        return rn_encode_image(params, images, cfg, compute_dtype=cd)
    v = cast_tree(params["vision"], cd)
    x = vit_embed(v, images, cfg, cd)
    extra = {} if moe_noise is None else {"moe_noise": moe_noise}
    if remat:
        extra["remat"] = True
    x = (depth_runner or transformer)(
        x, v["blocks"], cfg.vision_heads,
        peft_cfg=peft_cfg if (peft_cfg and peft_cfg.on_vision()) else None,
        peft=cast_tree(peft, cd), layer_prompts=layer_prompts,
        attn_impl=attn_impl, act=cfg.act, base_grads=base_grads, **extra)
    pooled = layer_norm(x[:, :1], v["ln_post"])[:, 0]
    return mm32(pooled, v["proj"]).to(cd)


def encode_text(params, tokens, cfg: CLIPConfig, *,
                peft_cfg: Optional[PEFTConfig] = None, peft=None,
                layer_prompts=None, compute_dtype=torch.bfloat16,
                attn_impl: str = "fused", base_grads: bool = True,
                remat: bool = False, moe_noise=None):
    """Text tower. ``tokens``: (B, context_length) integer ids. Pools at the
    EOT position (argmax of the ids, reference model.py:941-956);
    ``layer_prompts``: raw KV-prefix tokens per layer, one tensor (L, P,
    D) broadcast over the rows or (L, B, P, D), behind the causal mask
    extended by P always-visible keys (JAX ``:451-452``); ``remat``:
    checkpoint each block (``transformer``); ``moe_noise``: (L, B, E) MoE
    gate noise."""
    cd = compute_dtype
    t = cast_tree(params["text"], cd)
    pt = cast_tree(peft, cd)
    tokens = tokens.long()
    x = t["token_embedding"][tokens].to(cd)
    x = x + t["pos_embed"].to(cd)
    prefix = 0 if layer_prompts is None else layer_prompts.shape[-2]
    mask = causal_mask(cfg.context_length, prefix=prefix, device=x.device)
    x = transformer(x, t["blocks"], cfg.text_heads, mask=mask,
                    peft_cfg=peft_cfg if (peft_cfg and peft_cfg.on_text())
                    else None,
                    peft=pt, layer_prompts=layer_prompts,
                    attn_impl=attn_impl, act=cfg.act,
                    base_grads=base_grads, remat=remat, moe_noise=moe_noise)
    x = layer_norm(x, t["ln_final"])
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return mm32(pooled, t["text_projection"]).to(cd)


def normalize(x, eps: float = 1e-8):
    x32 = x.float()
    return (x32 / (torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
                   + eps)).to(x.dtype)


def clip_forward(params, images, tokens, cfg: CLIPConfig, *,
                 peft_cfg: Optional[PEFTConfig] = None, peft_vision=None,
                 peft_text=None, compute_dtype=torch.bfloat16,
                 attn_impl: str = "fused", base_grads: bool = True,
                 remat: bool = False, moe_noise=None):
    """Both towers: (logits (B, K) fp32 at ``exp(logit_scale)``, normalized
    image features, normalized text features) (JAX ``clip_forward``,
    reference ``CLIP.forward`` without the transposed logits).
    ``moe_noise``: ``{'vision', 'text'}`` (L, B, E) MoE gate noise of each
    tower (train steps; JAX splits one key between the towers), or None
    for clean gates."""
    noise = moe_noise or {}
    img = normalize(encode_image(
        params, images, cfg, peft_cfg=peft_cfg, peft=peft_vision,
        compute_dtype=compute_dtype, attn_impl=attn_impl,
        base_grads=base_grads, remat=remat, moe_noise=noise.get("vision")))
    txt = normalize(encode_text(
        params, tokens, cfg, peft_cfg=peft_cfg, peft=peft_text,
        compute_dtype=compute_dtype, attn_impl=attn_impl,
        base_grads=base_grads, remat=remat, moe_noise=noise.get("text")))
    scale = torch.exp(params["logit_scale"]).float()
    return scale * (img.float() @ txt.float().T), img, txt
