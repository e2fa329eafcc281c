"""Unfused multi-head attention for the CLIP towers, in plain PyTorch.

Counterpart of ``lifelong_clip_tpu/ops/attention.py`` (its ``impl="xla"``
road): fused qkv projection with an optional LoRA delta, scaled dot-product
attention with an fp32 softmax, output projection with its own LoRA delta.
Shapes are batch-first ``(B, T, D)``; weights keep the ``x @ W`` orientation
(``w_qkv`` (D, 3D), ``w_out`` (D, D)). Matmuls accumulate in fp32 whatever
the operand dtype, as the JAX code's ``preferred_element_type=f32``.
"""

from __future__ import annotations

from typing import Optional

import torch


def mm32(a, b):
    """``a @ b`` with fp32 accumulation and an fp32 result.

    On the CPU the operands are upcast (bf16 products are exact in fp32). On
    the card a bf16 pair goes through the bf16 tensor-core product, whose
    accumulation is fp32 but whose result is rounded to bf16 before the
    upcast: one rounding the JAX path takes later, after the bias add."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.matmul(a, b).float()
    return torch.matmul(a.float(), b.float())


def linear(x, w, b):
    """``x @ w + b`` rounded once to x's dtype, with the product accumulated
    and the bias added in fp32 (the JAX einsum with
    ``preferred_element_type=f32``, plus the bias, then ``astype``). On the
    card a bf16 triple is one ``addmm``, which adds the bias to the fp32 sum
    before its one rounding."""
    if x.is_cuda and x.dtype == w.dtype == b.dtype == torch.bfloat16:
        y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return (mm32(x, w) + b.float()).to(x.dtype)


def qkv_projection(x_q, x_k, x_v, w_qkv, b_qkv, lora=None):
    """Queries from ``x_q``, keys from ``x_k``, values from ``x_v``.
    ``lora``: optional dict with ``a_in`` (D, r), ``b_in`` (r, 3D) and a
    float ``scaling``."""
    d = x_q.shape[-1]

    def proj(x, lo, hi):
        y = mm32(x, w_qkv[:, lo:hi]) + b_qkv[lo:hi].float()
        if lora is not None:
            z = mm32(x, lora["a_in"])
            y = y + lora["scaling"] * mm32(z, lora["b_in"][:, lo:hi])
        return y.to(x.dtype)

    return proj(x_q, 0, d), proj(x_k, d, 2 * d), proj(x_v, 2 * d, 3 * d)


def sdpa(q, k, v, n_heads: int, mask: Optional[torch.Tensor] = None):
    """Scaled dot-product attention (``sdpa_xla`` in the JAX package)."""
    b, t, d = q.shape
    s = k.shape[1]
    dh = d // n_heads
    q = q.reshape(b, t, n_heads, dh).transpose(1, 2)
    k = k.reshape(b, s, n_heads, dh).transpose(1, 2)
    v = v.reshape(b, s, n_heads, dh).transpose(1, 2)
    scores = mm32(q, k.transpose(-1, -2)) * (dh ** -0.5)
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = mm32(probs, v)
    return out.transpose(1, 2).reshape(b, t, d).to(v.dtype)


def multi_head_attention(x_q, params, n_heads: int, *, mask=None, lora=None):
    """Full MHA: fused qkv (+LoRA), SDPA, output projection (+LoRA).

    params: {'w_qkv': (D,3D), 'b_qkv': (3D,), 'w_out': (D,D), 'b_out': (D,)}
    lora:   optional {'a_in','b_in','a_out','b_out','scaling'}.
    mask:   additive, broadcastable to (B, H, T, T).
    """
    q, k, v = qkv_projection(x_q, x_q, x_q, params["w_qkv"], params["b_qkv"],
                             lora=lora)
    ctx = sdpa(q, k, v, n_heads, mask=mask)
    out = mm32(ctx, params["w_out"]) + params["b_out"].float()
    if lora is not None and lora.get("a_out") is not None:
        z = mm32(ctx, lora["a_out"])
        out = out + lora["scaling"] * mm32(z, lora["b_out"])
    return out.to(x_q.dtype)


def causal_mask(t: int, device=None, dtype=torch.float32):
    """Additive causal mask (t, t): query i sees keys 0..i (reference
    ``build_attention_mask``, models/clip/model.py:926-932)."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    return torch.where(j <= i, 0.0, float("-inf")).to(dtype)
