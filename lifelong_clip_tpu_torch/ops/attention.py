"""Unfused multi-head attention for the CLIP towers.

Counterpart of ``lifelong_clip_tpu/ops/attention.py``: fused qkv projection
with an optional LoRA delta, scaled dot-product attention with an fp32
softmax, output projection with its own LoRA delta, keys and values
optionally from their own sources (a KV prefix). The attention in the middle
is ``sdpa`` in plain PyTorch (``impl="plain"``, JAX's ``"xla"``) or the
flash-attention op over hand-written kernels (``impl="flash"``, JAX's
``"pallas"``). Shapes are
batch-first ``(B, T, D)``; weights keep the ``x @ W`` orientation (``w_qkv``
(D, 3D), ``w_out`` (D, D)). Matmuls accumulate in fp32 whatever the operand
dtype, as the JAX code's ``preferred_element_type=f32``, and their results
stay fp32 until the one rounding JAX takes.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..parallel import mesh as mesh_lib


@contextlib.contextmanager
def _no_tf32():
    """Full-fp32 products on the card for the block, whatever the global
    TF32 setting; the setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mm32(a, b):
    """``a @ b`` with fp32 accumulation and an unrounded fp32 result.

    The operands are upcast: products of bf16 values are exact in fp32, so
    an fp32 product with TF32 off equals JAX's bf16 product with
    ``preferred_element_type=f32`` up to summation order, on the CPU and on
    the card alike."""
    a, b = a.float(), b.float()
    if a.is_cuda:
        with _no_tf32():
            return torch.matmul(a, b)
    return torch.matmul(a, b)


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


def qkv_projection(x_q, x_k, x_v, w_qkv, b_qkv, lora=None, tp=None):
    """Queries from ``x_q``, keys from ``x_k``, values from ``x_v``.
    ``lora``: optional dict with ``a_in`` (D, r), ``b_in`` (r, 3D) and a
    float ``scaling``. ``tp``: a mesh whose model group splits the heads
    (``parallel/mesh.py``): ``w_qkv``/``b_qkv`` hold this rank's heads of
    q, k and v (D, 3D/M) and the projections are this rank's columns; the
    replicated LoRA factors are read at the same columns."""
    d = w_qkv.shape[-1] // 3
    b_in = None if lora is None else lora["b_in"]
    if tp is not None and lora is not None:
        b_in = mesh_lib.take(b_in, -1, mesh_lib.qkv_columns(
            b_in.shape[-1] // 3, tp), tp)

    def into_heads(a):
        # a replicated value entering this rank's heads: the backward
        # sums the ranks' partial grads (each its heads' share)
        return a if tp is None else mesh_lib.copy_to_model(a, tp)

    sources = {}

    def source(x):
        """``x`` and its LoRA factor ``x @ a_in`` as the projections read
        them, once per distinct source (self-attention reads one)."""
        if id(x) not in sources:
            z = None if lora is None else into_heads(mm32(x, lora["a_in"]))
            sources[id(x)] = into_heads(x), z
        return sources[id(x)]

    def proj(x, lo, hi):
        xh, z = source(x)
        y = mm32(xh, w_qkv[:, lo:hi]) + b_qkv[lo:hi].float()
        if lora is not None:
            y = y + lora["scaling"] * mm32(z, b_in[:, lo:hi])
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


IMPLS = ("plain", "flash")


def multi_head_attention(x_q, params, n_heads: int, *, x_kv=None, mask=None,
                         lora=None, impl: str = "plain"):
    """Full MHA: fused qkv (+LoRA), SDPA, output projection (+LoRA).

    params: {'w_qkv': (D,3D), 'b_qkv': (3D,), 'w_out': (D,D), 'b_out': (D,)}
    x_kv:   keys' and values' source (B, S, D), or a ``(k_src, v_src)``
            tuple (prefixes that differ for K and V); ``None``: ``x_q``.
    lora:   optional {'a_in','b_in','a_out','b_out','scaling'}.
    mask:   additive, broadcastable to (B, H, T, S).
    impl:   "plain" (``sdpa``) or "flash" (``ops/flash_attention.py``); a
            mask that depends on batch or head takes "plain", as in JAX
            (``ops/attention.py:111-113``).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "flash" and mask is not None and any(
            n != 1 for n in mask.shape[:-2]):
        impl = "plain"
    tp = mesh_lib.tensor_parallel()
    x_kv = x_q if x_kv is None else x_kv
    x_k, x_v = x_kv if isinstance(x_kv, tuple) else (x_kv, x_kv)
    q, k, v = qkv_projection(x_q, x_k, x_v, params["w_qkv"], params["b_qkv"],
                             lora=lora, tp=tp)
    if tp is not None:   # this rank's heads
        n_heads = n_heads * q.shape[-1] // x_q.shape[-1]
    if impl == "flash":
        from .flash_attention import flash_attention
        ctx = flash_attention(q, k, v, n_heads, mask=mask)
    else:
        ctx = sdpa(q, k, v, n_heads, mask=mask)
    lora_out = lora is not None and lora.get("a_out") is not None
    if tp is None:
        out = mm32(ctx, params["w_out"]) + params["b_out"].float()
        if lora_out:
            z = mm32(ctx, lora["a_out"])
            out = out + lora["scaling"] * mm32(z, lora["b_out"])
        return out.to(x_q.dtype)
    # row-parallel: the ranks' partial products summed over the model
    # group before the bias; the LoRA factor's too, before its replicated
    # second factor
    out = mesh_lib.reduce_from_model(mm32(ctx, params["w_out"]), tp) \
        + params["b_out"].float()
    if lora_out:
        a_out = mesh_lib.take(lora["a_out"], 0, mesh_lib.head_columns(
            lora["a_out"].shape[0], tp), tp)
        z = mesh_lib.reduce_from_model(mm32(ctx, a_out), tp)
        out = out + lora["scaling"] * mm32(z, lora["b_out"])
    return out.to(x_q.dtype)


def causal_mask(t: int, prefix: int = 0, device=None, dtype=torch.float32):
    """Additive causal mask (t, prefix + t): query i sees every ``prefix``
    KV token and keys 0..i (reference ``build_attention_mask``,
    models/clip/model.py:926-932, extended for KV-side prefixes)."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(prefix + t, device=device)[None, :]
    allowed = (j < prefix) | ((j - prefix) <= i)
    return torch.where(allowed, 0.0, float("-inf")).to(dtype)
