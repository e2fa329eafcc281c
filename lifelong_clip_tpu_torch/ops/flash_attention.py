"""Attention on projected q, k, v in fp32: softmax(q k^T * scale + mask) v
per head, forward and backward.

Counterpart of ``lifelong_clip_tpu/ops/flash_attention.py:flash_attention``
(a ``jax.custom_vjp`` over two Pallas kernels): q (B, T, D), k and v
(B, S, D), ``n_heads`` heads of D / n_heads, an optional additive mask, the
result (B, T, D) in q's dtype. Both kernels take fp32 products of q, k and
v (exact products of bf16 inputs on the tensor cores) and never round the
probabilities to bf16 (the bf16 kernels feed them to the tensor cores as
bf16 hi + lo halves): the forward divides ``e @ v`` by the row sum
of ``e = exp(s - max)`` after the product (``_attn_kernel:32-46``); the
backward recomputes ``p = e / sum(e)`` in fp32 and takes the row term as
``rowsum(dp * p)`` (``_attn_bwd_kernel:128-153``). That is not
``ops/attention.py:sdpa``, which rounds the probabilities to the value dtype
as ``sdpa_xla`` does.

Kernels and the TPU kernels they replace (``csrc/flash_attention.cu``):

* forward: ``llc_flash_fwd`` (bf16: tensor cores, score rows in registers
  up to 256 keys, two passes over key tiles above; fp32: CUDA cores),
  replacing ``_attn_kernel`` (``:32``, Pallas call at ``:96``);
* backward: ``llc_flash_bwd`` (a dq kernel per query tile and a dk/dv
  kernel per key tile, no atomics), replacing ``_attn_bwd_kernel``
  (``:128``, Pallas call at ``:191``).

Beside them sit their plain versions, ``flash_attention_reference`` and
``flash_attention_reference_bwd``, which repeat the TPU kernels'
arithmetic. The op takes them only for tensors on the CPU; a CUDA tensor
launches the kernels or raises (head dim other than 64, mixed dtypes, a
failed build).
"""

from __future__ import annotations

import torch

from . import _kernels
from .attention import mm32

_DT = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel: one per op call on a CUDA tensor
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _squeeze_mask(mask):
    """Leading singleton dimensions go, as the JAX wrapper squeezes them
    (``:85-89``): to the last two dimensions, or to the last one where the
    second-to-last is 1. The result broadcasts to (T, S)."""
    if mask is not None and mask.dim() > 2:
        mask = mask.reshape(mask.shape[-2:]) if mask.shape[-2] != 1 \
            else mask.reshape(mask.shape[-1:])
    return mask


def _mask_view(mask, t, s, device):
    """The mask as an fp32 (T, S) view of the caller's values (broadcast
    dimensions get stride 0; nothing is materialised), or None."""
    mask = _squeeze_mask(mask)
    if mask is None:
        return None
    return torch.broadcast_to(mask.to(device=device, dtype=torch.float32),
                              (t, s))


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------

def _heads(x, n_heads):
    """(B, L, D) -> fp32 (B, H, L, dh)."""
    b, n, d = x.shape
    return x.float().reshape(b, n, n_heads, d // n_heads).transpose(1, 2)


def _merge(x, dtype):
    """(B, H, L, dh) -> (B, L, D) in ``dtype``."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh).to(dtype)


def _scores(q, k, n_heads, mask):
    t, s = q.shape[1], k.shape[1]
    dh = q.shape[-1] // n_heads
    sc = mm32(_heads(q, n_heads), _heads(k, n_heads).transpose(-1, -2)) \
        * dh ** -0.5
    m = _mask_view(mask, t, s, q.device)
    return sc if m is None else sc + m


def flash_attention_reference(q, k, v, n_heads: int, mask=None):
    """Plain version of the forward kernel (``_attn_kernel:32-46``)."""
    s = _scores(q, k, n_heads, mask)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    out = mm32(e, _heads(v, n_heads)) / e.sum(-1, keepdim=True)
    return _merge(out, q.dtype)


def flash_attention_reference_bwd(q, k, v, g, n_heads: int, mask=None):
    """Plain version of the backward kernel (``_attn_bwd_kernel:128-153``):
    (dq, dk, dv), each in its input's dtype."""
    dh = q.shape[-1] // n_heads
    s = _scores(q, k, n_heads, mask)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    gh = _heads(g, n_heads)
    dv = mm32(p.transpose(-1, -2), gh)
    dp = mm32(gh, _heads(v, n_heads).transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = mm32(ds, _heads(k, n_heads)) * dh ** -0.5
    dk = mm32(ds.transpose(-1, -2), _heads(q, n_heads)) * dh ** -0.5
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _cuda_operands(q, k, v, n_heads, mask):
    """Check what the kernels take and return (q, k, v) contiguous, the
    mask view and its strides, and (B, T, S, D)."""
    op = "flash_attention"
    if q.dtype not in _DT or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{op}: q, k and v must share one dtype, bf16 or "
                        f"f32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{op}: q must be (B, T, D) and k, v (B, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, d = q.shape
    s = k.shape[1]
    if d % n_heads or d // n_heads != 64:
        raise ValueError(f"{op} kernels take head dim 64; got D={d}, "
                         f"heads={n_heads}")
    m = _mask_view(mask, t, s, q.device)
    strides = (0, 0) if m is None else m.stride()
    return (*(_aligned(a) for a in (q, k, v)), m, strides, (b, t, s, d))


def _aligned(t):
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _cuda_forward(q, k, v, n_heads, mask):
    q, k, v, m, (mrs, mcs), (b, t, s, d) = _cuda_operands(q, k, v, n_heads,
                                                          mask)
    out = torch.empty_like(q)
    _kernels.call("llc_flash_fwd", _DT[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), _ptr(m), mrs, mcs, out.data_ptr(), b, t, s, d,
                  n_heads, (d // n_heads) ** -0.5,
                  torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def _cuda_backward(q, k, v, g, n_heads, mask):
    q, k, v, m, (mrs, mcs), (b, t, s, d) = _cuda_operands(q, k, v, n_heads,
                                                          mask)
    g = _aligned(g.to(q.dtype))
    dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
    stats = torch.empty(b * n_heads * t * 3, dtype=torch.float32,
                        device=q.device)
    _kernels.call("llc_flash_bwd", _DT[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), g.data_ptr(), _ptr(m), mrs, mcs,
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  stats.data_ptr(), b, t, s, d, n_heads,
                  (d // n_heads) ** -0.5,
                  torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _forward(q, k, v, n_heads, mask):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, n_heads, mask)
    if q.device.type == "cuda":
        return _cuda_forward(q, k, v, n_heads, mask)
    raise RuntimeError(f"flash_attention: no kernel for {q.device}")


def _backward(q, k, v, g, n_heads, mask):
    if q.device.type == "cpu":
        return flash_attention_reference_bwd(q, k, v, g, n_heads, mask)
    if q.device.type == "cuda":
        return _cuda_backward(q, k, v, g, n_heads, mask)
    raise RuntimeError(f"flash_attention: no kernel for {q.device}")


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, n_heads, mask):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads, ctx.mask = n_heads, mask
        return _forward(q, k, v, n_heads, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = _backward(q, k, v, g, ctx.n_heads, ctx.mask)
        # the mask and n_heads get no gradient
        return tuple(gr if need else None for gr, need in
                     zip(grads, ctx.needs_input_grad)) + (None, None)


def flash_attention(q, k, v, n_heads: int, mask=None):
    """softmax(q k^T / sqrt(dh) + mask) v per head, with the JAX op's
    signature: q (B, T, D), k and v (B, S, D), bf16 or fp32; ``mask``
    additive, None, (S,), (T, S) or one of those with leading singleton
    dimensions. Returns (B, T, D) in q's dtype."""
    return _FlashAttention.apply(q, k, v, int(n_heads), mask)
