"""Fused attention half block: y = x + out_proj(MHA(LN(x))), forward and backward.

Counterpart of ``lifelong_clip_tpu/ops/fused_block_attn.py:
fused_ln_attention_block`` (``:202-218``): fp32 LayerNorm, bf16 qkv with an
optional in-kernel LoRA term ``s * (h @ A_in) @ B_in``, per-head fp32 softmax
with an additive (T, T) mask, out projection with its own LoRA term, and the
residual. The backward recomputes LN, qkv and the probabilities and emits dx
and the LoRA grads; the LN and base-weight grads only when ``weight_grads``.

Kernels and the TPU kernels they replace:

* forward: ``csrc/fused_block_attn.cu`` (LN, GEMM with bias/LoRA/residual
  epilogue, attention forward), replacing ``_kernel`` (``:56``, Pallas call
  at ``:161``);
* backward: the same source (LN backward, GEMMs, attention backward, column
  sums), replacing ``_bwd_kernel`` (``:258``, Pallas call at ``:478``).

Bound on one H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the ViT-B/16 vision
block, bs=64: forward ~67.1 GFLOP (~68 us, compute-bound); backward with
``weight_grads=False`` ~127 GFLOP (~128 us, compute-bound). The first port
runs the op as a chain of kernels whose intermediates (h, qkv, ctx, dctx,
dqkv, dh) go through device memory where the TPU kernel kept them in VMEM;
fusing them back is the first target of a later redesign. Weight-type grads
are contractions over all B*T rows done as split-K GEMMs whose partials a
second pass sums in a fixed order: no atomics, as the TPU kernel's
sequential grid had none.

Beside the kernels sit their plain PyTorch versions,
``fused_ln_attention_block_reference`` and
``fused_ln_attention_block_reference_bwd``, which repeat the TPU kernels'
arithmetic and bf16 rounding points. The op takes them only for tensors on
the CPU; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from . import _kernels

EPS = 1e-5
_BF = torch.bfloat16
_DT = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel chain: one per op call on a CUDA tensor
LAUNCHES = {"fused_ln_attention_fwd": 0, "fused_ln_attention_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------

def _mm(a, b):
    """bf16 operands, fp32 accumulation (``preferred_element_type=f32``)."""
    return a.float() @ b.float()


def _lora16(lora, lora_scaling):
    if lora is None or lora_scaling == 0.0:
        return None
    return tuple(lora[k].to(_BF) for k in ("a_in", "b_in", "a_out", "b_out"))


def _mask32(mask, t, device):
    if mask is None:
        return None
    return torch.broadcast_to(mask.to(device=device, dtype=torch.float32),
                              (t, t)).contiguous()


def _split_heads(a, b, t, n_heads):
    """(B*T, D) -> (B, H, T, dh)."""
    d = a.shape[-1]
    return a.reshape(b, t, n_heads, d // n_heads).permute(0, 2, 1, 3)


def _merge_heads(a):
    """(B, H, T, dh) -> (B*T, D)."""
    b, h, t, dh = a.shape
    return a.permute(0, 2, 1, 3).reshape(b * t, h * dh)


def _ln_parts(x32, ln_scale, ln_bias):
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    xhat = (x32 - mean) * rstd
    return xhat, rstd, xhat * ln_scale.float() + ln_bias.float()


def _probs(q16, k16, mask32, scale):
    s = _mm(q16, k16.transpose(-1, -2)) * scale
    if mask32 is not None:
        s = s + mask32
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def _forward_parts(x, ln_scale, ln_bias, w_qkv, b_qkv, n_heads, mask, lt,
                   lora_scaling):
    b, t, d = x.shape
    x32 = x.reshape(b * t, d).float()
    xhat, rstd, h32 = _ln_parts(x32, ln_scale, ln_bias)
    h = h32.to(_BF)
    qkv = _mm(h, w_qkv.to(_BF)) + b_qkv.float()
    z = None
    if lt is not None:
        z = _mm(h, lt[0])
        qkv = qkv + lora_scaling * _mm(z.to(_BF), lt[1])
    qkv16 = qkv.to(_BF)
    q, k, v = (_split_heads(qkv16[:, i * d:(i + 1) * d], b, t, n_heads)
               for i in range(3))
    scale = (d // n_heads) ** -0.5
    p = _probs(q, k, _mask32(mask, t, x.device), scale)
    ctx16 = _merge_heads(_mm(p.to(_BF), v)).to(_BF)
    return x32, xhat, rstd, h, z, (q, k, v), p, ctx16, scale


def fused_ln_attention_block_reference(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_out, b_out, n_heads: int,
                                       lora_scaling: float = 0.0, mask=None,
                                       lora=None):
    """Plain version of the forward kernel (``_kernel``, ``:56-127``)."""
    b, t, d = x.shape
    lt = _lora16(lora, lora_scaling)
    x32, _, _, _, _, _, _, ctx16, _ = _forward_parts(
        x, ln_scale, ln_bias, w_qkv, b_qkv, n_heads, mask, lt, lora_scaling)
    out = _mm(ctx16, w_out.to(_BF)) + b_out.float()
    if lt is not None:
        z2 = _mm(ctx16, lt[2])
        out = out + lora_scaling * _mm(z2.to(_BF), lt[3])
    return (x32 + out).reshape(b, t, d).to(x.dtype)


def fused_ln_attention_block_reference_bwd(x, g, ln_scale, ln_bias, w_qkv,
                                           b_qkv, w_out, n_heads: int,
                                           lora_scaling: float = 0.0,
                                           mask=None, lora=None,
                                           weight_grads: bool = True):
    """Plain version of the backward kernel (``_bwd_kernel``, ``:258-443``),
    step by step with its bf16 rounding points. Returns fp32
    ``(dx, dls, dlb, dwqkv, dbqkv, dwout, dbout)`` and the LoRA grads
    (``None`` without LoRA); dx is in x's dtype."""
    b, t, d = x.shape
    lt = _lora16(lora, lora_scaling)
    s = lora_scaling
    x32, xhat, rstd, h, z, (q, k, v), p, ctx16, scale = _forward_parts(
        x, ln_scale, ln_bias, w_qkv, b_qkv, n_heads, mask, lt, s)
    g32 = g.reshape(b * t, d).float()
    g16 = g32.to(_BF)
    w_qkv16, w_out16 = w_qkv.to(_BF), w_out.to(_BF)
    f32 = dict(dtype=torch.float32, device=x.device)
    dwout = torch.zeros(d, d, **f32)
    dbout = torch.zeros(d, **f32)
    dwqkv = torch.zeros(d, 3 * d, **f32)
    dbqkv = torch.zeros(3 * d, **f32)
    dls = torch.zeros(d, **f32)
    dlb = torch.zeros(d, **f32)

    if weight_grads:
        dwout = _mm(ctx16.T, g16)
        dbout = g32.sum(0)
    dctx = _mm(g16, w_out16.T)
    dlora = None
    if lt is not None:
        a_in, b_in, a_out, b_out_l = lt
        z2 = _mm(ctx16, a_out)
        dbout_l = s * _mm(z2.to(_BF).T, g16)
        dz2 = (s * _mm(g16, b_out_l.T)).to(_BF)
        daout = _mm(ctx16.T, dz2)
        dctx = dctx + _mm(dz2, a_out.T)

    dctx_h = _split_heads(dctx.to(_BF), b, t, n_heads)
    p16 = p.to(_BF)
    dv = _mm(p16.transpose(-1, -2), dctx_h)
    dp = _mm(dctx_h, v.transpose(-1, -2))
    ds16 = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(_BF)
    dq = _mm(ds16, k) * scale
    dk = _mm(ds16.transpose(-1, -2), q) * scale
    dqkv = torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)],
                     dim=-1)
    dqkv16 = dqkv.to(_BF)
    if weight_grads:
        dwqkv = _mm(h.T, dqkv16)
        dbqkv = dqkv.sum(0)
    dh = _mm(dqkv16, w_qkv16.T)
    if lt is not None:
        dz = (s * _mm(dqkv16, b_in.T)).to(_BF)
        dain = _mm(h.T, dz)
        dbin = s * _mm(z.to(_BF).T, dqkv16)
        dh = dh + _mm(dz, a_in.T)
        dlora = {"a_in": dain, "b_in": dbin, "a_out": daout, "b_out": dbout_l}

    if weight_grads:
        dls = (dh * xhat).sum(0)
        dlb = dh.sum(0)
    dxhat = dh * ln_scale.float()
    dx_ln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = (g32 + dx_ln).reshape(b, t, d).to(x.dtype)
    return (dx, dls, dlb, dwqkv, dbqkv, dwout, dbout), dlora


# ---------------------------------------------------------------------------
# CUDA kernel chains
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _row_splits(m_blocks_n_blocks: int, k: int) -> int:
    """Split-K factor for a contraction over all B*T rows: enough blocks to
    fill the card's 132 SMs twice, and at least 256 rows per split."""
    want = -(-264 // max(m_blocks_n_blocks, 1))
    return max(1, min(want, k // 256))


def _gemm(out, a, a_strides, b, b_strides, m, n, k, *, alpha=1.0, bias=None,
          lz=None, lb=None, lscale=0.0, resid=None, splits=1):
    """out (m, n) = epilogue(alpha * A @ B) on the card; see ``llc_gemm``.
    ``lz``/``lb`` are (tensor, stride, stride) for the LoRA epilogue term."""
    assert out.dim() == 2 and out.stride(1) == 1
    ws = None
    if splits == -1:   # auto: a contraction over all B*T rows
        splits = _row_splits(-(-n // 128) * -(-m // 128), k)
    if splits > 1:
        ws = torch.empty(splits * m * n, dtype=torch.float32,
                         device=out.device)
    lzt, szm, szr = lz if lz is not None else (None, 0, 0)
    lbt, slr, sln = lb if lb is not None else (None, 0, 0)
    r = lzt.shape[1] if lzt is not None else 0
    _kernels.call(
        "llc_gemm", _DT[out.dtype], m, n, k, a.data_ptr(), a_strides[0],
        a_strides[1], b.data_ptr(), b_strides[0], b_strides[1], alpha,
        _ptr(bias), _ptr(lzt), szm, szr, _ptr(lbt), slr, sln, r, lscale,
        _ptr(resid), resid.stride(0) if resid is not None else 0,
        out.data_ptr(), out.stride(0), splits, _ptr(ws), _stream(out))
    return out


def _colsum(x2d):
    m, n = x2d.shape
    ws = torch.empty(-(-m // 128) * n, dtype=torch.float32, device=x2d.device)
    out = torch.empty(n, dtype=torch.float32, device=x2d.device)
    _kernels.call("llc_colsum", _DT[x2d.dtype], x2d.data_ptr(), m, n,
                  ws.data_ptr(), out.data_ptr(), _stream(x2d))
    return out


def _check_cuda(x, n_heads):
    if x.dtype not in _DT:
        raise TypeError(f"fused_ln_attention_block: x must be bf16 or f32, "
                        f"got {x.dtype}")
    b, t, d = x.shape
    dh = d // n_heads
    if d % n_heads or dh not in (16, 32, 64) or -(-t // 16) * 16 > 256 \
            or d > 1024:
        raise ValueError(f"fused_ln_attention_block kernels take head dim "
                         f"16/32/64, D <= 1024 and T <= 256; got D={d}, "
                         f"heads={n_heads}, T={t}")


class _Prepared:
    """Operands in the kernels' layouts: weights and LoRA factors bf16 (as the
    TPU wrapper casts them), LN params and biases fp32, contiguous."""

    def __init__(self, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, mask,
                 lora, lora_scaling):
        def f32(a):
            return a.detach().to(torch.float32).contiguous()

        def b16(a):
            return a.detach().to(_BF).contiguous()

        self.x = x.detach().contiguous()
        b, t, d = x.shape
        self.b, self.t, self.d, self.m = b, t, d, b * t
        self.gamma, self.beta = f32(ln_scale), f32(ln_bias)
        self.w_qkv, self.w_out = b16(w_qkv), b16(w_out)
        self.b_qkv = f32(b_qkv)
        self.b_out = f32(b_out) if b_out is not None else None
        self.mask = _mask32(mask, t, x.device)
        lt = _lora16(lora, lora_scaling)
        self.lora = None if lt is None else tuple(
            a.detach().contiguous() for a in lt)
        self.s = float(lora_scaling)
        self.r = self.lora[0].shape[1] if self.lora is not None else 0
        self.stream = _stream(x)


def _cuda_recompute(pp: _Prepared, n_heads, need_ctx=True):
    """h16, z16, qkv16, ctx16 of the forward, on the card."""
    m, d, r = pp.m, pp.d, pp.r
    dev = pp.x.device
    h16 = torch.empty(m, d, dtype=_BF, device=dev)
    _kernels.call("llc_ln_fwd", _DT[pp.x.dtype], pp.x.data_ptr(),
                  pp.gamma.data_ptr(), pp.beta.data_ptr(), h16.data_ptr(),
                  m, d, EPS, pp.stream)
    z16 = None
    if pp.lora is not None:
        z16 = _gemm(torch.empty(m, r, dtype=_BF, device=dev), h16, (d, 1),
                    pp.lora[0], (r, 1), m, r, d)
    qkv16 = _gemm(torch.empty(m, 3 * d, dtype=_BF, device=dev), h16, (d, 1),
                  pp.w_qkv, (3 * d, 1), m, 3 * d, d, bias=pp.b_qkv,
                  lz=(z16, r, 1) if z16 is not None else None,
                  lb=(pp.lora[1], 3 * d, 1) if z16 is not None else None,
                  lscale=pp.s)
    ctx16 = None
    if need_ctx:
        ctx16 = torch.empty(m, d, dtype=_BF, device=dev)
        _kernels.call("llc_attn_fwd", qkv16.data_ptr(), _ptr(pp.mask),
                      ctx16.data_ptr(), pp.b, pp.t, d, n_heads,
                      (d // n_heads) ** -0.5, pp.stream)
    return h16, z16, qkv16, ctx16


def _cuda_forward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, n_heads,
                  lora_scaling, mask, lora):
    _check_cuda(x, n_heads)
    pp = _Prepared(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, mask,
                   lora, lora_scaling)
    m, d, r = pp.m, pp.d, pp.r
    _, _, _, ctx16 = _cuda_recompute(pp, n_heads)
    z2 = None
    if pp.lora is not None:
        z2 = _gemm(torch.empty(m, r, dtype=_BF, device=x.device), ctx16,
                   (d, 1), pp.lora[2], (r, 1), m, r, d)
    x2 = pp.x.view(m, d)
    y = _gemm(torch.empty_like(x2), ctx16, (d, 1), pp.w_out, (d, 1), m, d, d,
              bias=pp.b_out, lz=(z2, r, 1) if z2 is not None else None,
              lb=(pp.lora[3], d, 1) if z2 is not None else None,
              lscale=pp.s, resid=x2)
    LAUNCHES["fused_ln_attention_fwd"] += 1
    return y.view(pp.b, pp.t, d)


def _cuda_backward(x, g, ln_scale, ln_bias, w_qkv, b_qkv, w_out, n_heads,
                   lora_scaling, mask, lora, weight_grads):
    _check_cuda(x, n_heads)
    pp = _Prepared(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, None, mask,
                   lora, lora_scaling)
    m, d, r, s = pp.m, pp.d, pp.r, pp.s
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    h16, z16, qkv16, ctx16 = _cuda_recompute(
        pp, n_heads, need_ctx=weight_grads or pp.lora is not None)
    g2 = g.detach().to(x.dtype).contiguous().view(m, d)
    if g2.dtype == _BF:
        g16 = g2
    else:
        g16 = torch.empty(m, d, dtype=_BF, device=dev)
        _kernels.call("llc_cast_bf16", _DT[g2.dtype], g2.data_ptr(),
                      g16.data_ptr(), m * d, pp.stream)

    zeros = (torch.zeros(d, **f32), torch.zeros(d, **f32),
             torch.zeros(d, 3 * d, **f32), torch.zeros(3 * d, **f32),
             torch.zeros(d, d, **f32), torch.zeros(d, **f32))
    dls, dlb, dwqkv, dbqkv, dwout, dbout = zeros
    if weight_grads:
        dwout = _gemm(torch.empty(d, d, **f32), ctx16, (1, d), g16, (d, 1),
                      d, d, m, splits=-1)
        dbout = _colsum(g2)
    dlora = None
    dz2 = None
    if pp.lora is not None:
        a_in, b_in, a_out, b_out_l = pp.lora
        z2 = _gemm(torch.empty(m, r, dtype=_BF, device=dev), ctx16, (d, 1),
                   a_out, (r, 1), m, r, d)
        dz2 = _gemm(torch.empty(m, r, dtype=_BF, device=dev), g16, (d, 1),
                    b_out_l, (1, d), m, r, d, alpha=s)
        dbout_l = _gemm(torch.empty(r, d, **f32), z2, (1, r), g16, (d, 1),
                        r, d, m, alpha=s, splits=-1)
        daout = _gemm(torch.empty(d, r, **f32), ctx16, (1, d), dz2, (r, 1),
                      d, r, m, splits=-1)
    dctx16 = _gemm(torch.empty(m, d, dtype=_BF, device=dev), g16, (d, 1),
                   pp.w_out, (1, d), m, d, d,
                   lz=(dz2, r, 1) if dz2 is not None else None,
                   lb=(pp.lora[2], 1, r) if dz2 is not None else None,
                   lscale=1.0)

    dqkv16 = torch.empty(m, 3 * d, dtype=_BF, device=dev)
    dqkv32 = torch.empty(m, 3 * d, **f32) if weight_grads else None
    stats = torch.empty(pp.b * n_heads * pp.t * 3, **f32)
    _kernels.call("llc_attn_bwd", qkv16.data_ptr(), dctx16.data_ptr(),
                  _ptr(pp.mask), dqkv16.data_ptr(), _ptr(dqkv32),
                  stats.data_ptr(), pp.b, pp.t, d, n_heads,
                  (d // n_heads) ** -0.5, pp.stream)

    dz = None
    if pp.lora is not None:
        dz = _gemm(torch.empty(m, r, dtype=_BF, device=dev), dqkv16,
                   (3 * d, 1), b_in, (1, 3 * d), m, r, 3 * d, alpha=s)
        dain = _gemm(torch.empty(d, r, **f32), h16, (1, d), dz, (r, 1),
                     d, r, m, splits=-1)
        dbin = _gemm(torch.empty(r, 3 * d, **f32), z16, (1, r), dqkv16,
                     (3 * d, 1), r, 3 * d, m, alpha=s, splits=-1)
        dlora = {"a_in": dain, "b_in": dbin, "a_out": daout, "b_out": dbout_l}
    dh = _gemm(torch.empty(m, d, **f32), dqkv16, (3 * d, 1), pp.w_qkv,
               (1, 3 * d), m, d, 3 * d,
               lz=(dz, r, 1) if dz is not None else None,
               lb=(pp.lora[0], 1, r) if dz is not None else None, lscale=1.0)
    if weight_grads:
        dwqkv = _gemm(torch.empty(d, 3 * d, **f32), h16, (1, d), dqkv16,
                      (3 * d, 1), d, 3 * d, m, splits=-1)
        dbqkv = _colsum(dqkv32)

    dx = torch.empty_like(pp.x)
    dhx = torch.empty(m, d, **f32) if weight_grads else None
    _kernels.call("llc_ln_bwd", _DT[x.dtype], pp.x.data_ptr(),
                  pp.gamma.data_ptr(), dh.data_ptr(), g2.data_ptr(),
                  dx.data_ptr(), _ptr(dhx), m, d, EPS, pp.stream)
    if weight_grads:
        dls = _colsum(dhx)
        dlb = _colsum(dh)
    LAUNCHES["fused_ln_attention_bwd"] += 1
    return (dx, dls, dlb, dwqkv, dbqkv, dwout, dbout), dlora


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _forward(x, *args):
    if x.device.type == "cpu":
        return fused_ln_attention_block_reference(x, *args)
    if x.device.type == "cuda":
        return _cuda_forward(x, *args)
    raise RuntimeError(f"fused_ln_attention_block: no kernel for {x.device}")


def _backward(x, g, *args):
    if x.device.type == "cpu":
        return fused_ln_attention_block_reference_bwd(x, g, *args)
    if x.device.type == "cuda":
        return _cuda_backward(x, g, *args)
    raise RuntimeError(f"fused_ln_attention_block: no kernel for {x.device}")


class _FusedLNAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, a_in,
                b_in, a_out, b_out_l, n_heads, lora_scaling, mask,
                weight_grads):
        lora = None if a_in is None else {
            "a_in": a_in, "b_in": b_in, "a_out": a_out, "b_out": b_out_l}
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                              b_out, a_in, b_in, a_out, b_out_l)
        ctx.n_heads, ctx.lora_scaling = n_heads, lora_scaling
        ctx.mask, ctx.weight_grads = mask, weight_grads
        return _forward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                        n_heads, lora_scaling, mask, lora)

    @staticmethod
    def backward(ctx, g):
        (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, a_in, b_in, a_out,
         b_out_l) = ctx.saved_tensors
        lora = None if a_in is None else {
            "a_in": a_in, "b_in": b_in, "a_out": a_out, "b_out": b_out_l}
        grads, dlora = _backward(x, g, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                                 ctx.n_heads, ctx.lora_scaling, ctx.mask,
                                 lora, ctx.weight_grads)
        primals = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out)
        # grads come back in each primal's dtype (``_fused_bwd:236-245``):
        # bf16 LoRA primals get bf16-rounded grads, as on the TPU. Frozen
        # primals get none.
        out = tuple(gr.to(p.dtype).reshape(p.shape) if need else None
                    for gr, p, need in zip(grads, primals,
                                           ctx.needs_input_grad))
        if lora is None:
            dl = (None,) * 4
        elif dlora is None:   # lora_scaling == 0: the LoRA terms are absent
            dl = tuple(torch.zeros_like(lora[k])
                       for k in ("a_in", "b_in", "a_out", "b_out"))
        else:
            dl = tuple(dlora[k].to(lora[k].dtype)
                       for k in ("a_in", "b_in", "a_out", "b_out"))
        return out + dl + (None, None, None, None)


def fused_ln_attention_block(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                             n_heads: int, lora_scaling: float = 0.0,
                             mask=None, lora=None, weight_grads: bool = True):
    """x (B, T, D) -> x + out_proj(MHA(LN(x))), with the JAX op's signature.

    ``mask``: additive, broadcastable to (T, T). ``lora``: dict of ``a_in``
    (D, r), ``b_in`` (r, 3D), ``a_out`` (D, r), ``b_out`` (r, D).
    ``weight_grads=False`` asserts the base block weights are not trained:
    their grads come back as exact zeros and the backward skips that work.
    """
    la = (None,) * 4 if lora is None else tuple(
        lora[k] for k in ("a_in", "b_in", "a_out", "b_out"))
    return _FusedLNAttention.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                                   b_out, *la, int(n_heads),
                                   float(lora_scaling), mask,
                                   bool(weight_grads))
