"""Fused attention half block: y = x + out_proj(MHA(LN(x))), forward and
backward, and its KV-prefix variant.

Counterpart of ``lifelong_clip_tpu/ops/fused_block_attn.py:
fused_ln_attention_block`` (``:202-218``): fp32 LayerNorm, bf16 qkv with an
optional in-kernel LoRA term ``s * (h @ A_in) @ B_in``, per-head fp32 softmax
with an additive (T, T) mask, out projection with its own LoRA term, and the
residual. The backward emits dx and the LoRA grads, the LN and base-weight
grads only when ``weight_grads``. On the card it reads the forward's h, qkv
and ctx, which the forward keeps whenever autograd will call the backward
(grad enabled and an input that needs it; under ``torch.utils.checkpoint``
the recomputed forward keeps them), where the TPU kernel recomputes them.

Kernels and the TPU kernels they replace:

* forward: ``csrc/fused_block_attn.cu`` (LN, GEMM with bias/LoRA/residual
  epilogue, attention forward), replacing ``_kernel`` (``:56``, Pallas call
  at ``:161``);
* backward: the same source (LN backward, GEMMs, attention backward, column
  sums), replacing ``_bwd_kernel`` (``:258``, Pallas call at ``:478``).

With LoRA of rank <= ``FOLD_RMAX`` and D a multiple of ``FOLD_DMULT`` the
rank-r products go into the GEMMs that stream their operands
(``_gemm_lora``), as the TPU kernels compute them in their bodies: z and
z2 in the qkv and out products, dz2 and dz in the dctx and dh products,
which also write the LoRA grads' fixed-order partials; the chains then have
no launch of their own for any LoRA term. Other ranks and widths take the
unfolded road (a launch for each rank-r product).

``fused_prefix_attention_block`` is the counterpart of the JAX op of that
name (``:652-696``): the same half block without LoRA, whose keys come from
[pk; LN(x)] and values from [pv; LN(x)] under an additive (T, P + T) mask.
Its forward replaces ``_prefix_kernel`` (``:524``, Pallas call at ``:631``)
and its backward ``_prefix_bwd_kernel`` (``:699``, Pallas call at ``:897``),
with the same kernel chain: a prefix K/V GEMM beside the token qkv GEMM, and
attention kernels that read their keys from both (under a (P + T,) key-mask
row at head dim 64 and P + T <= 256, the prompted passes' road, the
warpgroup-MMA kernels of ``csrc/attn_wgmma.cu``; ``prefix_wgmma_road``).
Under a (T, P + T) mask (ProtoCLIP's block-diagonal suffix mask) each
chain first builds the mask's tile map on the card (``mask_tile_map``: one
byte per 16 query rows x 16 keys, 0 where every entry is -inf) and the
attention kernels skip the blocks it marks dead; those hold p = 0 exactly,
so the values are those of the full sweep bit for bit. The block op does
the same under a (T, T) mask (the text tower's causal mask: 15 of 25
blocks live at T = 77), its map built once per mask tensor (``_tile_map``:
the blocks of a tower pass share one). The map's kernel replaces no TPU
kernel: the TPU kernels compute every tile.

Bound on one H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the ViT-B/16 vision
block, bs=64: forward ~67.1 GFLOP (~68 us, compute-bound); backward with
``weight_grads=False`` ~127 GFLOP (~128 us, compute-bound). The first port
runs the op as a chain of kernels whose intermediates (h, qkv, ctx, dctx,
dqkv, dh) go through device memory where the TPU kernel kept them in VMEM;
fusing them back is the first target of a later redesign. Weight-type grads
are contractions over all B*T rows done as GEMMs split over K only where
the tiles would leave SMs idle (``_weight_grad_splits``), whose partials a
second pass sums in a fixed order; the bias and LN grads are folded into
the kernels that make the rows (the attention backward's column sums of
each 16-row group of dq, dk and dv) and one column-parallel pass after the
LN backward (dh * xhat, dh and g over chunks of rows), whose partials one
launch sums in a fixed order: no
float atomics, as the TPU kernel's sequential grid had none. The LN params
and biases are read in their own dtype (no cast launches at the head of a
chain). At the ER family's 16 and 8 batch rows the attention kernels split
each (head, batch row) over blocks, each row's arithmetic unchanged.

Beside the kernels sit their plain PyTorch versions,
``fused_ln_attention_block_reference`` and
``fused_ln_attention_block_reference_bwd`` (and the prefix twins
``fused_prefix_attention_block_reference`` and ``..._reference_bwd``),
which repeat the TPU kernels' arithmetic and bf16 rounding points. The op takes them only for tensors on
the CPU; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import _kernels

EPS = 1e-5
_BF = torch.bfloat16
_DT = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel chain: one per op call on a CUDA tensor; and of
# the tile-map kernel: one per prefix chain under a (T, P + T) mask
# (prefix_tile_map), one per (T, T) mask tensor of the block op
# (block_tile_map, ``_tile_map``); and of the warpgroup-MMA attention
# kernels: one per forward or backward chain on their road, the block
# chains' (``attention_road``: attn_fwd_wgmma, attn_bwd_wgmma up to 256
# keys, attn_fwd_wgmma_long, attn_bwd_wgmma_long past them) and the prefix
# chains' (``prefix_wgmma_road``: attn_prefix_fwd_wgmma,
# attn_prefix_bwd_wgmma)
LAUNCHES = {"fused_ln_attention_fwd": 0, "fused_ln_attention_bwd": 0,
            "fused_prefix_attention_fwd": 0, "fused_prefix_attention_bwd": 0,
            "prefix_tile_map": 0, "block_tile_map": 0, "attn_fwd_wgmma": 0,
            "attn_bwd_wgmma": 0, "attn_fwd_wgmma_long": 0,
            "attn_bwd_wgmma_long": 0, "attn_prefix_fwd_wgmma": 0,
            "attn_prefix_bwd_wgmma": 0}


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


def _mask32(mask, t, s, device):
    """The additive mask as a contiguous fp32 (T, S) matrix, or None."""
    if mask is None:
        return None
    return torch.broadcast_to(mask.to(device=device, dtype=torch.float32),
                              (t, s)).contiguous()


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
    p = _probs(q, k, _mask32(mask, t, t, x.device), scale)
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
    """Split-K factor for a LoRA grad (a contraction over all B*T rows on
    the rank-r tiles): enough blocks to fill the card's 132 SMs twice, and
    at least 256 rows per split."""
    want = -(-264 // max(m_blocks_n_blocks, 1))
    return max(1, min(want, k // 256))


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the weight grads' split-K cost model, in one 128 x 128 x 64 step of the
# wgmma GEMM on one SM (~0.5 us on an H100): the split-K reduction's launch,
# and the fp32 bytes one step's time moves
_STEP_LAUNCH, _STEP_BYTES = 6.0, 1.5e6


def _weight_grad_splits(m: int, n: int, k: int, sms: int) -> int:
    """Split-K factor for a weight grad, an (m, n) fp32 contraction over
    all k = B*T rows on the wgmma tiles: the one that finishes soonest, its
    tiles' rounds over the card's SMs (the persistent GEMM) against the
    fp32 partials the split writes and a second launch sums. The tile is
    the launcher's (``launch_gemm``: 128 x 256 only for N >= 2048 where
    those tiles fill the SMs). At 16 batch rows this takes dW_qkv unsplit
    on 108 tiles and dW_out in 3 splits of 36 where the fixed 264-block
    rule took 3 and 8."""
    best, best_cost = 1, None
    for want in range(1, max(1, k // 256) + 1):
        kps = -(-(-(-k // want)) // 64) * 64
        s = -(-k // kps)
        tiles_m = -(-m // 128)
        bn = 256 if n >= 2048 and -(-n // 256) * tiles_m * s >= sms else 128
        tiles = -(-n // bn) * tiles_m * s
        cost = -(-tiles // sms) * (kps // 64) * (bn // 128)
        if s > 1:
            cost += _STEP_LAUNCH + 2 * s * m * n * 4 / _STEP_BYTES
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _gemm(out, a, a_strides, b, b_strides, m, n, k, *, alpha=1.0, bias=None,
          lz=None, lb=None, lscale=0.0, resid=None, splits=1, groups=None):
    """out (m, n) = epilogue(alpha * A @ B) on the card; see ``llc_gemm``.
    ``lz``/``lb`` are (tensor, stride, stride) for the LoRA epilogue term;
    ``bias`` fp32 or bf16. ``groups`` (count, gm, gn): one launch of
    ``count`` such products, the g-th reading A rows g * gm on and B
    columns g * gn on into out (and bias) columns g * gn on. ``splits``:
    -1 a LoRA grad's (``_row_splits``), -2 a weight grad's
    (``_weight_grad_splits``)."""
    assert out.dim() == 2 and out.stride(1) == 1
    ws = None
    if splits == -1:   # auto: a LoRA grad over all B*T rows
        splits = _row_splits(-(-n // 128) * -(-m // 128), k)
    elif splits == -2:   # auto: a weight grad over all B*T rows
        splits = _weight_grad_splits(m, n, k, _sm_count(out.device.index))
    if splits > 1:
        ws = torch.empty(splits * m * n, dtype=torch.float32,
                         device=out.device)
    lzt, szm, szr = lz if lz is not None else (None, 0, 0)
    lbt, slr, sln = lb if lb is not None else (None, 0, 0)
    r = lzt.shape[1] if lzt is not None else 0
    _kernels.call(
        "llc_gemm", _DT[out.dtype], m, n, k, a.data_ptr(), a_strides[0],
        a_strides[1], b.data_ptr(), b_strides[0], b_strides[1], alpha,
        _ptr(bias), _DT[bias.dtype] if bias is not None else 0, _ptr(lzt),
        szm, szr, _ptr(lbt), slr, sln, r, lscale,
        _ptr(resid), resid.stride(0) if resid is not None else 0,
        out.data_ptr(), out.stride(0), splits, _ptr(ws),
        *(groups or (1, 0, 0)), _stream(out))
    return out


# the LoRA ranks the folded GEMMs take (``FOLD_RMAX`` in the source: their
# narrow products are 8 wide), and the widths (each column tile of their
# backward takes a fixed share of the k-steps); another rank or width keeps
# the rank-r launches of the unfolded road
FOLD_RMAX, FOLD_DMULT = 8, 128


def _gemm_lora(out, a, a_strides, b, b_strides, m, n, k, ft, r, *, zalpha,
               lscale, lb, bias=None, zout=None, zin=None, pb=None, xa=None,
               pa=None, resid=None):
    """out (m, n) = bias + A @ B + lscale * Z @ L (+ resid) on the card in
    one launch, Z = bf16(zalpha * A @ F) formed on the A tiles the product
    streams (``llc_gemm_lora``). ``ft``: F^T (r, k) bf16, its rows
    contiguous (TMA reads it beside each A tile); ``lb``: (tensor, stride,
    stride) of L (r x n). ``zout`` (r, ``_z_cols(m)``) bf16: Z^T for the
    backward. ``pb`` / ``pa``: fp32 partials, one a 64-row block
    (``_lora_blocks``), of zin^T @ A (r x k; ``zin`` as ``zout``) and xa^T
    @ Z (n x r, ``xa`` (m, n) bf16), which ``_sum_partials`` adds in a
    fixed order."""
    assert out.dim() == 2 and out.stride(1) == 1 and ft.stride(1) == 1
    lbt, slr, sln = lb
    zt = zout if zout is not None else zin
    _kernels.call(
        "llc_gemm_lora", _DT[out.dtype], m, n, k, a.data_ptr(), a_strides[0],
        a_strides[1], b.data_ptr(), b_strides[0], b_strides[1], _ptr(bias),
        _DT[bias.dtype] if bias is not None else 0, ft.data_ptr(),
        ft.stride(0), r, zalpha, lscale, lbt.data_ptr(), slr, sln,
        _ptr(zout), _ptr(zin), zt.stride(0) if zt is not None else 0,
        _ptr(pb), _ptr(xa), xa.stride(0) if xa is not None else 0, _ptr(pa),
        _ptr(resid), resid.stride(0) if resid is not None else 0,
        out.data_ptr(), out.stride(0), _stream(out))
    return out


def _lora_blocks(m: int) -> int:
    """The folded GEMMs' partial blocks: 64 rows each, two a 128-row tile."""
    return 2 * -(-m // 128)


def _z_cols(m: int) -> int:
    """The row stride of a folded GEMM's Z^T (r, m): m rounded up to 8
    elements, the 16 bytes TMA steps rows by."""
    return -(-m // 8) * 8


def _lora_partials(pp):
    """The folded chain's LoRA grads, fp32 views of one buffer, the fp32
    partials the dctx and dh products write for them (``_gemm_lora``: one
    a 64-row block, their rows one after another), and the segments of the
    sums (``_sum_partials``) that give the grads: dB_out (r, D), dA_out (D,
    r), dB_in (r, 3D), dA_in (D, r), dB times the LoRA scale."""
    r, d, nb = pp.r, pp.d, _lora_blocks(pp.m)
    shapes = {"b_out": (r, d), "a_out": (d, r), "b_in": (r, 3 * d),
              "a_in": (d, r)}
    f32 = dict(dtype=torch.float32, device=pp.x.device)
    part = torch.empty(nb * r * 6 * d, **f32)
    sums = torch.empty(r * 6 * d, **f32)
    grads, parts, segs, off = {}, {}, [], 0
    for key, (rows, cols) in shapes.items():
        n = rows * cols
        grads[key] = sums[off:off + n].view(rows, cols)
        parts[key] = part[nb * off:nb * (off + n)]
        segs.append((parts[key], nb, n, grads[key],
                     pp.s if key.startswith("b") else 1.0))
        off += n
    return grads, parts, segs


def _sum_partials(pp, segs):
    """One launch of the fixed-order sums (``llc_partial_sums``): each of
    ``segs`` (part, rows, n, out, scale) puts scale * the sum over the rows
    of the (rows, n) fp32 partials ``part`` into the n floats of ``out``."""
    desc, scales = [], []
    for part, rows, n, out, scale in segs:
        desc += [part.data_ptr(), out.data_ptr(), rows, n]
        scales.append(scale)
    arr = (ctypes.c_longlong * len(desc))(*desc)
    sc = (ctypes.c_float * len(scales))(*scales)
    _kernels.call("llc_partial_sums", len(segs), ctypes.addressof(arr),
                  ctypes.addressof(sc), pp.stream)


def _check_cuda(x, n_heads, op="fused_ln_attention_block"):
    """Raise on what the kernels do not take: head dims other than 16, 32 or
    64, and D > 1024 (the LN kernels hold a row in one warp's registers).
    Any number of keys S = P + T is taken."""
    if x.dtype not in _DT:
        raise TypeError(f"{op}: x must be bf16 or f32, got {x.dtype}")
    b, t, d = x.shape
    dh = d // n_heads
    if d % n_heads or dh not in (16, 32, 64) or d > 1024:
        raise ValueError(f"{op} kernels take head dim 16/32/64 and "
                         f"D <= 1024; got D={d}, heads={n_heads}, T={t}")


def _param(a):
    """An LN param or bias as the kernels read it: contiguous, in its own
    dtype where that is fp32 or bf16 (the kernels convert on load, so the
    chain casts nothing first), else fp32."""
    a = a.detach()
    return a.to(a.dtype if a.dtype in _DT else torch.float32).contiguous()


# tile maps of the block op's (T, T) masks by the mask tensor: the blocks of
# a tower pass share one mask, so its map is built once (a map a call would
# cost a launch of ~6% of ProtoCLIP's T = 25 forward chain on an H100). An
# entry goes with its mask; another version of the mask (an in-place write)
# or another T or device builds anew.
_MAPS = WeakIdKeyDictionary()


def _tile_map(mask, mask32):
    """The tile map (``mask_tile_map``) of ``mask32``, the kernels' copy of
    the (T, T) tensor ``mask``, built once while ``mask`` lives unchanged."""
    key = (mask._version, mask32.shape[0], mask32.device)
    hit = _MAPS.get(mask)
    if hit is None or hit[0] != key:
        hit = _MAPS[mask] = (key, mask_tile_map(mask32, "block_tile_map"))
    return hit[1]


def _mask_and_map(mask, t, device, tile_map=True):
    """The mask as the block kernels take it (``_mask32``: fp32 (T, T) or
    None) and, for a 2-D (T, T) mask, its tile map (``_tile_map``), whose
    dead blocks the attention kernels skip; no map for no mask or one that
    broadcasts to (T, T) (a key-mask row), nor with ``tile_map=False``
    (every block swept: the same values bit for bit, the yardstick)."""
    mask32 = _mask32(mask, t, t, device)
    square = mask is not None and tuple(mask.shape) == (t, t)
    return mask32, (_tile_map(mask, mask32) if square and tile_map
                    else None)


class _Prepared:
    """Operands in the kernels' layouts: weights and LoRA factors bf16 (as the
    TPU wrapper casts them), LN params and biases in their own dtype (fp32
    or bf16, ``_param``), contiguous; the mask fp32 (T, T) with its tile map
    (``_mask_and_map``)."""

    def __init__(self, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, mask,
                 lora, lora_scaling, tile_map=True):
        def b16(a):
            return a.detach().to(_BF).contiguous()

        self.x = x.detach().contiguous()
        b, t, d = x.shape
        self.b, self.t, self.d, self.m = b, t, d, b * t
        # the LN kernels read gamma and beta as one type
        self.gamma, self.beta = _param(ln_scale), _param(ln_bias)
        if self.gamma.dtype != self.beta.dtype:
            self.gamma, self.beta = self.gamma.float(), self.beta.float()
        self.w_qkv, self.w_out = b16(w_qkv), b16(w_out)
        self.b_qkv = _param(b_qkv)
        self.b_out = _param(b_out) if b_out is not None else None
        self.mask, self.tmap = _mask_and_map(mask, t, x.device, tile_map)
        lt = _lora16(lora, lora_scaling)
        self.lora = None if lt is None else tuple(
            a.detach().contiguous() for a in lt)
        self.s = float(lora_scaling)
        self.r = self.lora[0].shape[1] if self.lora is not None else 0
        # the LoRA products inside the GEMMs that stream their operands
        self.fold = 0 < self.r <= FOLD_RMAX and d % FOLD_DMULT == 0
        self.stream = _stream(x)


def _grad_rows(pp: _Prepared, g):
    """The output grad as (B*T, D) rows in x's dtype, and their bf16 copy
    (cast on the card where x is fp32)."""
    g2 = g.detach().to(pp.x.dtype).contiguous().view(pp.m, pp.d)
    if g2.dtype == _BF:
        return g2, g2
    g16 = torch.empty(pp.m, pp.d, dtype=_BF, device=g2.device)
    _kernels.call("llc_cast_bf16", _DT[g2.dtype], g2.data_ptr(),
                  g16.data_ptr(), pp.m * pp.d, pp.stream)
    return g2, g16


# The block chains' road with no mask at head dim 64 and up to 256 keys
# (every ViT tower's blocks): the attention runs on the warpgroup-MMA
# kernels of csrc/attn_wgmma.cu (``attn_wgmma_road`` there), which keep the
# row statistics in shared memory; past 256 keys up to WGMMA_LONG_TMAX
# (ViT-L/14's 257 tokens) on that file's long kernels
# (``attn_wgmma_long_road``, ``ATTN_WGMMA_LONG_TMAX``: the backward holds
# Q, K, V and dctx whole, 6 tiles of 64 rows each), which keep the mma.sync
# tiled road's order of sums.
WGMMA_DH, WGMMA_TMAX, WGMMA_LONG_TMAX = 64, 256, 384


def attention_road(t: int, dh: int, mask_kind=None) -> str:
    """The kernels #1/#2's attention takes at ``t`` tokens and head dim
    ``dh``, with no mask (``mask_kind`` None) or a (T, T) mask ("matrix"):
    "wgmma" (``attn_wgmma_road``: no mask, head dim 64, up to 256 keys),
    "wgmma_long" (``attn_wgmma_long_road``: no mask, head dim 64, 257 up
    to ``WGMMA_LONG_TMAX`` keys) or "mma_sync" (a mask, head dims 16 and
    32, longer rows)."""
    if mask_kind is None and dh == WGMMA_DH:
        if 1 <= t <= WGMMA_TMAX:
            return "wgmma"
        if t <= WGMMA_LONG_TMAX:
            return "wgmma_long"
    return "mma_sync"


def _road(pp: _Prepared, n_heads) -> str:
    return attention_road(pp.t, pp.d // n_heads,
                          None if pp.mask is None else "matrix")


def prefix_wgmma_road(p: int, t: int, dh: int, mask_kind) -> bool:
    """Whether the KV-prefix chains' attention (P prefix keys, T tokens,
    head dim ``dh``) takes the warpgroup-MMA kernels of csrc/attn_wgmma.cu
    (``launch_attn``'s PRE and ROW instances there): under a key-mask row
    (``mask_kind`` "row": one (P + T,) row for every query, as mvp-clip,
    DualPrompt, MVP and ProtoCLIP's image pass pass it) at head dim 64 and
    S = P + T <= 256. A (T, P + T) matrix ("matrix"), no mask (None; the
    mma.sync kernels interleave that road's key blocks, an order of sums
    the half-row windows do not give), other head dims and longer rows
    keep the mma.sync kernels."""
    return mask_kind == "row" and dh == WGMMA_DH and 1 <= p + t <= WGMMA_TMAX


def _prefix_road(pp, n_heads) -> bool:
    kind = None if pp.mask is None else ("matrix" if pp.mask_rs else "row")
    return prefix_wgmma_road(pp.p, pp.t, pp.d // n_heads, kind)


def _stats(pp: _Prepared, n_heads):
    """Workspace of the mma.sync attention backward: a float4 (row max, 1 /
    row sum, delta, 0) for each query row of each (batch row, head), T
    rounded up to 16 (the warpgroup-MMA roads read none)."""
    return torch.empty(pp.b * n_heads * -(-pp.t // 16) * 16 * 4,
                       dtype=torch.float32, device=pp.x.device)


def _ln_part_chunks(m: int, d: int) -> int:
    """The LN partials' row chunks (``ln_part_chunks`` in the source): about
    264 blocks over the 256-column blocks, at least 16 rows each."""
    return max(1, min(-(-m // 16), 264 // -(-d // 256)))


def _bias_rows(pp: _Prepared, s_len):
    """The partial rows of the weight grads' sums: dq's 16-row groups, dk |
    dv's (S = ``s_len`` keys), the LN partials' row chunks."""
    return (pp.b * -(-pp.t // 16), pp.b * -(-s_len // 16),
            _ln_part_chunks(pp.m, pp.d))


def _bias_workspace(pp: _Prepared, s_len):
    """One fp32 buffer for the weight grads' sums (dbqkv (3D), dls, dlb,
    dbout) and the partials the kernels that make the rows write: the
    attention backward's of dq (B * ceil(T/16) groups of D) and of dk | dv
    (B * ceil(S/16) groups of 2D), the LN backward's of dh * xhat, dh and g
    (3 x ``_ln_part_chunks`` row chunks of D, then its (mean, rstd) a row).
    Returns (sums, attention partials, LN workspace)."""
    d = pp.d
    nq, nk, nl = _bias_rows(pp, s_len)
    attn = nq * d + nk * 2 * d
    ws = torch.empty(6 * d + attn + 3 * nl * d + 2 * pp.m,
                     dtype=torch.float32, device=pp.x.device)
    return ws[:6 * d], ws[6 * d:6 * d + attn], ws[6 * d + attn:]


def _bias_segs(pp: _Prepared, s_len, sums, attn_part, ln_part):
    """The sums (``_sum_partials``) of dbqkv, dls, dlb and dbout from the
    partials (``_bias_workspace``) into ``sums``, and those grads as views
    of ``sums``."""
    d = pp.d
    nq, nk, nl = _bias_rows(pp, s_len)
    parts = ((attn_part, 0, nq, d), (attn_part, nq * d, nk, 2 * d),
             (ln_part, 0, nl, d), (ln_part, nl * d, nl, d),
             (ln_part, 2 * nl * d, nl, d))
    segs, out = [], 0
    for buf, off, rows, n in parts:
        segs.append((buf[off:], rows, n, sums[out:], 1.0))
        out += n
    return segs, (sums[:3 * d], sums[3 * d:4 * d], sums[4 * d:5 * d],
                  sums[5 * d:])


def _bias_sums(pp: _Prepared, s_len, sums, attn_part, ln_part):
    """dbqkv, dls, dlb and dbout from the partials (``_bias_workspace``), in
    one launch of the fixed-order sums; views of ``sums``."""
    segs, grads = _bias_segs(pp, s_len, sums, attn_part, ln_part)
    _sum_partials(pp, segs)
    return grads


def _cuda_ln_qkv(pp: _Prepared):
    """h16, z16 (None without LoRA) and qkv16 of the forward, on the card."""
    m, d, r = pp.m, pp.d, pp.r
    dev = pp.x.device
    h16 = torch.empty(m, d, dtype=_BF, device=dev)
    # with the fold the LN kernel also writes A_in^T and A_out^T (pp.ft),
    # the F tiles of the qkv and out products
    pp.ft = torch.empty(2, r, d, dtype=_BF, device=dev) if pp.fold else None
    _kernels.call("llc_ln_fwd", _DT[pp.x.dtype], _DT[pp.gamma.dtype],
                  pp.x.data_ptr(), pp.gamma.data_ptr(), pp.beta.data_ptr(),
                  h16.data_ptr(), m, d, EPS,
                  *((pp.lora[0].data_ptr(), pp.lora[2].data_ptr(),
                     pp.ft.data_ptr(), r) if pp.fold else (None, None, None,
                                                           0)), pp.stream)
    if pp.fold:   # z = h16 @ A_in on the qkv product's own A tiles
        z16 = torch.empty(r, _z_cols(m), dtype=_BF, device=dev)
        qkv16 = _gemm_lora(torch.empty(m, 3 * d, dtype=_BF, device=dev), h16,
                           (d, 1), pp.w_qkv, (3 * d, 1), m, 3 * d, d,
                           pp.ft[0], r, zalpha=1.0, lscale=pp.s,
                           lb=(pp.lora[1], 3 * d, 1), bias=pp.b_qkv,
                           zout=z16)
        return h16, z16, qkv16
    z16 = None
    if pp.lora is not None:
        z16 = _gemm(torch.empty(m, r, dtype=_BF, device=dev), h16, (d, 1),
                    pp.lora[0], (r, 1), m, r, d)
    qkv16 = _gemm(torch.empty(m, 3 * d, dtype=_BF, device=dev), h16, (d, 1),
                  pp.w_qkv, (3 * d, 1), m, 3 * d, d, bias=pp.b_qkv,
                  lz=(z16, r, 1) if z16 is not None else None,
                  lb=(pp.lora[1], 3 * d, 1) if z16 is not None else None,
                  lscale=pp.s)
    return h16, z16, qkv16


def _cuda_forward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, n_heads,
                  lora_scaling, mask, lora, keep=False, tile_map=True):
    """y on the card; with ``keep``, (y, (h16, z16, qkv16, ctx16, z2_16))
    for the backward chain to read (z16 and z2_16 None without LoRA).
    ``tile_map=False`` sweeps every block of a (T, T) mask (the yardstick
    of the skipping kernels)."""
    _check_cuda(x, n_heads)
    pp = _Prepared(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, mask,
                   lora, lora_scaling, tile_map)
    m, d, r = pp.m, pp.d, pp.r
    h16, z16, qkv16 = _cuda_ln_qkv(pp)
    ctx16 = torch.empty(m, d, dtype=_BF, device=x.device)
    _kernels.call("llc_attn_fwd", qkv16.data_ptr(), _ptr(pp.mask),
                  _ptr(pp.tmap), ctx16.data_ptr(), pp.b, pp.t, d, n_heads,
                  (d // n_heads) ** -0.5, pp.stream)
    x2 = pp.x.view(m, d)
    z2 = None
    if pp.fold:   # z2 = ctx16 @ A_out on the out product's own A tiles
        z2 = torch.empty(r, _z_cols(m), dtype=_BF, device=x.device)
        y = _gemm_lora(torch.empty_like(x2), ctx16, (d, 1), pp.w_out, (d, 1),
                       m, d, d, pp.ft[1], r, zalpha=1.0,
                       lscale=pp.s, lb=(pp.lora[3], d, 1), bias=pp.b_out,
                       zout=z2, resid=x2)
    else:
        if pp.lora is not None:
            z2 = _gemm(torch.empty(m, r, dtype=_BF, device=x.device), ctx16,
                       (d, 1), pp.lora[2], (r, 1), m, r, d)
        y = _gemm(torch.empty_like(x2), ctx16, (d, 1), pp.w_out, (d, 1), m,
                  d, d, bias=pp.b_out,
                  lz=(z2, r, 1) if z2 is not None else None,
                  lb=(pp.lora[3], d, 1) if z2 is not None else None,
                  lscale=pp.s, resid=x2)
    saved = (h16, z16, qkv16, ctx16, z2)
    LAUNCHES["fused_ln_attention_fwd"] += 1
    road = _road(pp, n_heads)
    LAUNCHES["attn_fwd_wgmma"] += road == "wgmma"
    LAUNCHES["attn_fwd_wgmma_long"] += road == "wgmma_long"
    y = y.view(pp.b, pp.t, d)
    return (y, saved) if keep else y


def _cuda_backward(x, g, ln_scale, ln_bias, w_qkv, b_qkv, w_out, n_heads,
                   lora_scaling, mask, lora, weight_grads, saved,
                   tile_map=True):
    """The backward chain on the card. ``saved``: the forward's (h16, z16,
    qkv16, ctx16, z2_16), those the backward reads (``_keep_for_backward``
    of ``_cuda_forward(..., keep=True)``). The block grads (dls, dlb,
    dwqkv, dbqkv, dwout, dbout) are None without ``weight_grads`` (the op
    gives exact zeros to a primal that needs a grad); with it the bias and
    LN grads come from the partials the attention and LN backward write,
    summed in one launch. With LoRA (rank <= ``FOLD_RMAX``) the dctx and
    dh products form dz2 / dz and the LoRA grads' partials on the tiles
    they stream (``_gemm_lora``), which that launch sums too. ``tile_map``
    as the forward's."""
    _check_cuda(x, n_heads)
    pp = _Prepared(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, None, mask,
                   lora, lora_scaling, tile_map)
    m, d, r, s = pp.m, pp.d, pp.r, pp.s
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    h16, z16, qkv16, ctx16, z2 = saved
    g2, g16 = _grad_rows(pp, g)

    grads = (None,) * 6
    sums = attn_part = ln_part = None
    if weight_grads:
        sums, attn_part, ln_part = _bias_workspace(pp, pp.t)
        dwout = _gemm(torch.empty(d, d, **f32), ctx16, (1, d), g16, (d, 1),
                      d, d, m, splits=-2)
    dlora, segs = None, []
    if pp.fold:
        a_in, b_in, a_out, b_out_l = pp.lora
        dlora, part, segs = _lora_partials(pp)
        # dctx = g16 W_out^T + dz2 A_out^T, dz2 = bf16(s g16 B_out^T) formed
        # on g16's tiles; dB_out's partials of z2^T g16 and dA_out's of
        # ctx16^T dz2
        dctx16 = _gemm_lora(torch.empty(m, d, dtype=_BF, device=dev), g16,
                            (d, 1), pp.w_out, (1, d), m, d, d,
                            b_out_l, r, zalpha=s, lscale=1.0,
                            lb=(a_out, 1, r), zin=z2, pb=part["b_out"],
                            xa=ctx16, pa=part["a_out"])
    else:
        dz2 = None
        if pp.lora is not None:
            _, b_in, _, b_out_l = pp.lora
            dz2 = _gemm(torch.empty(m, r, dtype=_BF, device=dev), g16, (d, 1),
                        b_out_l, (1, d), m, r, d, alpha=s)
            dbout_l = _gemm(torch.empty(r, d, **f32), z2, (1, r), g16, (d, 1),
                            r, d, m, alpha=s, splits=-1)
            daout = _gemm(torch.empty(d, r, **f32), ctx16, (1, d), dz2,
                          (r, 1), d, r, m, splits=-1)
        dctx16 = _gemm(torch.empty(m, d, dtype=_BF, device=dev), g16, (d, 1),
                       pp.w_out, (1, d), m, d, d,
                       lz=(dz2, r, 1) if dz2 is not None else None,
                       lb=(pp.lora[2], 1, r) if dz2 is not None else None,
                       lscale=1.0)

    dqkv16 = torch.empty(m, 3 * d, dtype=_BF, device=dev)
    road = _road(pp, n_heads)
    stats = _stats(pp, n_heads) if road == "mma_sync" else None
    _kernels.call("llc_attn_bwd", qkv16.data_ptr(), dctx16.data_ptr(),
                  _ptr(pp.mask), _ptr(pp.tmap), dqkv16.data_ptr(),
                  _ptr(attn_part), _ptr(stats), pp.b, pp.t, d, n_heads,
                  (d // n_heads) ** -0.5, pp.stream)

    if pp.fold:
        # dh = dqkv16 W_qkv^T + dz A_in^T, dz = bf16(s dqkv16 B_in^T) formed
        # on dqkv16's tiles; dB_in's partials of z16^T dqkv16 and dA_in's of
        # h16^T dz
        dh = _gemm_lora(torch.empty(m, d, **f32), dqkv16, (3 * d, 1),
                        pp.w_qkv, (1, 3 * d), m, d, 3 * d, b_in, r,
                        zalpha=s, lscale=1.0, lb=(a_in, 1, r), zin=z16,
                        pb=part["b_in"], xa=h16, pa=part["a_in"])
    else:
        dz = None
        if pp.lora is not None:
            dz = _gemm(torch.empty(m, r, dtype=_BF, device=dev), dqkv16,
                       (3 * d, 1), b_in, (1, 3 * d), m, r, 3 * d, alpha=s)
            dain = _gemm(torch.empty(d, r, **f32), h16, (1, d), dz, (r, 1),
                         d, r, m, splits=-1)
            dbin = _gemm(torch.empty(r, 3 * d, **f32), z16, (1, r), dqkv16,
                         (3 * d, 1), r, 3 * d, m, alpha=s, splits=-1)
            dlora = {"a_in": dain, "b_in": dbin, "a_out": daout,
                     "b_out": dbout_l}
        dh = _gemm(torch.empty(m, d, **f32), dqkv16, (3 * d, 1), pp.w_qkv,
                   (1, 3 * d), m, d, 3 * d,
                   lz=(dz, r, 1) if dz is not None else None,
                   lb=(pp.lora[0], 1, r) if dz is not None else None,
                   lscale=1.0)
    if weight_grads:
        dwqkv = _gemm(torch.empty(d, 3 * d, **f32), h16, (1, d), dqkv16,
                      (3 * d, 1), d, 3 * d, m, splits=-2)

    dx = _ln_backward(pp, dh, g2, ln_part)
    if weight_grads:
        bias_segs, (dbqkv, dls, dlb, dbout) = _bias_segs(
            pp, pp.t, sums, attn_part, ln_part)
        segs += bias_segs
        grads = (dls, dlb, dwqkv, dbqkv, dwout, dbout)
    if segs:   # the LoRA and bias grads' sums: one launch
        _sum_partials(pp, segs)
    LAUNCHES["fused_ln_attention_bwd"] += 1
    LAUNCHES["attn_bwd_wgmma"] += road == "wgmma"
    LAUNCHES["attn_bwd_wgmma_long"] += road == "wgmma_long"
    return (dx, *grads), dlora


def _ln_backward(pp: _Prepared, dh, g2, ln_part):
    """dx = g + LN'(x)^T dh on the card (one launch); with ``ln_part`` (the
    weight grads) also the LN partials of dls, dlb and dbout (a second
    launch, ``ln_partials_kernel``)."""
    dx = torch.empty_like(pp.x)
    _kernels.call("llc_ln_bwd", _DT[pp.x.dtype], _DT[pp.gamma.dtype],
                  pp.x.data_ptr(), pp.gamma.data_ptr(), dh.data_ptr(),
                  g2.data_ptr(), dx.data_ptr(), _ptr(ln_part), pp.m, pp.d,
                  EPS, pp.stream)
    return dx


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _forward(x, *args, keep=None):
    """y, and the intermediates the backward reads (``_keep_for_backward``
    with ``keep`` = weight_grads) on the card where ``keep`` is not None;
    None for them elsewhere."""
    if x.device.type == "cpu":
        return fused_ln_attention_block_reference(x, *args), None
    if x.device.type == "cuda":
        if keep is None:
            return _cuda_forward(x, *args), None
        y, saved = _cuda_forward(x, *args, keep=True)
        return y, _keep_for_backward(saved, keep)
    raise RuntimeError(f"fused_ln_attention_block: no kernel for {x.device}")


def _backward(x, g, *args, saved):
    if x.device.type == "cpu":
        return fused_ln_attention_block_reference_bwd(x, g, *args)
    if x.device.type == "cuda":
        return _cuda_backward(x, g, *args, saved=saved)
    raise RuntimeError(f"fused_ln_attention_block: no kernel for {x.device}")


def _keep_for_backward(saved, weight_grads):
    """What of the forward's (h16, z16, qkv16, ctx16, z2_16) the backward
    chain reads: qkv16 always, z16 and z2_16 with LoRA, h16 and ctx16 with
    LoRA or ``weight_grads``; None for the rest."""
    h16, z16, qkv16, ctx16, z2 = saved
    wide = weight_grads or z16 is not None
    return (h16 if wide else None, z16, qkv16, ctx16 if wide else None, z2)


def _primal_grads(grads, primals, needs):
    """Each grad in its primal's dtype (``_fused_bwd:236-245``): bf16 LoRA
    primals get bf16-rounded grads, as on the TPU. Frozen primals get none;
    a block grad the chain did not compute (None: ``weight_grads=False``)
    is exact zeros for a primal that needs one, made only then."""
    return tuple(None if not need else torch.zeros_like(p) if gr is None
                 else gr.to(p.dtype).reshape(p.shape)
                 for gr, p, need in zip(grads, primals, needs))


class _FusedLNAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, a_in,
                b_in, a_out, b_out_l, n_heads, lora_scaling, mask,
                weight_grads, keep):
        lora = None if a_in is None else {
            "a_in": a_in, "b_in": b_in, "a_out": a_out, "b_out": b_out_l}
        args = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, n_heads,
                lora_scaling, mask, lora)
        # on the card a train step keeps what its backward reads; under
        # no_grad nothing is kept
        y, saved = _forward(*args, keep=weight_grads if keep else None)
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                              b_out, a_in, b_in, a_out, b_out_l,
                              *(saved or ()))
        ctx.n_heads, ctx.lora_scaling = n_heads, lora_scaling
        ctx.mask, ctx.weight_grads = mask, weight_grads
        return y

    @staticmethod
    def backward(ctx, g):
        (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, a_in, b_in, a_out,
         b_out_l, *saved) = ctx.saved_tensors
        lora = None if a_in is None else {
            "a_in": a_in, "b_in": b_in, "a_out": a_out, "b_out": b_out_l}
        grads, dlora = _backward(
            x, g, ln_scale, ln_bias, w_qkv, b_qkv, w_out, ctx.n_heads,
            ctx.lora_scaling, ctx.mask, lora, ctx.weight_grads,
            saved=tuple(saved))
        primals = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out)
        out = _primal_grads(grads, primals, ctx.needs_input_grad)
        if lora is None:
            dl = (None,) * 4
        elif dlora is None:   # lora_scaling == 0: the LoRA terms are absent
            dl = tuple(torch.zeros_like(lora[k])
                       for k in ("a_in", "b_in", "a_out", "b_out"))
        else:
            dl = tuple(dlora[k].to(lora[k].dtype)
                       for k in ("a_in", "b_in", "a_out", "b_out"))
        return out + dl + (None,) * 5


def fused_ln_attention_block(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                             n_heads: int, lora_scaling: float = 0.0,
                             mask=None, lora=None, weight_grads: bool = True):
    """x (B, T, D) -> x + out_proj(MHA(LN(x))), with the JAX op's signature.

    ``mask``: additive, broadcastable to (T, T). ``lora``: dict of ``a_in``
    (D, r), ``b_in`` (r, 3D), ``a_out`` (D, r), ``b_out`` (r, D).
    ``weight_grads=False`` asserts the base block weights are not trained:
    their grads come back as exact zeros and the backward skips that work.
    On the card, with grad enabled and an input that needs it, the forward
    keeps the intermediates its backward reads (about 5 * B * T * D bf16
    values with LoRA: h, qkv and ctx); otherwise it keeps nothing beyond the
    inputs.
    """
    la = (None,) * 4 if lora is None else tuple(
        lora[k] for k in ("a_in", "b_in", "a_out", "b_out"))
    args = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, *la)
    return _FusedLNAttention.apply(*args, int(n_heads), float(lora_scaling),
                                   mask, bool(weight_grads), _keeps(args))


def _keeps(tensors) -> bool:
    """Whether autograd will call the op's backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# KV-prefix variant: plain versions
# ---------------------------------------------------------------------------

def _prefix_forward_parts(x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv,
                          n_heads, mask):
    """The forward of ``_prefix_kernel`` (``:527-581``) up to ctx16."""
    b, t, d = x.shape
    s_len = pk.shape[1] + t
    x32 = x.reshape(b * t, d).float()
    xhat, rstd, h32 = _ln_parts(x32, ln_scale, ln_bias)
    h16 = h32.to(_BF)
    # the wrapper casts the prompts to x's dtype, the kernel to bf16
    pk16, pv16 = (a.to(x.dtype).to(_BF) for a in (pk, pv))
    h3 = h16.reshape(b, t, d)
    k_src = torch.cat([pk16, h3], 1).reshape(b * s_len, d)
    v_src = torch.cat([pv16, h3], 1).reshape(b * s_len, d)
    w16, bq = w_qkv.to(_BF), b_qkv.float()
    q = (_mm(h16, w16[:, :d]) + bq[:d]).to(_BF)
    k = (_mm(k_src, w16[:, d:2 * d]) + bq[d:2 * d]).to(_BF)
    v = (_mm(v_src, w16[:, 2 * d:]) + bq[2 * d:]).to(_BF)
    qkv = (_split_heads(q, b, t, n_heads), _split_heads(k, b, s_len, n_heads),
           _split_heads(v, b, s_len, n_heads))
    scale = (d // n_heads) ** -0.5
    p = _probs(qkv[0], qkv[1], _mask32(mask, t, s_len, x.device),
               scale)
    ctx16 = _merge_heads(_mm(p.to(_BF), qkv[2])).to(_BF)
    return x32, xhat, rstd, h16, k_src, v_src, qkv, p, ctx16, scale


def fused_prefix_attention_block_reference(x, pk, pv, ln_scale, ln_bias,
                                           w_qkv, b_qkv, w_out, b_out,
                                           n_heads: int, mask=None):
    """Plain version of the prefix forward kernel (``_prefix_kernel``,
    ``:524-588``)."""
    b, t, d = x.shape
    parts = _prefix_forward_parts(x, pk, pv, ln_scale, ln_bias, w_qkv,
                                  b_qkv, n_heads, mask)
    out = _mm(parts[8], w_out.to(_BF)) + b_out.float()
    return (parts[0] + out).reshape(b, t, d).to(x.dtype)


def fused_prefix_attention_block_reference_bwd(x, g, pk, pv, ln_scale,
                                               ln_bias, w_qkv, b_qkv, w_out,
                                               n_heads: int, mask=None,
                                               weight_grads: bool = True):
    """Plain version of the prefix backward kernel (``_prefix_bwd_kernel``,
    ``:699-866``), step by step with its bf16 rounding points. Returns
    ``(dx, dpk, dpv, dls, dlb, dwqkv, dbqkv, dwout, dbout)``: dx in x's
    dtype, dpk and dpv in pk's and pv's, the rest fp32 (zeros without
    ``weight_grads``)."""
    b, t, d = x.shape
    n_p = pk.shape[1]
    s_len = n_p + t
    (x32, xhat, rstd, h16, k_src, v_src, (q, k, v), p, ctx16,
     scale) = _prefix_forward_parts(x, pk, pv, ln_scale, ln_bias, w_qkv,
                                    b_qkv, n_heads, mask)
    g32 = g.reshape(b * t, d).float()
    g16 = g32.to(_BF)
    w16 = w_qkv.to(_BF)
    f32 = dict(dtype=torch.float32, device=x.device)
    dls, dlb = torch.zeros(d, **f32), torch.zeros(d, **f32)
    dwqkv, dbqkv = torch.zeros(d, 3 * d, **f32), torch.zeros(3 * d, **f32)
    dwout, dbout = torch.zeros(d, d, **f32), torch.zeros(d, **f32)
    if weight_grads:
        dwout = _mm(ctx16.T, g16)
        dbout = g32.sum(0)
    dctx_h = _split_heads(_mm(g16, w_out.to(_BF).T).to(_BF), b, t, n_heads)
    dv = _mm(p.to(_BF).transpose(-1, -2), dctx_h)
    dp = _mm(dctx_h, v.transpose(-1, -2))
    ds16 = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(_BF)
    dq = _merge_heads(_mm(ds16, k) * scale)
    dk = _merge_heads(_mm(ds16.transpose(-1, -2), q) * scale)
    dv = _merge_heads(dv)
    dq16, dk16, dv16 = dq.to(_BF), dk.to(_BF), dv.to(_BF)
    if weight_grads:
        dwqkv = torch.cat([_mm(h16.T, dq16), _mm(k_src.T, dk16),
                           _mm(v_src.T, dv16)], -1)
        dbqkv = torch.cat([dq.sum(0), dk.sum(0), dv.sum(0)])
    dk_src = _mm(dk16, w16[:, d:2 * d].T).reshape(b, s_len, d)
    dv_src = _mm(dv16, w16[:, 2 * d:].T).reshape(b, s_len, d)
    dpk = dk_src[:, :n_p].to(pk.dtype)
    dpv = dv_src[:, :n_p].to(pv.dtype)
    dh = _mm(dq16, w16[:, :d].T) + (dk_src[:, n_p:]
                                     + dv_src[:, n_p:]).reshape(b * t, d)
    if weight_grads:
        dls = (dh * xhat).sum(0)
        dlb = dh.sum(0)
    dxhat = dh * ln_scale.float()
    dx_ln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = (g32 + dx_ln).reshape(b, t, d).to(x.dtype)
    return dx, dpk, dpv, dls, dlb, dwqkv, dbqkv, dwout, dbout


# ---------------------------------------------------------------------------
# the tile map of a 2-D mask
# ---------------------------------------------------------------------------

def mask_tile_map_reference(mask, tq: int = 16, tk: int = 16):
    """Plain version of the tile-map kernel's bytes (``mask_tile_map_kernel``):
    the (ceil(T/tq), ceil(S/tk)) uint8 map of a (T, S) additive mask over
    blocks of tq query rows x tk keys (rows < T, keys < S). 0: dead, every
    entry -inf and every row of the block has a live key somewhere (a row
    with none keeps its whole row of blocks, so the kernels give it the
    full sweep's NaN); 2: live, every entry +0.0 or -inf; 1: live, any
    other values."""
    t, s = mask.shape
    nr, nc = -(-t // tq), -(-s // tk)
    live = ~torch.isneginf(mask)
    plain = ~live | ((mask == 0) & ~torch.signbit(mask))
    pad = torch.zeros(nr * tq, nc * tk, dtype=torch.bool, device=mask.device)
    pad[:t, :s] = live
    blocks = pad.view(nr, tq, nc, tk).any(3).any(1)
    no_key = torch.zeros(nr * tq, dtype=torch.bool, device=mask.device)
    no_key[:t] = ~live.any(1)
    blocks |= no_key.view(nr, tq).any(1, keepdim=True)
    pad = torch.ones(nr * tq, nc * tk, dtype=torch.bool, device=mask.device)
    pad[:t, :s] = plain
    plain = pad.view(nr, tq, nc, tk).all(3).all(1)
    return torch.where(blocks, torch.where(plain, 2, 1), 0).to(torch.uint8)


def mask_tile_words_reference(mask):
    """Plain version of the tile-map kernel's words: (ceil(T/16),
    ceil(S/16), 8) int32, word w of a 16 x 16 block holding row w's 16 bits
    (bit c: key 16k + c is not -inf) in its low half and row w + 8's in its
    high half; rows past T all ones, keys past S zero."""
    t, s = mask.shape
    nr, nc = -(-t // 16), -(-s // 16)
    bits = torch.zeros(nr * 16, nc * 16, dtype=torch.int64,
                       device=mask.device)
    bits[:t, :s] = (~torch.isneginf(mask)).long()
    bits[t:] = 1
    rows = (bits.view(nr, 16, nc, 16)
            << torch.arange(16, device=mask.device)).sum(3)   # (nr, 16, nc)
    words = (rows[:, :8] | rows[:, 8:] << 16).permute(0, 2, 1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32).contiguous()


def _words_at(t, s):
    """Byte offset of the words in a tile-map buffer (16-byte aligned)."""
    return -(-(-(-t // 16) * -(-s // 16)) // 16) * 16


def unpack_tile_map(buf, t, s):
    """A tile-map buffer's (bytes (ceil(T/16), ceil(S/16)), words
    (ceil(T/16), ceil(S/16), 8) int32) views."""
    nr, nc = -(-t // 16), -(-s // 16)
    off = _words_at(t, s)
    return (buf[:nr * nc].view(nr, nc),
            buf[off:off + nr * nc * 32].view(torch.int32).view(nr, nc, 8))


def mask_tile_map(mask, counter="prefix_tile_map"):
    """The tile map of a contiguous fp32 (T, S) mask as the attention
    kernels take it, one uint8 buffer (``unpack_tile_map``): on the card one
    launch of ``mask_tile_map_kernel`` (counted in ``LAUNCHES[counter]``:
    the prefix op's maps, or the block op's), on the CPU its plain
    versions."""
    t, s = mask.shape
    nr, nc = -(-t // 16), -(-s // 16)
    buf = torch.empty(_words_at(t, s) + nr * nc * 32, dtype=torch.uint8,
                      device=mask.device)
    if mask.device.type == "cpu":
        tmap, words = unpack_tile_map(buf, t, s)
        tmap.copy_(mask_tile_map_reference(mask))
        words.copy_(mask_tile_words_reference(mask))
        return buf
    if mask.device.type != "cuda" or mask.dtype != torch.float32 \
            or mask.dim() != 2 or not mask.is_contiguous():
        raise ValueError("mask_tile_map: takes a contiguous fp32 (T, S) mask "
                         f"on the card; got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    _kernels.call("llc_mask_tile_map", mask.data_ptr(), buf.data_ptr(), t, s,
                  _stream(mask))
    LAUNCHES[counter] += 1
    return buf


# ---------------------------------------------------------------------------
# KV-prefix variant: CUDA kernel chains
# ---------------------------------------------------------------------------

def _prefix_mask_arg(mask, t, s, device):
    """The mask as the prefix kernels take it, with its row stride: one
    (S,) key-mask row for every query (stride 0) where the mask broadcasts
    from one, else the (T, S) matrix (stride S)."""
    if mask is None:
        return None, 0
    m = mask.to(device=device, dtype=torch.float32)
    if m.dim() >= 1 and m.shape[-1] == s and all(n == 1
                                                 for n in m.shape[:-1]):
        return m.reshape(s).contiguous(), 0
    return torch.broadcast_to(m, (t, s)).contiguous(), s


def _prefix_prepare(x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                    b_out, n_heads, mask, tile_map=True):
    """Operands of the prefix chain: the block's as ``_Prepared``, the
    prompts cast to x's dtype then bf16 (as the TPU wrapper and kernel
    cast them; once where x is bf16) as (B*P, D) rows, the mask as
    ``_prefix_mask_arg`` gives it and, for a (T, P + T) mask, its tile map
    (``mask_tile_map``; None with ``tile_map=False``: the kernels sweep
    every block, which gives the same values bit for bit). One tensor as
    pk and pv stays one; two are stacked in one (2, B*P, D) buffer, so one
    grouped GEMM projects both."""
    op = "fused_prefix_attention_block"
    b, t, d = x.shape
    if pk.dim() != 3 or pk.shape != pv.shape or pk.shape[0] != b \
            or pk.shape[2] != d or pk.shape[1] < 1:
        raise ValueError(f"{op}: pk and pv must be (B, P, D) with P >= 1 "
                         f"and x's B and D; got {tuple(pk.shape)}, "
                         f"{tuple(pv.shape)} for x {tuple(x.shape)}")
    _check_cuda(x, n_heads, op=op)
    pp = _Prepared(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, None,
                   None, 0.0)
    pp.p = pk.shape[1]
    pp.mask, pp.mask_rs = _prefix_mask_arg(mask, t, pp.p + t, x.device)
    pp.tmap = mask_tile_map(pp.mask) if pp.mask_rs and tile_map else None

    def b16(a):
        a = a.detach()
        return a.to(_BF) if x.dtype == _BF else a.to(x.dtype).to(_BF)

    if pk is pv:
        pk16 = pv16 = b16(pk).contiguous().view(b * pp.p, d)
    else:
        pkv16 = torch.stack([b16(pk), b16(pv)]).view(2, b * pp.p, d)
        pk16, pv16 = pkv16[0], pkv16[1]
    return pp, pk16, pv16


def _cuda_prefix_forward(x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                         b_out, n_heads, mask, keep=False, tile_map=True):
    """y on the card; with ``keep``, (y, (h16, qkv16 (B*T, 3D), kvp16
    (B*P, 2D: K | V of the prefix rows), ctx16)) for the backward chain to
    read. ``tile_map=False`` sweeps every block of a 2-D mask (the
    yardstick of the skipping kernels)."""
    pp, pk16, pv16 = _prefix_prepare(x, pk, pv, ln_scale, ln_bias, w_qkv,
                                     b_qkv, w_out, b_out, n_heads, mask,
                                     tile_map)
    m, d, bp = pp.m, pp.d, pp.b * pp.p
    h16, _, qkv16 = _cuda_ln_qkv(pp)
    kvp16 = torch.empty(bp, 2 * d, dtype=_BF, device=pp.x.device)
    # K | V = [pk16 @ W_k + b_k | pv16 @ W_v + b_v] in one launch: W_qkv's
    # K and V columns D..3D are adjacent, so one prompt tensor is one GEMM
    # with N = 2D; two (stacked by _prefix_prepare) a grouped GEMM
    if pk16 is pv16:
        _gemm(kvp16, pk16, (d, 1), pp.w_qkv[:, d:], (3 * d, 1), bp, 2 * d, d,
              bias=pp.b_qkv[d:])
    else:
        _gemm(kvp16, pk16, (d, 1), pp.w_qkv[:, d:], (3 * d, 1), bp, d, d,
              bias=pp.b_qkv[d:], groups=(2, bp, d))
    ctx16 = torch.empty(pp.m, d, dtype=_BF, device=pp.x.device)
    _kernels.call("llc_attn_prefix_fwd", qkv16.data_ptr(),
                  kvp16.data_ptr(), _ptr(pp.mask), pp.mask_rs, _ptr(pp.tmap),
                  ctx16.data_ptr(),
                  pp.b, pp.t, pp.p, d, n_heads, (d // n_heads) ** -0.5,
                  pp.stream)
    LAUNCHES["attn_prefix_fwd_wgmma"] += _prefix_road(pp, n_heads)
    saved = (h16, qkv16, kvp16, ctx16)
    x2 = pp.x.view(m, d)
    y = _gemm(torch.empty_like(x2), ctx16, (d, 1), pp.w_out, (d, 1), m, d, d,
              bias=pp.b_out, resid=x2)
    LAUNCHES["fused_prefix_attention_fwd"] += 1
    y = y.view(pp.b, pp.t, d)
    return (y, saved) if keep else y


def _prefix_attention_bwd(pp, qkv16, kvp16, dctx16, n_heads, attn_part=None):
    """The prefix attention backward (dq, then dk/dv): (dqkv16 (B*T, 3D),
    dkvp16 (B*P, 2D: dK | dV of the prefix rows)), and into ``attn_part``
    (``_bias_workspace``'s) the bias partials where given."""
    m, d, bp, dev = pp.m, pp.d, pp.b * pp.p, pp.x.device
    dqkv16 = torch.empty(m, 3 * d, dtype=_BF, device=dev)
    dkvp16 = torch.empty(bp, 2 * d, dtype=_BF, device=dev)
    road = _prefix_road(pp, n_heads)
    stats = None if road else _stats(pp, n_heads)
    _kernels.call("llc_attn_prefix_bwd", qkv16.data_ptr(), kvp16.data_ptr(),
                  dctx16.data_ptr(), _ptr(pp.mask), pp.mask_rs,
                  _ptr(pp.tmap), dqkv16.data_ptr(), dkvp16.data_ptr(),
                  _ptr(attn_part), _ptr(stats), pp.b, pp.t, pp.p, d,
                  n_heads, (d // n_heads) ** -0.5, pp.stream)
    LAUNCHES["attn_prefix_bwd_wgmma"] += road
    return dqkv16, dkvp16


def _cuda_prefix_backward(x, g, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv,
                          w_out, n_heads, mask, weight_grads, saved,
                          tile_map=True):
    """The prefix backward chain on the card. ``saved``: the forward's
    (h16, qkv16, kvp16, ctx16), those the backward reads
    (``_keep_for_prefix_backward`` of ``_cuda_prefix_forward(...,
    keep=True)``). A 2-D mask's tile map is built anew here (one launch);
    ``tile_map`` as the forward's. The block grads as ``_cuda_backward``'s
    (None without ``weight_grads``)."""
    pp, pk16, pv16 = _prefix_prepare(x, pk, pv, ln_scale, ln_bias, w_qkv,
                                     b_qkv, w_out, None, n_heads, mask,
                                     tile_map)
    m, d, bp = pp.m, pp.d, pp.b * pp.p
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    h16, qkv16, kvp16, ctx16 = saved
    g2, g16 = _grad_rows(pp, g)

    grads = (None,) * 6
    sums = attn_part = ln_part = None
    if weight_grads:
        sums, attn_part, ln_part = _bias_workspace(pp, pp.p + pp.t)
        dwout = _gemm(torch.empty(d, d, **f32), ctx16, (1, d), g16, (d, 1),
                      d, d, m, splits=-2)
    dctx16 = _gemm(torch.empty(m, d, dtype=_BF, device=dev), g16, (d, 1),
                   pp.w_out, (1, d), m, d, d)

    dqkv16, dkvp16 = _prefix_attention_bwd(pp, qkv16, kvp16, dctx16, n_heads,
                                           attn_part)

    # dpk = dK16_pre @ W_k^T, dpv = dV16_pre @ W_v^T (:843-852)
    dpkv = [_gemm(torch.empty(bp, d, **f32), dkvp16[:, i * d:(i + 1) * d],
                  (2 * d, 1), pp.w_qkv[:, (i + 1) * d:(i + 2) * d],
                  (1, 3 * d), bp, d, d) for i in range(2)]
    dh = _gemm(torch.empty(m, d, **f32), dqkv16, (3 * d, 1), pp.w_qkv,
               (1, 3 * d), m, d, 3 * d)
    if weight_grads:
        dwqkv = _gemm(torch.empty(d, 3 * d, **f32), h16, (1, d), dqkv16,
                      (3 * d, 1), d, 3 * d, m, splits=-2)
        # the prefix rows join the K and V contractions: dW_k += pk16^T dK,
        # dW_v += pv16^T dV, through the residual epilogue in place
        for i, src in enumerate((pk16, pv16)):
            blk = dwqkv[:, (i + 1) * d:(i + 2) * d]
            _gemm(blk, src, (1, d), dkvp16[:, i * d:(i + 1) * d], (2 * d, 1),
                  d, d, bp, resid=blk)

    dx = _ln_backward(pp, dh, g2, ln_part)
    if weight_grads:
        # the key groups' partials hold the prefix keys' dk and dv too
        dbqkv, dls, dlb, dbout = _bias_sums(pp, pp.p + pp.t, sums, attn_part,
                                            ln_part)
        grads = (dls, dlb, dwqkv, dbqkv, dwout, dbout)
    LAUNCHES["fused_prefix_attention_bwd"] += 1
    dpk, dpv = (a.view(pp.b, pp.p, d).to(src.dtype)
                for a, src in zip(dpkv, (pk, pv)))
    return (dx, dpk, dpv, *grads)


# ---------------------------------------------------------------------------
# the prefix op
# ---------------------------------------------------------------------------

def _prefix_forward(x, *args, keep=None):
    """As ``_forward``, with ``_keep_for_prefix_backward``."""
    if x.device.type == "cpu":
        return fused_prefix_attention_block_reference(x, *args), None
    if x.device.type == "cuda":
        if keep is None:
            return _cuda_prefix_forward(x, *args), None
        y, saved = _cuda_prefix_forward(x, *args, keep=True)
        return y, _keep_for_prefix_backward(saved, keep)
    raise RuntimeError(
        f"fused_prefix_attention_block: no kernel for {x.device}")


def _prefix_backward(x, g, *args, saved):
    if x.device.type == "cpu":
        return fused_prefix_attention_block_reference_bwd(x, g, *args)
    if x.device.type == "cuda":
        return _cuda_prefix_backward(x, g, *args, saved=saved)
    raise RuntimeError(
        f"fused_prefix_attention_block: no kernel for {x.device}")


def _keep_for_prefix_backward(saved, weight_grads):
    """What of the forward's (h16, qkv16, kvp16, ctx16) the backward chain
    reads: qkv16 and kvp16 always, h16 and ctx16 with ``weight_grads``;
    None for the rest."""
    h16, qkv16, kvp16, ctx16 = saved
    return (h16 if weight_grads else None, qkv16, kvp16,
            ctx16 if weight_grads else None)


class _FusedPrefixAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                n_heads, mask, weight_grads, keep):
        args = (x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                n_heads, mask)
        # as _FusedLNAttention
        y, saved = _prefix_forward(*args, keep=weight_grads if keep else None)
        ctx.save_for_backward(x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv,
                              w_out, b_out, *(saved or ()))
        ctx.n_heads, ctx.mask, ctx.weight_grads = n_heads, mask, weight_grads
        return y

    @staticmethod
    def backward(ctx, g):
        # saved_tensors read once: under torch.utils.checkpoint each read
        # unpacks (recomputes) the saved tensors, and a second one raises
        kept = ctx.saved_tensors
        primals, saved = kept[:9], kept[9:]
        x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv, w_out, _ = primals
        grads = _prefix_backward(x, g, pk, pv, ln_scale, ln_bias, w_qkv,
                                 b_qkv, w_out, ctx.n_heads, ctx.mask,
                                 ctx.weight_grads, saved=saved)
        # as _FusedLNAttention (``_prefix_bwd:687-693``)
        out = _primal_grads(grads, primals, ctx.needs_input_grad)
        return out + (None,) * 4


def fused_prefix_attention_block(x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv,
                                 w_out, b_out, n_heads: int, mask=None,
                                 weight_grads: bool = True, rows_fwd=None,
                                 rows_bwd=None):
    """Prompted block half: x + out_proj(MHA(q = LN(x); K from [pk; LN(x)],
    V from [pv; LN(x)])), with the JAX op's signature.

    ``pk``/``pv`` (B, P, D): prompt tokens, raw (the caller applies ln_1 if
    it wants it); the same tensor or two. dx, dpk and dpv always flow.
    ``mask``: additive, broadcastable to (T, P + T), e.g. (P + T,) with -inf
    on dead prefix slots. ``weight_grads=False`` asserts the block weights
    are frozen: their grads come back as exact zeros. ``rows_fwd`` and
    ``rows_bwd`` are the TPU kernels' rows-per-program knobs; the CUDA
    kernels tile by their own shapes and ignore them. On the card, with grad
    enabled and an input that needs it, the forward keeps the
    intermediates its backward reads (as ``fused_ln_attention_block``).
    """
    del rows_fwd, rows_bwd
    args = (x, pk, pv, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out)
    return _FusedPrefixAttention.apply(*args, int(n_heads), mask,
                                       bool(weight_grads), _keeps(args))
