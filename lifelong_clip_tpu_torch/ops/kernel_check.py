"""Hold the fused block's kernels, their KV-prefix variant and the
flash-attention kernels against their plain versions.

``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py`` run this on the
card. Each output is compared on the part of it that the kernels compute,
not the part an input carries through, and beyond one bf16 rounding of the
output (a flipped rounding moves a value by one ulp, at most 2**-7 of it):

* y on the term y - x. The residual x is an input; at |x| ~ 4 one ulp of y
  (2**-6) is as large as the whole LoRA out-projection term at the model's
  init scales;
* qkv (recomputed by the kernels) on the LoRA-in term s * (z16 @ B_in);
* dx on the term dx - g, the part the LN backward computes;
* every grad of the op's leaves, taken through ``torch.autograd`` as the
  train step takes them, against the plain backward's grad rounded to the
  leaf's dtype.

``make_inputs`` draws the out-projection weights at std D**-0.5 and the
LoRA B factors at std 1, so that each term a check is meant to see is at
least ``MARGIN`` times that check's tolerance; ``check_case`` asserts it.

The prefix case (``make_prefix_inputs``, ``check_prefix_case``) holds y on
y - x, dx on dx - g, dpk, dpv and, with ``weight_grads``, every block grad
in the same way; asserts that the prefix's share of y (y against y with
every slot dead) is visible to the y check; and asserts that the grads of
the dead prefix slots are exactly zero. Under a (T, P + T) mask the prefix
kernels skip the blocks the mask's tile map marks dead:
``prefix_attention_outputs`` gives the attention kernels' own outputs (ctx,
dqkv, dkvp, the weight grads' bias partials) with and without the map,
which ``same_bits`` holds bit for bit; ``block_outputs`` gives the #1/#2
chains' outputs the same two ways under a (T, T) mask. ``batch_rows``
gives ctx, y and dx of a batch, for holding a small batch's rows bit for
bit to the same rows of a larger one.

The flash case (``make_flash_inputs``, ``check_flash_case``) holds o, dq, dk
and dv whole. Kernels and plain versions both compute in fp32 and round
once, so they differ by the order of fp32 sums: an fp32 output within
``FLASH_REL`` of its largest value, a bf16 output within that beyond one
bf16 ulp. Keys a key-mask row kills get dk = dv = 0 exactly.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa
from . import fused_block_attn as fba
from .attention import causal_mask

ULP = 2.0 ** -7        # one bf16 ulp is at most 2**-7 of the value
MARGIN = 10.0          # a term a check must see is >= MARGIN x its tolerance
REL_FWD = 1e-2         # of the term: fp32 summation order, p16 / ctx16 flips
REL_BWD = 2e-2         # of the term: also flips of ds16 / dqkv16 roundings
FLASH_REL = 1e-4       # of the output's max: fp32 sums in another order
LORA_KEYS = ("a_in", "b_in", "a_out", "b_out")
BLOCK_KEYS = ("ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "b_out")


def make_inputs(b, t, d, heads, lora_r, causal, seed, device="cuda"):
    """bf16 block inputs and output grad from a seed on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def n(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=g, device=device)).to(
            torch.bfloat16)

    blk = {"ln_scale": 1 + n(d, std=0.1), "ln_bias": n(d, std=0.1),
           "w_qkv": n(d, 3 * d, std=d ** -0.5), "b_qkv": n(3 * d, std=0.02),
           "w_out": n(d, d, std=d ** -0.5), "b_out": n(d, std=0.02)}
    lora = None if not lora_r else {
        "a_in": n(d, lora_r, std=d ** -0.5), "b_in": n(lora_r, 3 * d),
        "a_out": n(d, lora_r, std=d ** -0.5), "b_out": n(lora_r, d)}
    mask = causal_mask(t, device=device) if causal else None
    return n(b, t, d), blk, lora, n(b, t, d, std=1e-2), mask


def plain_parts(x, blk, lora, s, heads, mask):
    """The plain forward's qkv16 (B*T, 3D), LoRA-in and LoRA-out terms."""
    lt = fba._lora16(lora, s)
    _, _, _, _, z, (q, k, v), _, ctx16, _ = fba._forward_parts(
        x, *[blk[k] for k in BLOCK_KEYS[:4]], heads, mask, lt, s)
    qkv = torch.cat([fba._merge_heads(a) for a in (q, k, v)], -1)
    if lt is None:
        return qkv, None, None
    lora_in = s * fba._mm(z.to(fba._BF), lt[1])
    lora_out = s * fba._mm(fba._mm(ctx16, lt[2]).to(fba._BF), lt[3])
    return qkv, lora_in, lora_out


def kernel_qkv(x, blk, lora, s, heads):
    """qkv16 (B*T, 3D) as the kernels compute it (LN, z16, qkv GEMM); on
    the CPU, as the plain version does."""
    if x.device.type == "cpu":
        return plain_parts(x, blk, lora, s, heads, None)[0]
    pp = fba._Prepared(x, *[blk[k] for k in BLOCK_KEYS], None, lora, s)
    return fba._cuda_ln_qkv(pp)[2]


def _held(report, name, got, want, term, rel):
    """Assert max(|got - want| - ULP * max(|got|, |want|)) <= rel * max|term|
    and record the errors; ``term`` is the part of ``want`` to be seen."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    excess = (diff - ULP * torch.maximum(got.abs(), want.abs())).clamp(min=0)
    scale = float(term.float().abs().max())
    tol = rel * scale
    err, ex = float(diff.max()), float(excess.max())
    report[name] = {"max_abs_err": err, "excess": ex, "term": scale,
                    "tol": tol}
    assert ex == ex and ex <= tol, (
        f"{name}: {ex:.3e} beyond one bf16 ulp > {rel} x {scale:.3e} "
        f"(max |term|); max abs err {err:.3e}")
    return tol


def _visible(report, name, term, tol, want):
    """Assert max|term| >= MARGIN x (tol + one bf16 ulp of a typical
    ``want``): an error the size of ``term`` would fail the check."""
    size = float(term.float().abs().max())
    floor = MARGIN * (tol + ULP * float(want.float().square().mean().sqrt()))
    report[name] = {"max": size, "needed": floor}
    assert size >= floor, (
        f"{name} {size:.3e} is under {floor:.3e}, {MARGIN} x (tolerance + "
        f"one typical bf16 ulp): the check could not see it")


def check_case(x, blk, lora, gy, mask, heads, s, weight_grads):
    """Run the op forward and backward through autograd on ``x``'s device
    and hold y, qkv, dx and every grad against the plain versions. Raises
    AssertionError on disagreement; returns the errors and term sizes."""
    rep = {}
    ref_args = [blk[k] for k in BLOCK_KEYS]
    xl = x.detach().clone().requires_grad_(True)
    bl = {k: v.detach().clone().requires_grad_(True) for k, v in blk.items()}
    ll = None if lora is None else {
        k: v.detach().clone().requires_grad_(True) for k, v in lora.items()}
    y = fba.fused_ln_attention_block(xl, *[bl[k] for k in BLOCK_KEYS], heads,
                                     s, mask, ll, weight_grads)
    y.backward(gy)
    with torch.no_grad():
        y_ref = fba.fused_ln_attention_block_reference(x, *ref_args, heads, s,
                                                       mask, lora)
        grads, dlora = fba.fused_ln_attention_block_reference_bwd(
            x, gy, *ref_args[:5], heads, s, mask, lora, weight_grads)
        tol_y = _held(rep, "y", y, y_ref, y_ref.float() - x.float(), REL_FWD)
        qkv_ref, lora_in, lora_out = plain_parts(x, blk, lora, s, heads, mask)
        if lora_in is not None:
            _visible(rep, "lora_out_term", lora_out, tol_y, y_ref)
            tol_qkv = _held(rep, "qkv", kernel_qkv(x, blk, lora, s, heads),
                            qkv_ref, lora_in, REL_FWD)
            _visible(rep, "lora_in_term", lora_in, tol_qkv, qkv_ref)
        dx_ln = grads[0].float() - gy.float()
        tol_dx = _held(rep, "dx", xl.grad, grads[0], dx_ln, REL_BWD)
        _visible(rep, "dx_ln_term", dx_ln, tol_dx, grads[0])
        for key, want in zip(BLOCK_KEYS, grads[1:]):
            got = bl[key].grad
            if weight_grads:
                want = want.to(got.dtype).reshape(got.shape)
                _held(rep, f"d{key}", got, want, want, REL_BWD)
            else:
                assert float(got.abs().max()) == 0.0, f"d{key} is not zero"
        if lora is not None:
            for key in LORA_KEYS:
                got = ll[key].grad
                assert got.dtype == lora[key].dtype, f"lora d{key} dtype"
                want = dlora[key].to(got.dtype)
                _held(rep, f"lora_d{key}", got, want, want, REL_BWD)
    return rep


def make_prefix_inputs(b, t, d, heads, p, live, seed, device="cuda",
                       shared=False):
    """bf16 prefix-block inputs from a seed: x, distinct pk and pv (B, P, D)
    at std 2 (with ``shared``, one tensor as both, as mvp-clip passes its
    prompts), so that live slots carry a visible share of the attention,
    the block weights, the output grad, and a (P + T,) fp32 mask with 0 on
    the first ``live`` prefix slots and on the tokens, -inf on the rest."""
    x, blk, _, gy, _ = make_inputs(b, t, d, heads, 0, False, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    pk, pv = ((2.0 * torch.randn(b, p, d, generator=g, device=device)).to(
        torch.bfloat16) for _ in range(2))
    if shared:
        pv = pk
    mask = torch.zeros(p + t, device=device)
    mask[live:p] = float("-inf")
    return x, pk, pv, blk, gy, mask


def check_prefix_case(x, pk, pv, blk, gy, mask, heads, weight_grads):
    """Run the prefix op forward and backward through autograd on ``x``'s
    device and hold y, dx, dpk, dpv and the block grads against the plain
    versions; ``mask`` is None, (P + T,) or (T, P + T). One tensor as pk
    and pv stays one leaf, whose grad is held against dpk + dpv. Raises
    AssertionError on disagreement; returns the errors and term sizes."""
    rep = {}
    n_p = pk.shape[1]
    ref_args = [blk[k] for k in BLOCK_KEYS]
    xl, pkl, pvl = (a.detach().clone().requires_grad_(True)
                    for a in (x, pk, pv))
    if pk is pv:
        pvl = pkl
    bl = {k: v.detach().clone().requires_grad_(True) for k, v in blk.items()}
    y = fba.fused_prefix_attention_block(xl, pkl, pvl,
                                         *[bl[k] for k in BLOCK_KEYS], heads,
                                         mask, weight_grads)
    y.backward(gy)
    s_len = n_p + x.shape[1]
    full = torch.zeros(x.shape[1], s_len, device=x.device)
    if mask is not None:
        full = torch.broadcast_to(mask.float(), full.shape).clone()
    dead = torch.isneginf(full[:, :n_p]).all(0)   # no query sees the slot
    with torch.no_grad():
        y_ref = fba.fused_prefix_attention_block_reference(
            x, pk, pv, *ref_args, heads, mask)
        grads = fba.fused_prefix_attention_block_reference_bwd(
            x, gy, pk, pv, *ref_args[:5], heads, mask, weight_grads)
        tol_y = _held(rep, "y", y, y_ref, y_ref.float() - x.float(), REL_FWD)
        if not bool(dead.all()):
            none = full.clone()
            none[:, :n_p] = float("-inf")
            y_none = fba.fused_prefix_attention_block_reference(
                x, pk, pv, *ref_args, heads, none)
            _visible(rep, "prefix_term", y_ref.float() - y_none.float(),
                     tol_y, y_ref)
        dx_ln = grads[0].float() - gy.float()
        tol_dx = _held(rep, "dx", xl.grad, grads[0], dx_ln, REL_BWD)
        _visible(rep, "dx_ln_term", dx_ln, tol_dx, grads[0])
        pgrads = ((("dpk", pkl, grads[1]), ("dpv", pvl, grads[2]))
                  if pkl is not pvl else
                  (("dpk + dpv", pkl, grads[1].float() + grads[2].float()),))
        for key, leaf, want in pgrads:
            got = leaf.grad
            assert got.dtype == leaf.dtype, f"{key} dtype"
            _held(rep, key, got, want.to(got.dtype), want, REL_BWD)
            assert not bool(got[:, dead].any()), \
                f"{key}: a dead prefix slot has a nonzero grad"
        for key, want in zip(BLOCK_KEYS, grads[3:]):
            got = bl[key].grad
            if weight_grads:
                want = want.to(got.dtype).reshape(got.shape)
                _held(rep, f"d{key}", got, want, want, REL_BWD)
            else:
                assert float(got.abs().max()) == 0.0, f"d{key} is not zero"
    return rep


def prefix_attention_outputs(x, pk, pv, blk, gy, mask, heads,
                             tile_map=True):
    """The prefix attention kernels' own outputs on the card for the output
    grad ``gy``: ctx16 of the forward and, of the backward, dqkv16, dkvp16
    and the weight grads' bias partials (fp32 column sums of each 16-row
    group of dq, dk and dv); with the mask's tile map or, with
    ``tile_map=False``, sweeping every block."""
    wb = [blk[k] for k in BLOCK_KEYS]
    _, (_, qkv16, kvp16, ctx16) = fba._cuda_prefix_forward(
        x, pk, pv, *wb, heads, mask, keep=True, tile_map=tile_map)
    pp, _, _ = fba._prefix_prepare(x, pk, pv, *wb, heads, mask, tile_map)
    g16 = fba._grad_rows(pp, gy)[1]
    dctx16 = fba._gemm(torch.empty_like(ctx16), g16, (pp.d, 1), pp.w_out,
                       (1, pp.d), pp.m, pp.d, pp.d)
    part = fba._bias_workspace(pp, pp.p + pp.t)[1]
    grads = fba._prefix_attention_bwd(pp, qkv16, kvp16, dctx16, heads, part)
    return dict(zip(("ctx16", "dqkv16", "dkvp16", "bias_partials"),
                    (ctx16, *grads, part)))


def block_outputs(x, blk, lora, s, gy, mask, heads, tile_map=True,
                  weight_grads=False):
    """The #1/#2 chains' outputs on the card for the output grad ``gy``:
    ctx16 (B, T, D) and y of the forward, dx, the LoRA grads (``d`` +
    factor name) and, with ``weight_grads``, the block grads (``d`` +
    ``BLOCK_KEYS`` name; their bias and LN parts summed from the kernels'
    partials) of the backward; with the (T, T) mask's tile map or, with
    ``tile_map=False``, sweeping every block."""
    wb = [blk[k] for k in BLOCK_KEYS]
    y, saved = fba._cuda_forward(x, *wb, heads, s, mask, lora, keep=True,
                                 tile_map=tile_map)
    kept = fba._keep_for_backward(saved, weight_grads)
    grads, dlora = fba._cuda_backward(x, gy, *wb[:5], heads, s, mask, lora,
                                      weight_grads, kept, tile_map=tile_map)
    out = {"ctx16": saved[3].view(x.shape), "y": y, "dx": grads[0]}
    out.update({f"d{k}": v for k, v in (dlora or {}).items()})
    if weight_grads:
        out.update({f"d{k}": v for k, v in zip(BLOCK_KEYS, grads[1:])})
    return out


def batch_rows(x, blk, gy, heads, lora=None, s=0.0, mask=None):
    """The kernels' ctx16 and y of the forward and dx of the backward
    (``weight_grads=False``) for the batch ``x``, each (B, T, D): what a
    batch-invariance check compares row for row between a small batch,
    whose attention kernels split each (head, batch row) over blocks, and
    a larger one holding the same rows."""
    out = block_outputs(x, blk, lora, s, gy, mask, heads)
    return {k: out[k] for k in ("ctx16", "y", "dx")}


_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def same_bits(a, b):
    """Whether a and b are equal bit for bit, any NaN equal to any NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(na, nb):
        return False
    return torch.equal(a.masked_fill(na, 0).view(_BITS[a.dtype]),
                       b.masked_fill(nb, 0).view(_BITS[b.dtype]))


def make_flash_inputs(b, t, s, d, heads, seed, mask=None,
                      dtype=torch.bfloat16, device="cuda"):
    """q (B, T, D), k and v (B, S, D) and the output grad, standard normal
    (scores of std ~1 at head dim 64), from a seed, and ``mask``: None,
    ``"causal"`` ((T, S), the first S - T keys always visible) or an int n,
    an (S,) key-mask row with keys n .. S - T - 1 dead (the prompt slots
    past the n live ones)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, gy = (torch.randn(b, n, d, generator=g, device=device).to(dtype)
                   for n in (t, s, s, t))
    if mask == "causal":
        mask = causal_mask(t, prefix=s - t, device=device)
    elif mask is not None:
        row = torch.zeros(s, device=device)
        row[mask:s - t] = float("-inf")
        mask = row
    return q, k, v, gy, mask


def check_flash_case(q, k, v, gy, mask, heads):
    """Run the flash op forward and backward through autograd on q's device
    and hold o, dq, dk and dv against the plain versions. Raises
    AssertionError on disagreement; returns the errors."""
    rep = {}
    leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, heads, mask)
    out.backward(gy)
    with torch.no_grad():
        want = (fa.flash_attention_reference(q, k, v, heads, mask),
                *fa.flash_attention_reference_bwd(q, k, v, gy, heads, mask))
        got = (out, *[a.grad for a in leaves])
        for name, g_, w in zip(("o", "dq", "dk", "dv"), got, want):
            assert g_.dtype == w.dtype == q.dtype, f"{name} dtype"
            g32, w32 = g_.float(), w.float()
            diff = (g32 - w32).abs()
            if q.dtype == torch.bfloat16:   # beyond one bf16 ulp
                diff = (diff - ULP * torch.maximum(g32.abs(), w32.abs())
                        ).clamp(min=0)
            scale = float(w32.abs().max())
            tol = FLASH_REL * scale
            rep[name] = {"max_abs_err": float((g32 - w32).abs().max()),
                         "excess": float(diff.max()), "tol": tol}
            assert scale > 0 and float(diff.max()) <= tol, (
                f"flash {name}: {float(diff.max()):.3e} > {FLASH_REL} x "
                f"{scale:.3e}")
        if mask is not None and mask.dim() == 1:
            dead = torch.isneginf(mask)
            for name, leaf in (("dk", leaves[1]), ("dv", leaves[2])):
                assert not bool(leaf.grad[:, dead].any()), \
                    f"flash {name}: a dead key has a nonzero grad"
    return rep
