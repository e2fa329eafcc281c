"""Hold the fused block's kernels against their plain versions.

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
"""

from __future__ import annotations

import torch

from . import fused_block_attn as fba
from .attention import causal_mask

ULP = 2.0 ** -7        # one bf16 ulp is at most 2**-7 of the value
MARGIN = 10.0          # a term a check must see is >= MARGIN x its tolerance
REL_FWD = 1e-2         # of the term: fp32 summation order, p16 / ctx16 flips
REL_BWD = 2e-2         # of the term: also flips of ds16 / dqkv16 roundings
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
    return fba._cuda_recompute(pp, heads, need_ctx=False)[2]


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
