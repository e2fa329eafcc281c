"""The fused LN-attention op at the ER family's small batches, on the CPU:
the check that holds the CUDA kernels against their plain versions on the
card (``ops/kernel_check.py``) sees faults in the weight grads' folded
sums, and one batch row without LoRA, with the weight grads, matches the
JAX op's Pallas kernels in interpret mode."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.ops.fused_block_attn import \
    fused_ln_attention_block as jax_fused
from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops import kernel_check as kc

# two batch rows of 16 tokens: the last 16-row group of the attention
# backward's bias partials is batch row 1; the LN partials' row chunks hold
# 16 rows each (``fba._ln_part_chunks``)
B, T, D, H = 2, 16, 128, 2
BF = torch.bfloat16


def _rows(x, blk, gy):
    """The plain backward's row quantities the folded sums add up: dqkv
    (fp32, before its bf16 rounding), dh, xhat, ctx16 and g16, (B*T, .)
    each, by the plain version's steps (``fused_ln_attention_block_
    reference_bwd`` without LoRA)."""
    _, xhat, _, _, _, (q, k, v), p, ctx16, scale = fba._forward_parts(
        x, *[blk[n] for n in kc.BLOCK_KEYS[:4]], H, None, None, 0.0)
    g16 = gy.reshape(B * T, D).float().to(BF)
    dctx = fba._split_heads(fba._mm(g16, blk["w_out"].to(BF).T).to(BF), B, T,
                            H)
    dv = fba._mm(p.to(BF).transpose(-1, -2), dctx)
    dp = fba._mm(dctx, v.transpose(-1, -2))
    ds16 = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(BF)
    dq = fba._mm(ds16, k) * scale
    dk = fba._mm(ds16.transpose(-1, -2), q) * scale
    dqkv = torch.cat([fba._merge_heads(a) for a in (dq, dk, dv)], -1)
    dh = fba._mm(dqkv.to(BF), blk["w_qkv"].to(BF).T)
    return dqkv, dh, xhat, ctx16, g16


def _split0_rows(m):
    """The rows dW_out's first split of K covers (``llc_gemm``'s split)."""
    s = fba._weight_grad_splits(D, D, m, 132)
    return min(m, -(-(-(-m // s)) // 64) * 64)


def _plant(fault, monkeypatch, x, blk, gy):
    """Plant one fault in the op's CPU road (its plain backward), as a bug in
    the card's folded sums would show."""
    if fault is None:
        return
    bwd = fba._backward
    dqkv, dh, xhat, ctx16, g16 = _rows(x, blk, gy)
    n = _split0_rows(B * T)

    def bad(x_, g_, *a, **kw):
        (dx, dls, dlb, dwqkv, dbqkv, dwout, dbout), dlora = bwd(x_, g_, *a,
                                                                **kw)
        if fault == "db_qkv_without_last_16_rows":
            dbqkv = dbqkv - dqkv[-16:].sum(0)
        elif fault == "dls_missing_a_block":   # the LN rows' chunk 1
            rows = -(-B * T // fba._ln_part_chunks(B * T, D))
            dls = dls - (dh * xhat)[rows:2 * rows].sum(0)
        elif fault == "dw_out_split_counted_twice":
            dwout = dwout + fba._mm(ctx16[:n].T, g16[:n])
        return (dx, dls, dlb, dwqkv, dbqkv, dwout, dbout), dlora

    monkeypatch.setattr(fba, "_backward", bad)


# each fault and the check that must name it
SEEN_IN = {"db_qkv_without_last_16_rows": "db_qkv",
           "dls_missing_a_block": "dln_scale",
           "dw_out_split_counted_twice": "dw_out"}


@pytest.mark.parametrize("fault", [None, *SEEN_IN])
def test_kernel_check_sees_faults_in_the_folded_sums(fault, monkeypatch):
    """``kernel_check.check_case`` with the weight grads at B = 2, run here
    on the plain versions: it passes as they are and names each fault of
    the weight grads' folded sums (a missing 16-row group of db_qkv, a
    missing LN row chunk's partial of dls, a split of dW_out counted
    twice)."""
    x, blk, _, gy, _ = kc.make_inputs(B, T, D, H, 0, False, 0, device="cpu")
    _plant(fault, monkeypatch, x, blk, gy)
    if fault is None:
        rep = kc.check_case(x, blk, None, gy, None, H, 0.0, True)
        assert all(rep[f"d{k}"]["excess"] == 0.0 for k in kc.BLOCK_KEYS)
    else:
        with pytest.raises(AssertionError, match=f"^{SEEN_IN[fault]}: "):
            kc.check_case(x, blk, None, gy, None, H, 0.0, True)


def _inputs(t, seed=5):
    """f32 inputs of one batch row from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    blk = {"ln_scale": 1 + 0.1 * n(D), "ln_bias": 0.1 * n(D),
           "w_qkv": 0.1 * n(D, 3 * D), "b_qkv": 0.1 * n(3 * D),
           "w_out": 0.1 * n(D, D), "b_out": 0.1 * n(D)}
    return n(1, t, D), blk, n(1, t, D)


@functools.lru_cache(maxsize=None)
def _jax_grads(t):
    """The JAX op's vjp (no LoRA, weight_grads=True) in interpret mode."""
    x, blk, g = _inputs(t)
    args = [jnp.asarray(blk[k]) for k in kc.BLOCK_KEYS]

    def fn(x, a):
        return jax_fused(x, *a, H, 0.0, None, None, True)

    def fwd_bwd(g, x, a):
        _, vjp = jax.vjp(fn, x, a)
        return vjp(g)

    with pltpu.force_tpu_interpret_mode():
        dx, dargs = jax.jit(fwd_bwd)(jnp.asarray(g), jnp.asarray(x), args)
    return np.asarray(dx), [np.asarray(a) for a in dargs]


def test_one_row_weight_grads_match_jax_kernel():
    """B = 1, r = 0, weight_grads=True (Finetuning's op at one batch row):
    dx and every block grad against the JAX op, at
    ``test_backward_matches_jax_kernel``'s tolerance (1e-2 of each grad's
    scale: summation order and the rare flipped bf16 tie)."""
    t = 13
    x, blk, g = _inputs(t)
    jdx, jargs = _jax_grads(t)
    tx = torch.tensor(x, requires_grad=True)
    ta = [torch.tensor(blk[k], requires_grad=True) for k in kc.BLOCK_KEYS]
    y = fba.fused_ln_attention_block(tx, *ta, H, 0.0, None, None, True)
    y.backward(torch.tensor(g))
    for got, want in [(tx.grad, jdx)] + list(zip([a.grad for a in ta],
                                                 jargs)):
        scale = max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2,
                                   atol=1e-2 * scale)
