"""The port's fused LN-attention op (plain versions, CPU) against the JAX
package's Pallas kernels run in interpret mode, and against autograd."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.ops.attention import causal_mask as jax_causal_mask
from lifelong_clip_tpu.ops.fused_block_attn import \
    fused_ln_attention_block as jax_fused
from lifelong_clip_tpu_torch.ops.attention import causal_mask
from lifelong_clip_tpu_torch.ops.fused_block_attn import (
    LAUNCHES, fused_ln_attention_block, fused_ln_attention_block_reference,
    fused_ln_attention_block_reference_bwd)

H, D, R, S = 4, 64, 4, 0.25
LORA_KEYS = ("a_in", "b_in", "a_out", "b_out")
BLOCK_KEYS = ("ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "b_out")


def _inputs(t, seed=0, b=2, d=D):
    """f32 inputs from a numpy seed: only the kernels' own bf16 rounding
    points separate the two implementations."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    blk = {"ln_scale": 1 + 0.1 * n(d), "ln_bias": 0.1 * n(d),
           "w_qkv": 0.1 * n(d, 3 * d), "b_qkv": 0.1 * n(3 * d),
           "w_out": 0.1 * n(d, d), "b_out": 0.1 * n(d)}
    lora = {"a_in": 0.1 * n(d, R), "b_in": 0.1 * n(R, 3 * d),
            "a_out": 0.1 * n(d, R), "b_out": 0.1 * n(R, d)}
    return n(b, t, d), blk, lora, n(b, t, d)


def _jax_call(x, blk, lora, masked):
    t = x.shape[1]
    mask = jax_causal_mask(t) if masked else None
    args = [jnp.asarray(blk[k]) for k in BLOCK_KEYS]
    lo = None if lora is None else {k: jnp.asarray(v) for k, v in lora.items()}

    def fn(x, a, lo):
        return jax_fused(x, *a, H, S if lo is not None else 0.0, mask, lo,
                         True)
    return fn, (jnp.asarray(x), args, lo)


def _torch_args(x, blk, lora, masked, grad=False):
    tx = torch.tensor(x, requires_grad=grad)
    ta = [torch.tensor(blk[k], requires_grad=grad) for k in BLOCK_KEYS]
    tl = None if lora is None else {
        k: torch.tensor(v, requires_grad=grad) for k, v in lora.items()}
    mask = causal_mask(x.shape[1]) if masked else None
    return tx, ta, tl, mask


@functools.lru_cache(maxsize=None)
def _jax_ref(t, masked, use_lora):
    """The JAX op in interpret mode, jitted once per (t, mask, LoRA)
    combination (each run compiles its kernels anew): its output and, with
    LoRA, the vjp of g with weight_grads=True. Its dx and LoRA grads are
    also those of weight_grads=False, whose base-weight grads are zeros."""
    x, blk, lora, g = _inputs(t)
    fn, args = _jax_call(x, blk, lora if use_lora else None, masked)
    with pltpu.force_tpu_interpret_mode():
        if not use_lora:
            return np.asarray(jax.jit(fn)(*args)), None

        def fwd_bwd(g, *args):
            y, vjp = jax.vjp(fn, *args)
            return y, vjp(g)

        y, grads = jax.jit(fwd_bwd)(jnp.asarray(g), *args)
    return np.asarray(y), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("t,masked,use_lora", [
    (9, False, False), (9, True, True), (13, False, True), (13, True, False)])
def test_forward_matches_jax_kernel(t, masked, use_lora):
    x, blk, lora, _ = _inputs(t)
    lora = lora if use_lora else None
    ref, _ = _jax_ref(t, masked, use_lora)
    tx, ta, tl, mask = _torch_args(x, blk, lora, masked)
    out = fused_ln_attention_block(tx, *ta, H, S if tl else 0.0, mask, tl)
    plain = fused_ln_attention_block_reference(tx, *ta, H,
                                               S if tl else 0.0, mask, tl)
    # identical bf16 rounding points; what remains is fp32 summation order
    # and the rare bf16 tie it flips (one bf16 ulp of qkv or p, ~4e-3
    # relative, on an O(1) output)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=2e-3)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    assert LAUNCHES["fused_ln_attention_fwd"] == 0   # CPU: no kernel launch


@pytest.mark.parametrize("t,masked,weight_grads", [
    (9, True, True), (9, True, False), (13, False, True), (13, False, False)])
def test_backward_matches_jax_kernel(t, masked, weight_grads):
    x, blk, lora, g = _inputs(t)
    _, (jdx, jargs, jlora) = _jax_ref(t, masked, True)
    tx, ta, tl, mask = _torch_args(x, blk, lora, masked, grad=True)
    y = fused_ln_attention_block(tx, *ta, H, S, mask, tl, weight_grads)
    y.backward(torch.tensor(g))
    # the backward repeats the kernel's bf16 rounding points; summation
    # order differs and a flipped bf16 tie of dqkv16/ds16 moves a grad by
    # ~1e-2 relative on O(1) values, so 1e-2 of the grad's scale
    pairs = [(tx.grad, jdx)] + [(tl[k].grad, jlora[k]) for k in LORA_KEYS]
    if weight_grads:
        pairs += list(zip([a.grad for a in ta], jargs))
    for got, want in pairs:
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2,
                                   atol=1e-2 * scale)
    for a in ta:
        if weight_grads:
            assert float(a.grad.abs().max()) > 0
        else:
            np.testing.assert_array_equal(a.grad.numpy(), 0.0)
    for k in LORA_KEYS:
        assert float(tl[k].grad.abs().max()) > 0, k


T_LONG = 257   # ViT-L/14's token count: past the 256 keys a register row holds
T_FIFTH = 320  # a whole fifth 64-key tile (the card's long road: every tile full)


@functools.lru_cache(maxsize=None)
def _jax_ref_long(t=T_LONG):
    """The JAX op in interpret mode at ``t`` tokens (one batch row, LoRA,
    no mask), jitted once a T: its output and the vjp of g with
    weight_grads=True."""
    x, blk, lora, g = _inputs(t, seed=3, b=1)
    fn, args = _jax_call(x, blk, lora, False)

    def fwd_bwd(g, *args):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        y, grads = jax.jit(fwd_bwd)(jnp.asarray(g), *args)
    return np.asarray(y), jax.tree.map(np.asarray, grads)


def _check_long(t, direction):
    x, blk, lora, g = _inputs(t, seed=3, b=1)
    y_ref, (jdx, jargs, jlora) = _jax_ref_long(t)
    tx, ta, tl, _ = _torch_args(x, blk, lora, False,
                                grad=direction == "backward")
    y = fused_ln_attention_block(tx, *ta, H, S, None, tl, True)
    if direction == "forward":
        np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=2e-3,
                                   rtol=2e-3)
        return
    y.backward(torch.tensor(g))
    pairs = [(tx.grad, jdx)] + [(tl[k].grad, jlora[k]) for k in LORA_KEYS]
    pairs += list(zip([a.grad for a in ta], jargs))
    for got, want in pairs:
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2,
                                   atol=1e-2 * scale)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_past_256_keys_matches_jax_kernel(direction):
    """T = 257 keys (ViT-L/14), which the card takes on its long
    warpgroup-MMA road (one live key in the last 64-key tile): the op's
    output, and every grad with weight_grads, against the JAX kernels, at
    the tolerances of the tests above."""
    _check_long(T_LONG, direction)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_a_whole_fifth_key_tile_matches_jax_kernel(direction):
    """T = 320 keys, five whole 64-key tiles on the card's long road: as
    the T = 257 case."""
    _check_long(T_FIFTH, direction)


def test_card_shape_check_takes_any_key_count():
    """The kernels' shape check (it raises before any launch, so it runs
    here on the CPU): ViT-L/14's vision block (T = 257, D = 1024, 16 heads)
    and S = 512 keys pass; head dim 48 and D > 1024 (the LN kernels' row)
    still raise."""
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    fba._check_cuda(torch.zeros(1, 257, 1024, dtype=torch.bfloat16), 16)
    fba._check_cuda(torch.zeros(1, 512, 768), 12)
    fba._check_cuda(torch.zeros(1, 197, 768), 12,
                    op="fused_prefix_attention_block")   # with P = 315
    with pytest.raises(ValueError, match="head dim"):
        fba._check_cuda(torch.zeros(1, 9, 96), 2)        # head dim 48
    with pytest.raises(ValueError, match="D <= 1024"):
        fba._check_cuda(torch.zeros(1, 9, 1280), 20)     # D = 1280
    with pytest.raises(TypeError):
        fba._check_cuda(torch.zeros(1, 9, 64, dtype=torch.float16), 1)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_backward_matches_autograd(masked):
    """The hand-written plain backward equals autograd of the plain forward
    (autograd treats each bf16 cast as identity, so the two differ only by
    the rounding the backward kernel applies to its own operands)."""
    x, blk, lora, g = _inputs(9, seed=2)
    tx, ta, tl, mask = _torch_args(x, blk, lora, masked, grad=True)
    y = fused_ln_attention_block_reference(tx, *ta, H, S, mask, tl)
    y.backward(torch.tensor(g))
    grads, dlora = fused_ln_attention_block_reference_bwd(
        tx.detach(), torch.tensor(g), *[a.detach() for a in ta[:5]], H, S,
        mask, {k: v.detach() for k, v in tl.items()}, True)
    got = list(grads) + [dlora[k] for k in LORA_KEYS]
    want = [tx.grad] + [a.grad for a in ta] + [tl[k].grad for k in LORA_KEYS]
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-2,
                                   atol=3e-2 * scale)


def test_lora_grads_come_back_in_primal_dtype():
    """bf16 LoRA primals get bf16 grads (``_fused_bwd:236-245``)."""
    x, blk, lora, g = _inputs(9, seed=3)
    tx, ta, _, _ = _torch_args(x, blk, None, False)
    tl = {k: torch.tensor(v).to(torch.bfloat16).requires_grad_()
          for k, v in lora.items()}
    y = fused_ln_attention_block(tx, *ta, H, S, None, tl, False)
    y.backward(torch.tensor(g))
    for k in LORA_KEYS:
        assert tl[k].grad.dtype == torch.bfloat16


def _fault(name, monkeypatch):
    """Plant one fault in the op's CPU road (its plain versions), as a
    kernel bug would show on the card."""
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    fwd, bwd, qkv = fba._forward, fba._backward, kc.kernel_qkv
    if name == "lora_out_doubled":        # LoRA-out epilogue scale
        monkeypatch.setattr(fba, "_forward", lambda x, *a, **kw: fwd(
            x, *a[:-1], dict(a[-1], b_out=2 * a[-1]["b_out"]), **kw))
    elif name == "b_in_strided":          # LoRA-in B read transposed
        def bad_qkv(x, blk, lora, s, heads):
            b_in = lora["b_in"].reshape(-1, lora["b_in"].shape[0]).T
            return qkv(x, blk, dict(lora, b_in=b_in), s, heads)
        monkeypatch.setattr(kc, "kernel_qkv", bad_qkv)
    elif name == "ln_bwd_5pct":           # LN backward 5% off
        def bad_bwd(x, g, *a, **kw):
            grads, dlora = bwd(x, g, *a, **kw)
            dx = (g + 1.05 * (grads[0].float() - g.float())).to(x.dtype)
            return (dx,) + grads[1:], dlora
        monkeypatch.setattr(fba, "_backward", bad_bwd)
    elif name == "lora_grads_swapped":    # dA_in and dA_out (same shape)
        def bad_bwd(x, g, *a, **kw):
            grads, dlora = bwd(x, g, *a, **kw)
            return grads, dict(dlora, a_in=dlora["a_out"],
                               a_out=dlora["a_in"])
        monkeypatch.setattr(fba, "_backward", bad_bwd)


# each fault and the check that must see it
SEEN_IN = {"lora_out_doubled": "y", "b_in_strided": "qkv",
           "ln_bwd_5pct": "dx", "lora_grads_swapped": "lora_da_in"}


@pytest.mark.parametrize("fault", [None, *SEEN_IN])
def test_kernel_check_sees_planted_faults(fault, monkeypatch):
    """The check that holds the CUDA kernels against their plain versions on
    the card (``ops/kernel_check.py``), run here on the plain versions: it
    passes as they are and fails with each fault planted."""
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    x, blk, lora, gy, mask = kc.make_inputs(2, 13, 128, 2, 4, False, 0,
                                            device="cpu")
    _fault(fault, monkeypatch)
    if fault is None:
        rep = kc.check_case(x, blk, lora, gy, mask, 2, S, False)
        assert rep["y"]["excess"] == 0.0 and rep["dx"]["excess"] == 0.0
    else:
        with pytest.raises(AssertionError, match=f"^{SEEN_IN[fault]}: "):
            kc.check_case(x, blk, lora, gy, mask, 2, S, False)


def test_cuda_tensor_without_card_raises_not_falls_back():
    """The op never falls back to its plain version for a non-CPU tensor."""
    x, blk, _, _ = _inputs(9)
    tx, ta, _, _ = _torch_args(x, blk, None, False)
    with pytest.raises(RuntimeError):
        fused_ln_attention_block(tx.to("meta"), *[a.to("meta") for a in ta],
                                 H)
