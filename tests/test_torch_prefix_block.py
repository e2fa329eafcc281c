"""The port's KV-prefix attention op (plain versions, CPU) against the JAX
package's Pallas kernels #3/#4 run in interpret mode, and against autograd."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.ops.fused_block_attn import \
    fused_prefix_attention_block as jax_prefix
from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops import kernel_check as kc
from lifelong_clip_tpu_torch.ops.fused_block_attn import (
    LAUNCHES, fused_prefix_attention_block,
    fused_prefix_attention_block_reference,
    fused_prefix_attention_block_reference_bwd)

H, D, T, P = 4, 64, 13, 5          # T and P both off a multiple of 16
BLOCK_KEYS = ("ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "b_out")
MASKS = ("none", "kill2", "killall")


def _inputs(seed=0, b=2):
    """f32 inputs from a numpy seed; distinct pk and pv."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    blk = {"ln_scale": 1 + 0.1 * n(D), "ln_bias": 0.1 * n(D),
           "w_qkv": 0.1 * n(D, 3 * D), "b_qkv": 0.1 * n(3 * D),
           "w_out": 0.1 * n(D, D), "b_out": 0.1 * n(D)}
    return n(b, T, D), n(b, P, D), n(b, P, D), blk, n(b, T, D)


def _mask(kind):
    """(P + T,) additive mask: no mask, prefix slots 1 and 3 dead, or every
    prefix slot dead."""
    if kind == "none":
        return None
    m = np.zeros(P + T, np.float32)
    m[[1, 3] if kind == "kill2" else slice(0, P)] = -np.inf
    return m


@functools.lru_cache(maxsize=None)
def _jax_ref(kind):
    """The JAX op in interpret mode, jitted once per mask: its output and
    the vjp of g with weight_grads=True (dx, dpk and dpv are also those of
    weight_grads=False, whose block grads are zeros)."""
    x, pk, pv, blk, g = _inputs()
    m = _mask(kind)
    mask = None if m is None else jnp.asarray(m)

    def fn(x, pk, pv, a):
        return jax_prefix(x, pk, pv, *a, H, mask, True)

    def fwd_bwd(g, *args):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        y, grads = jax.jit(fwd_bwd)(
            jnp.asarray(g), jnp.asarray(x), jnp.asarray(pk), jnp.asarray(pv),
            [jnp.asarray(blk[k]) for k in BLOCK_KEYS])
    return np.asarray(y), jax.tree.map(np.asarray, grads)


def _torch_args(kind, grad=False):
    x, pk, pv, blk, g = _inputs()
    t = lambda a: torch.tensor(a, requires_grad=grad)
    m = _mask(kind)
    return (t(x), t(pk), t(pv), [t(blk[k]) for k in BLOCK_KEYS],
            torch.tensor(g), None if m is None else torch.tensor(m))


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("kind", MASKS)
def test_forward_matches_jax_kernel(kind):
    y_ref, _ = _jax_ref(kind)
    tx, tpk, tpv, ta, _, mask = _torch_args(kind)
    out = fused_prefix_attention_block(tx, tpk, tpv, *ta, H, mask)
    plain = fused_prefix_attention_block_reference(tx, tpk, tpv, *ta, H,
                                                   mask)
    # identical bf16 rounding points (h, q/k/v, p, ctx); what remains is
    # fp32 summation order and the rare bf16 tie it flips
    np.testing.assert_allclose(out.numpy(), y_ref, atol=2e-3, rtol=2e-3)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    assert LAUNCHES["fused_prefix_attention_fwd"] == 0   # CPU: no kernel


@pytest.mark.parametrize("weight_grads", [True, False])
@pytest.mark.parametrize("kind", MASKS)
def test_backward_matches_jax_kernel(kind, weight_grads):
    _, (jdx, jdpk, jdpv, jargs) = _jax_ref(kind)
    tx, tpk, tpv, ta, g, mask = _torch_args(kind, grad=True)
    y = fused_prefix_attention_block(tx, tpk, tpv, *ta, H, mask,
                                     weight_grads)
    y.backward(g)
    # the backward repeats the kernel's bf16 rounding of dctx, ds and
    # dq/dk/dv; a flipped tie moves a grad by ~1e-2 relative on O(1) values
    for got, want in [(tx.grad, jdx), (tpk.grad, jdpk), (tpv.grad, jdpv)]:
        _close(got.numpy(), want, 1e-2)
    for a, want in zip(ta, jargs):
        if weight_grads:
            _close(a.grad.numpy(), want, 1e-2)
            assert float(a.grad.abs().max()) > 0
        else:
            np.testing.assert_array_equal(a.grad.numpy(), 0.0)
    dead = [] if kind == "none" else [1, 3] if kind == "kill2" else range(P)
    for grad in (tpk.grad, tpv.grad):
        for j in range(P):
            live = float(grad[:, j].abs().max())
            assert (live == 0.0) if j in dead else (live > 0), (kind, j)


P_LONG = 244   # S = P + T = 257: past the 256 keys a register row holds


@functools.lru_cache(maxsize=None)
def _jax_ref_long():
    """Inputs at S = 257 (one batch row; slots 100-149 dead) and the JAX op
    in interpret mode on them, jitted once: its output and the vjp of g
    with weight_grads=True."""
    rng = np.random.default_rng(5)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    blk = {"ln_scale": 1 + 0.1 * n(D), "ln_bias": 0.1 * n(D),
           "w_qkv": 0.1 * n(D, 3 * D), "b_qkv": 0.1 * n(3 * D),
           "w_out": 0.1 * n(D, D), "b_out": 0.1 * n(D)}
    x, pk, pv, g = n(1, T, D), n(1, P_LONG, D), n(1, P_LONG, D), n(1, T, D)
    m = np.zeros(P_LONG + T, np.float32)
    m[100:150] = -np.inf
    ins = (x, pk, pv, blk, g, m)

    def fn(x, pk, pv, a):
        return jax_prefix(x, pk, pv, *a, H, jnp.asarray(m), True)

    def fwd_bwd(g, *args):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        y, grads = jax.jit(fwd_bwd)(
            jnp.asarray(g), jnp.asarray(x), jnp.asarray(pk), jnp.asarray(pv),
            [jnp.asarray(blk[k]) for k in BLOCK_KEYS])
    return ins, np.asarray(y), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_past_256_keys_matches_jax_kernel(direction):
    """S = P + T = 257 keys, which the card takes on its tiled roads: the
    op's output, and dx, dpk, dpv and the block grads with weight_grads,
    against the JAX kernels, at the tolerances of the tests above; dead
    slots' grads exactly zero."""
    (x, pk, pv, blk, g, m), y_ref, grads = _jax_ref_long()
    t = lambda a: torch.tensor(a, requires_grad=direction == "backward")
    tx, tpk, tpv = t(x), t(pk), t(pv)
    ta = [t(blk[k]) for k in BLOCK_KEYS]
    y = fused_prefix_attention_block(tx, tpk, tpv, *ta, H, torch.tensor(m),
                                     True)
    if direction == "forward":
        np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=2e-3,
                                   rtol=2e-3)
        return
    y.backward(torch.tensor(g))
    jdx, jdpk, jdpv, jargs = grads
    for got, want in [(tx.grad, jdx), (tpk.grad, jdpk), (tpv.grad, jdpv),
                      *zip([a.grad for a in ta], jargs)]:
        _close(got.numpy(), want, 1e-2)
    for leaf in (tpk, tpv):
        assert float(leaf.grad[:, 100:150].abs().max()) == 0.0


def test_shared_prompt_tensor_gets_both_grads():
    """mvp-clip passes one tensor as pk and pv: autograd sums dpk + dpv."""
    _, (_, jdpk, jdpv, _) = _jax_ref("kill2")
    tx, tpk, _, ta, g, mask = _torch_args("kill2", grad=True)
    y = fused_prefix_attention_block(tx, tpk, tpk, *ta, H, mask, False)
    y.backward(g)
    # JAX's run had distinct pv: compare against the port's own split
    x, pk, _, blk, _ = _inputs()
    ref = fused_prefix_attention_block_reference_bwd(
        torch.tensor(x), g, torch.tensor(pk), torch.tensor(pk),
        *[torch.tensor(blk[k]) for k in BLOCK_KEYS[:5]], H, mask, False)
    np.testing.assert_allclose(tpk.grad.numpy(), (ref[1] + ref[2]).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert jdpk.shape == jdpv.shape == tpk.grad.shape


def test_plain_backward_matches_autograd():
    """The hand-written plain backward equals autograd of the plain forward
    (autograd treats each bf16 cast as identity, so the two differ only by
    the rounding the backward kernel applies to its own operands)."""
    tx, tpk, tpv, ta, g, mask = _torch_args("kill2", grad=True)
    y = fused_prefix_attention_block_reference(tx, tpk, tpv, *ta, H, mask)
    y.backward(g)
    got = fused_prefix_attention_block_reference_bwd(
        tx.detach(), g, tpk.detach(), tpv.detach(),
        *[a.detach() for a in ta[:5]], H, mask, True)
    want = [tx.grad, tpk.grad, tpv.grad] + [a.grad for a in ta]
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy(), 3e-2)


def _fault(name, monkeypatch):
    """Plant one fault in the prefix op's CPU road (its plain versions), as
    a kernel bug would show on the card."""
    fwd, bwd = fba._prefix_forward, fba._prefix_backward
    if name == "dpk_dpv_swapped":
        def bad_bwd(*a, **kw):
            dx, dpk, dpv, *rest = bwd(*a, **kw)
            return (dx, dpv, dpk, *rest)
        monkeypatch.setattr(fba, "_prefix_backward", bad_bwd)
    elif name == "dead_slot_live":       # slot 3 dead in the mask
        def live(mask):
            mask = mask.clone()
            mask[3] = 0.0
            return mask
        monkeypatch.setattr(fba, "_prefix_forward", lambda x, *a, **kw: fwd(
            x, *a[:-1], live(a[-1]), **kw))
        monkeypatch.setattr(fba, "_prefix_backward", lambda x, g, *a, **kw:
                            bwd(x, g, *a[:-2], live(a[-2]), a[-1], **kw))


SEEN_IN = {"dpk_dpv_swapped": "dpk", "dead_slot_live": "y"}


@pytest.mark.parametrize("fault", [None, *SEEN_IN])
def test_prefix_kernel_check_sees_planted_faults(fault, monkeypatch):
    """The check that holds the prefix kernels against their plain versions
    on the card (``ops/kernel_check.py:check_prefix_case``), run here on
    the plain versions: it passes as they are and fails with each fault."""
    x, pk, pv, blk, gy, mask = kc.make_prefix_inputs(2, 13, 128, 2, 5, 2, 0,
                                                     device="cpu")
    _fault(fault, monkeypatch)
    if fault is None:
        rep = kc.check_prefix_case(x, pk, pv, blk, gy, mask, 2, False)
        assert rep["y"]["excess"] == 0.0 and rep["dpk"]["excess"] == 0.0
        assert rep["prefix_term"]["max"] >= rep["prefix_term"]["needed"]
    else:
        with pytest.raises(AssertionError, match=f"^{SEEN_IN[fault]}: "):
            kc.check_prefix_case(x, pk, pv, blk, gy, mask, 2, False)


def test_cuda_tensor_without_card_raises_not_falls_back():
    """The op never falls back to its plain version for a non-CPU tensor,
    and the prefix op's shape check, which no longer depends on the key
    count S = P + T, still refuses a head dim the kernels lack."""
    tx, tpk, tpv, ta, _, _ = _torch_args("none")
    meta = lambda a: a.to("meta")
    with pytest.raises(RuntimeError):
        fused_prefix_attention_block(meta(tx), meta(tpk), meta(tpv),
                                     *[meta(a) for a in ta], H)
    # the check looks at the tokens' shape only: P adds no limit
    fba._check_cuda(torch.zeros(1, 197, 768), 12,
                    op="fused_prefix_attention_block")
    with pytest.raises(ValueError, match="head dim"):
        fba._check_cuda(torch.zeros(1, 197, 576), 12)   # head dim 48
