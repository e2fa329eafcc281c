"""Kernels #1/#2 under the text tower's causal mask, on the CPU.

On the card the block op's attention kernels skip the 16 x 16 blocks that a
(T, T) mask's tile map marks dead and take a plain block's entries from the
map's words. Here: what those maps hold for the causal masks the port's
towers pass (``mask_tile_map_reference``, ``mask_tile_words_reference``),
that the op's preparation builds a map for a (T, T) mask and for nothing
else, once per mask tensor, and that the op under the causal mask at a T of
three row blocks and a partial fourth holds to the JAX package's
``fused_ln_attention_block`` (its Pallas kernels in interpret mode).
"""

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
from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops.attention import causal_mask

BLOCK_KEYS = ("ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "b_out")
LORA_KEYS = ("a_in", "b_in", "a_out", "b_out")


@pytest.mark.parametrize("t,live,total", [(77, 15, 25), (25, 3, 4)])
def test_causal_map_keeps_the_diagonal_and_below(t, live, total):
    """The text tower's (77, 77) mask and ProtoCLIP's (25, 25) prefix mask:
    every block on or below the diagonal live and plain (+0.0 or -inf, its
    entries read from the words), every block above it dead; the words hold
    key j <= row i for keys < T (rows past T all ones)."""
    tm = fba.mask_tile_map_reference(causal_mask(t))
    assert (int((tm > 0).sum()), tm.numel()) == (live, total)
    rb, kb = torch.meshgrid(torch.arange(tm.shape[0]),
                            torch.arange(tm.shape[1]), indexing="ij")
    assert torch.equal(tm == 0, kb > rb)
    assert bool((tm[kb <= rb] == 2).all())
    words = fba.mask_tile_words_reference(causal_mask(t)).long() & 0xffffffff
    n = tm.shape[0] * 16
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    want = ((j <= i) & (j < t)) | (i >= t)
    halves = torch.stack([words & 0xffff, words >> 16], 2)   # (rb, kb, 2, 8)
    got = torch.zeros(n, n, dtype=torch.bool)
    for r in range(16):
        bits = halves[:, :, r // 8, r % 8]                    # (rb, kb)
        for c in range(16):
            got[r::16, c::16] = ((bits >> c) & 1).bool()
    assert torch.equal(got, want)


def test_preparation_builds_a_map_for_a_square_mask_only():
    """``_mask_and_map`` (what ``_Prepared`` runs): a (T, T) mask gets its
    tile map, built once while the tensor lives unchanged; no mask, a
    key-mask row (broadcast to (T, T)) or ``tile_map=False`` gets none."""
    t = 41
    mask = causal_mask(t)
    m32, buf = fba._mask_and_map(mask, t, "cpu")
    assert torch.equal(m32, mask) and buf is not None

    def same_map(a, b):
        return all(torch.equal(u, v) for u, v in zip(
            fba.unpack_tile_map(a, t, t), fba.unpack_tile_map(b, t, t)))

    assert same_map(buf, fba.mask_tile_map(mask))
    assert fba._mask_and_map(mask, t, "cpu")[1] is buf
    row = torch.zeros(t)
    row[5:9] = float("-inf")
    for other in (None, row, row[None]):
        m32, none = fba._mask_and_map(other, t, "cpu")
        assert none is None
        assert (m32 is None) == (other is None)
    assert fba._mask_and_map(mask, t, "cpu", tile_map=False)[1] is None
    mask[0, 1] = 0.0   # an in-place write: a new map
    again = fba._mask_and_map(mask, t, "cpu")[1]
    assert again is not buf
    assert same_map(again, fba.mask_tile_map(mask))
    assert not same_map(again, buf)
    assert fba.LAUNCHES["block_tile_map"] == 0   # CPU: no kernel launch


T, D, H, R, S = 41, 64, 4, 2, 0.25   # 3 row blocks and a partial fourth


def _inputs(seed=7, b=2):
    """f32 inputs from a numpy seed, as ``test_torch_fused_block.py``'s."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    blk = {"ln_scale": 1 + 0.1 * n(D), "ln_bias": 0.1 * n(D),
           "w_qkv": 0.1 * n(D, 3 * D), "b_qkv": 0.1 * n(3 * D),
           "w_out": 0.1 * n(D, D), "b_out": 0.1 * n(D)}
    lora = {"a_in": 0.1 * n(D, R), "b_in": 0.1 * n(R, 3 * D),
            "a_out": 0.1 * n(D, R), "b_out": 0.1 * n(R, D)}
    return n(b, T, D), blk, lora, n(b, T, D)


@functools.lru_cache(maxsize=None)
def _jax_ref():
    """JAX's op under its causal mask in interpret mode, jitted once: the
    output and the vjp of g (dx and the LoRA grads)."""
    x, blk, lora, g = _inputs()
    mask = jax_causal_mask(T)

    def fn(x, lo):
        return jax_fused(x, *[jnp.asarray(blk[k]) for k in BLOCK_KEYS], H, S,
                         mask, lo, False)

    def fwd_bwd(g, x, lo):
        y, vjp = jax.vjp(fn, x, lo)
        return y, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        y, grads = jax.jit(fwd_bwd)(
            jnp.asarray(g), jnp.asarray(x),
            {k: jnp.asarray(v) for k, v in lora.items()})
    return np.asarray(y), jax.tree.map(np.asarray, grads)


def test_causal_block_matches_jax_kernel():
    """The port's op under ``causal_mask(41)`` against JAX's: y within
    2e-3 (the shared bf16 rounding points leave fp32 summation order and
    the rare bf16 tie it flips, one ulp of qkv or p on an O(1) output); dx
    and the LoRA grads within 1e-2 of each grad's scale (a flipped bf16 tie
    of dqkv16 / ds16 moves a grad by ~1e-2 relative)."""
    x, blk, lora, g = _inputs()
    y_ref, (jdx, jlora) = _jax_ref()
    tx = torch.tensor(x, requires_grad=True)
    ta = [torch.tensor(blk[k]) for k in BLOCK_KEYS]
    tl = {k: torch.tensor(v, requires_grad=True) for k, v in lora.items()}
    y = fba.fused_ln_attention_block(tx, *ta, H, S, causal_mask(T), tl,
                                     False)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=2e-3,
                               rtol=2e-3)
    y.backward(torch.tensor(g))
    for got, want in [(tx.grad, jdx)] + [(tl[k].grad, jlora[k])
                                         for k in LORA_KEYS]:
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2,
                                   atol=1e-2 * scale)
        assert scale > 1e-4
