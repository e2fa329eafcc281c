"""The flash backward's split products, emulated on the CPU and held against
the JAX package's Pallas backward kernel in interpret mode.

On the card, the bf16 backward (``csrc/flash_attention.cu``:
``flash_bwd_dq_tc_kernel`` and ``flash_bwd_dkv_tc_kernel``) multiplies the
bf16 inputs on tensor cores (q k^T, g v^T: exact products, fp32 sums) and
takes each product that contracts over the fp32 p or ds (dv = p^T g,
dq = ds k, dk = ds^T q) as two bf16 products, hi = bf16(x) and
lo = bf16(x - hi), summed in fp32. ``_split_bwd`` repeats that arithmetic
in plain torch, so the rounding budget of the design shows before any card
run: against ``_attn_bwd_kernel`` (fp32 p and ds, never rounded) it stays
within ``FLASH_REL`` of each grad's max beyond one bf16 ulp, the tolerance
``ops/kernel_check.py`` holds the card's kernels to. The port's plain
versions stay exact fp32; the emulation lives here only.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.ops import flash_attention as jfa
from lifelong_clip_tpu.ops.attention import causal_mask as jcausal
from lifelong_clip_tpu_torch.ops.kernel_check import FLASH_REL, ULP

B, T, S, D, H = 2, 13, 20, 128, 2      # B*H = 4 heads of 64
MASKS = ("none", "row", "causal", "causal+row")


def _mask(kind):
    """None, an (S,) key row with two dead keys, the (T, S) causal mask
    with S - T always-visible prefix keys, or both added."""
    if kind == "none":
        return None
    row = np.zeros(S, np.float32)
    row[[3, 11]] = -np.inf
    if kind == "row":
        return row
    causal = np.array(jcausal(T, prefix=S - T))
    return causal if kind == "causal" else causal + row[None, :]


def _inputs():
    """q, k, v and the output grad, bf16 values from a numpy seed."""
    rng = np.random.default_rng(3)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, D), (B, S, D), (B, S, D), (B, T, D))]


_JAX = {}


def _jax_grads(kind):
    """dq, dk, dv of JAX's flash op on the bf16 inputs (its backward is the
    Pallas ``_attn_bwd_kernel``, run in interpret mode), as fp32."""
    if kind not in _JAX:
        q, k, v, g = (jnp.asarray(a, jnp.bfloat16) for a in _inputs())
        m = _mask(kind)
        m = None if m is None else jnp.asarray(m)

        def run(q, k, v, g):
            _, vjp = jax.vjp(
                lambda q, k, v: jfa.flash_attention(q, k, v, H, m), q, k, v)
            return vjp(g)

        with pltpu.force_tpu_interpret_mode():
            grads = jax.jit(run)(q, k, v, g)
        _JAX[kind] = [np.asarray(a.astype(jnp.float32)) for a in grads]
    return _JAX[kind]


def _split(x):
    """x = hi + lo + r: hi = bf16(x), lo = bf16(x - hi), as fp32 values."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _split_mm(x, b):
    """x @ b on tensor cores: the fp32 x as bf16 hi and lo, b bf16-valued,
    every product exact in fp32 and summed in fp32."""
    hi, lo = _split(x)
    return hi @ b + lo @ b


def _split_bwd(q, k, v, g, mask, mm=_split_mm):
    """(dq, dk, dv), rounded to bf16, with the card's arithmetic; inputs are
    (B, L, D) fp32 tensors holding bf16 values."""
    def heads(x):
        return x.reshape(B, -1, H, D // H).transpose(1, 2)

    def merge(x):
        return x.transpose(1, 2).reshape(B, -1, D).bfloat16().float()

    qh, kh, vh, gh = (heads(a) for a in (q, k, v, g))
    scale = (D // H) ** -0.5
    s = qh @ kh.transpose(-1, -2) * scale
    if mask is not None:
        s = s + mask
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dv = mm(p.transpose(-1, -2), gh)
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    return merge(dq), merge(dk), merge(dv)


def _excess(got, want):
    """max(|got - want| - one bf16 ulp) over the grad's max."""
    want = torch.tensor(want)
    diff = (got - want).abs() - ULP * torch.maximum(got.abs(), want.abs())
    return float(diff.clamp(min=0).max()) / float(want.abs().max())


def _run(kind, mm=_split_mm):
    q, k, v, g = (torch.from_numpy(a).bfloat16().float() for a in _inputs())
    m = _mask(kind)
    got = _split_bwd(q, k, v, g, None if m is None else torch.from_numpy(m),
                     mm)
    return [_excess(a, w) for a, w in zip(got, _jax_grads(kind))]


def _one_rounding_mm(x, b):
    """x @ b with the fp32 x rounded once to bf16, as a plain bf16 MMA
    would take it."""
    return x.bfloat16().float() @ b


@pytest.mark.parametrize("products", ("split", "one rounding"))
@pytest.mark.parametrize("kind", MASKS)
def test_split_products_against_the_tpu_backward(kind, products):
    """With hi + lo products over p and ds, dq, dk and dv stay within
    FLASH_REL of JAX's; with p and ds rounded once to bf16 they leave it by
    more than 3x: the split is needed, and enough."""
    if products == "split":
        for name, ex in zip(("dq", "dk", "dv"), _run(kind)):
            assert ex <= FLASH_REL, (name, ex)
    else:
        assert max(_run(kind, mm=_one_rounding_mm)) > 3 * FLASH_REL
