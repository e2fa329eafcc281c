"""The port's flash-attention op (its plain versions on the CPU) against the
JAX package's Pallas flash kernels in interpret mode, on the same inputs.

Tolerances: fp32 2e-5 (forward) and 1e-4 (grads), relative and absolute,
the JAX test's own (``tests/test_flash_attention.py``): both sides compute
in fp32 and differ in summation order only. bf16: both sides compute in
fp32 and round once to bf16, so what differs is a flipped rounding, one
bf16 ulp of the element, at most 2**-7 of the output's scale.
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
from lifelong_clip_tpu_torch.ops import attention as tatt
from lifelong_clip_tpu_torch.ops import flash_attention as tfa

B, T, S, D, H = 2, 13, 20, 128, 2      # head dim 64, as on the card
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
MASKS = ("none", "row", "causal", "leading")


def _mask(kind):
    """None, an (S,) key row with two dead keys, the (T, S) causal mask
    with S - T always-visible prefix keys, or a (1, 1, S) key row."""
    if kind == "none":
        return None
    if kind == "causal":
        return np.asarray(jcausal(T, prefix=S - T))
    row = np.zeros(S, np.float32)
    row[[3, 11]] = -np.inf
    return row if kind == "row" else row.reshape(1, 1, S)


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, D), (B, S, D), (B, S, D), (B, T, D))]


_JAX = {}


def _jax_ref(dtype, kind):
    """JAX's output and q/k/v grads for one cotangent, one jitted run per
    (dtype, mask): interpret mode compiles the kernels anew in each."""
    if (dtype, kind) not in _JAX:
        jdt = DTYPES[dtype][0]
        q, k, v, g = (jnp.asarray(a, jdt) for a in _inputs())
        m = _mask(kind)
        m = None if m is None else jnp.asarray(m)

        def run(q, k, v, g):
            out, vjp = jax.vjp(
                lambda q, k, v: jfa.flash_attention(q, k, v, H, m), q, k, v)
            return out, vjp(g)

        with pltpu.force_tpu_interpret_mode():
            out, grads = jax.jit(run)(q, k, v, g)
        _JAX[dtype, kind] = (np.asarray(out.astype(jnp.float32)),
                             [np.asarray(a.astype(jnp.float32))
                              for a in grads])
    return _JAX[dtype, kind]


def _close(got, want, dtype, tol32):
    got = got.detach().float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=tol32, atol=tol32)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -7 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", MASKS)
def test_flash_op_matches_jax(dtype, kind):
    """Forward and q/k/v grads through the autograd op, T != S."""
    want_out, want_grads = _jax_ref(dtype, kind)
    tdt = DTYPES[dtype][1]
    q, k, v, g = (torch.tensor(a).to(tdt) for a in _inputs())
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    m = _mask(kind)
    out = tfa.flash_attention(*leaves, H, None if m is None
                              else torch.tensor(m))
    assert out.dtype == tdt and out.shape == (B, T, D)
    out.backward(g)
    _close(out, want_out, dtype, 2e-5)
    for leaf, want in zip(leaves, want_grads):
        assert leaf.grad.dtype == tdt
        assert float(np.abs(want).max()) > 0
        _close(leaf.grad, want, dtype, 1e-4)
    if kind in ("row", "leading"):   # dead keys get no grad
        for leaf in leaves[1:]:
            assert float(leaf.grad[:, [3, 11]].abs().max()) == 0.0


def test_plain_versions_are_not_sdpa():
    """The flash arithmetic keeps p in fp32; ``sdpa`` (JAX's ``sdpa_xla``)
    rounds it to the value dtype, so in bf16 they differ by more than the
    output's rounding."""
    q, k, v, _ = (torch.tensor(a).to(torch.bfloat16) for a in _inputs())
    flash = tfa.flash_attention_reference(q, k, v, H).float()
    plain = tatt.sdpa(q, k, v, H).float()
    want, _ = _jax_ref("bf16", "none")
    assert float((flash - torch.tensor(want)).abs().max()) < float(
        (plain - torch.tensor(want)).abs().max())


def test_mask_view_takes_strides_not_copies():
    """An (S,) row becomes a (T, S) view with row stride 0; leading
    singleton dimensions are squeezed as the JAX wrapper squeezes them."""
    row = torch.zeros(S)
    view = tfa._mask_view(row, T, S, torch.device("cpu"))
    assert view.shape == (T, S) and view.stride() == (0, 1)
    assert view.data_ptr() == row.data_ptr()
    full = torch.zeros(1, T, S)
    assert tfa._squeeze_mask(full).shape == (T, S)
    assert tfa._squeeze_mask(row.reshape(1, 1, S)).shape == (S,)


def test_multi_head_attention_flash_road():
    """``impl="flash"`` runs the flash op on the projected q, k, v; a mask
    that depends on the batch takes the plain road, as in JAX."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, T, D, generator=g)
    params = {"w_qkv": 0.1 * torch.randn(D, 3 * D, generator=g),
              "b_qkv": 0.1 * torch.randn(3 * D, generator=g),
              "w_out": 0.1 * torch.randn(D, D, generator=g),
              "b_out": 0.1 * torch.randn(D, generator=g)}
    tfa.reset_launches()
    calls = []
    orig = tfa.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "flash_attention", spy)
        y = tatt.multi_head_attention(x, params, H, impl="flash")
        batch_mask = torch.zeros(B, 1, T, T)
        tatt.multi_head_attention(x, params, H, mask=batch_mask,
                                  impl="flash")
    assert calls == [(B, T, D)]
    y_plain = tatt.multi_head_attention(x, params, H)
    # fp32: the two roads differ in summation order only
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    assert tfa.LAUNCHES == {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}   # the CPU launches none
    with pytest.raises(ValueError):
        tatt.multi_head_attention(x, params, H, impl="pallas")


def _fault(name, monkeypatch):
    """Plant one fault in the op's CPU road (its plain versions), as a
    kernel bug would show on the card."""
    fwd, bwd = tfa._forward, tfa._backward
    if name == "p_rounded":           # p rounded to bf16 before p @ v
        def bad_fwd(q, k, v, n_heads, mask):
            s = tfa._scores(q, k, n_heads, mask)
            p = torch.softmax(s, -1).to(torch.bfloat16).float()
            return tfa._merge(tatt.mm32(p, tfa._heads(v, n_heads)), q.dtype)
        monkeypatch.setattr(tfa, "_forward", bad_fwd)
    elif name == "dk_dv_swapped":
        def bad_bwd(*a):
            dq, dk, dv = bwd(*a)
            return dq, dv, dk
        monkeypatch.setattr(tfa, "_backward", bad_bwd)
    elif name == "dead_key_live":     # key 3 is dead in the mask
        def live(mask):
            mask = mask.clone()
            mask[3] = 0.0
            return mask
        monkeypatch.setattr(tfa, "_forward", lambda q, k, v, h, m: fwd(
            q, k, v, h, live(m)))
        monkeypatch.setattr(tfa, "_backward", lambda q, k, v, g, h, m: bwd(
            q, k, v, g, h, live(m)))


SEEN_IN = {"p_rounded": "o", "dk_dv_swapped": "dk", "dead_key_live": "o"}


@pytest.mark.parametrize("fault", [None, *SEEN_IN])
def test_flash_kernel_check_sees_planted_faults(fault, monkeypatch):
    """The check that holds the flash kernels against their plain versions
    on the card (``ops/kernel_check.py:check_flash_case``), run here on the
    plain versions in fp32: it passes as they are and fails with each
    fault, a bf16 rounding of p included."""
    from lifelong_clip_tpu_torch.ops import kernel_check as kc
    q, k, v, gy, mask = kc.make_flash_inputs(2, 13, 20, 128, 2, 0, mask=2,
                                             dtype=torch.float32,
                                             device="cpu")
    _fault(fault, monkeypatch)
    if fault is None:
        rep = kc.check_flash_case(q, k, v, gy, mask, 2)
        assert all(r["excess"] == 0.0 for r in rep.values())
    else:
        with pytest.raises(AssertionError,
                           match=f"^flash {SEEN_IN[fault]}: "):
            kc.check_flash_case(q, k, v, gy, mask, 2)


def test_non_cpu_tensor_raises_not_falls_back():
    """The op never gives way to its plain version for a tensor off the CPU;
    what the kernels do not take (head dim other than 64, mixed dtypes)
    raises before any launch."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs())
    meta = [a.to("meta") for a in (q, k, v)]
    with pytest.raises(RuntimeError, match="no kernel"):
        tfa.flash_attention(*meta, H)
    with pytest.raises(ValueError, match="head dim 64"):
        tfa._cuda_operands(q, k, v, 4, None)
    with pytest.raises(TypeError):
        tfa._cuda_operands(q, k.to(torch.bfloat16), v, H, None)
