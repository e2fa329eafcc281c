"""The chains' LN backward on the CPU: ``fba.ln_backward`` takes its plain
version (``fba.ln_backward_reference``) on a CPU tensor, and that plain
version is dx = g + the VJP of the JAX package's ``layer_norm``
(``lifelong_clip_tpu/models/clip.py``), which the TPU kernel's LN backward
(``ops/fused_block_attn.py:_bwd_kernel``, ``:436-444``) computes. The
bulk-copy kernel itself runs only on the card
(``tests/test_torch_gemm_ln_card.py``)."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_clip_tpu.models.clip import layer_norm
from lifelong_clip_tpu_torch.ops import fused_block_attn as fba


def _inputs(m, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32) + 0.5,
            (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("m,d", [(7, 64), (33, 96)])
def test_ln_backward_matches_the_jax_layer_norm_vjp(m, d):
    """dx = g + LN'(x)^T dh in fp32 against g + jax.vjp(layer_norm) at dh:
    within 1e-5 of dx's max (the sums in another order); each row's (mean,
    rstd) against numpy's."""
    x, gamma, beta, dh, g = _inputs(m, d, m + d)
    _, vjp = jax.vjp(lambda a: layer_norm(a, {"scale": gamma, "bias": beta}),
                     jnp.asarray(x))
    want = g + np.asarray(vjp(jnp.asarray(dh))[0])
    got, stats = fba.ln_backward_reference(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(dh),
        torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(stats[:, 0].numpy(), x.mean(-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(stats[:, 1].numpy(),
                               1 / np.sqrt(x.var(-1) + fba.EPS), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_backward_takes_the_plain_version_on_the_cpu(dtype):
    """On a CPU tensor the wrapper launches nothing: dx is the plain
    version's, in x's dtype, bit for bit."""
    x, gamma, _, dh, g = (torch.from_numpy(a) for a in _inputs(5, 64, 3))
    x, g = x.to(dtype), g.to(dtype)
    got = fba.ln_backward(x, gamma.to(dtype), dh, g)
    want = fba.ln_backward_reference(x, gamma.to(dtype), dh, g)[0]
    assert got.dtype == dtype and torch.equal(got, want)
