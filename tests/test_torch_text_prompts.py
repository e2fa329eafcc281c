"""Text-side KV-prefix prompts: the port's ``encode_text(layer_prompts=...)``
against the JAX package's, on the same weights (JAX's init through the
bridge) and inputs from numpy seeds.

Each query token sees the P prompt slots and the tokens up to its own
(``causal_mask(T, prefix=P)``). Without LoRA on the text tower the
attention half goes to the KV-prefix op (kernels #3/#4 on the card), with
it to LN and ``multi_head_attention`` on the flash op (#5/#6): the port's
``"fused"`` road (the ops' plain versions on the CPU) is held against
JAX's ``"pallas"`` road in interpret mode, ``"unfused"`` against
``"xla"``. Prompts come as (L, P, D), broadcast over the rows, or as (L,
B, P, D); the features and the grads of the prompts and of the PEFT leaves
(``base_grads=False``, as a train step of prompts takes them) are
compared. The context is cut to 13 tokens: the interpret-mode kernels'
time grows with it, and 13 query rows still leave part of a 16-row tile
empty, as 77 do.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import PEFTConfig as JPEFTConfig
from lifelong_clip_tpu.models import clip as jclip
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.models.peft import init_tower_peft
from lifelong_clip_tpu.ops.attention import causal_mask as jcausal_mask
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import CLIPConfig, PEFTConfig
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.ops import flash_attention as tflash
from lifelong_clip_tpu_torch.ops.attention import causal_mask
from test_engine import TINY as ENGINE_TINY

JTINY = dataclasses.replace(ENGINE_TINY, context_length=13)
TINY = CLIPConfig(**{f: getattr(JTINY, f) for f in (
    "embed_dim", "image_size", "patch_size", "vision_width", "vision_layers",
    "vision_heads", "context_length", "vocab_size", "text_width",
    "text_heads", "text_layers")})
N_P = 3            # prompt slots a layer
N_ROWS = 3
PEFT_KW = {"lora": dict(method="lora", encoder="text", lora_r=4,
                        lora_alpha=16),
           "adapter": dict(method="adapter", encoder="text")}
# (port road, JAX road, prompt shape, PEFT on the text tower, port remat)
CASES = [(impl, jimpl, shape, peft, False)
         for impl, jimpl in (("fused", "pallas"), ("unfused", "xla"))
         for peft in ("none", "lora")
         for shape in ("shared", "rows")]
CASES.append(("fused", "pallas", "shared", "adapter", True))


@pytest.fixture(scope="module")
def inputs():
    frozen = init_clip_params(jax.random.PRNGKey(0), JTINY)
    rng = np.random.default_rng(0)
    tokens = np.zeros((N_ROWS, JTINY.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:6] = rng.integers(1000, 40000, (N_ROWS, 5))
    tokens[np.arange(N_ROWS), [6, 4, 7]] = 49407
    n_l, d = JTINY.text_layers, JTINY.text_width
    prompts = {"shared": rng.standard_normal((n_l, N_P, d)),
               "rows": rng.standard_normal((n_l, N_ROWS, N_P, d))}
    pefts = {"none": None}
    for name, kw in PEFT_KW.items():
        tree = init_tower_peft(jax.random.PRNGKey(1), n_l, d,
                               JPEFTConfig(**kw))
        # the zero-init up factors (LoRA's b_out, the adapter's w_up) would
        # zero the grads of the factors before them: perturb them
        inner = tree[name]
        up = "b_out" if name == "lora" else "w_up"
        inner[up] = 0.1 * jax.random.normal(jax.random.PRNGKey(3),
                                            inner[up].shape)
        pefts[name] = jax.tree.map(np.asarray, tree)
    return (frozen, params_from_numpy(jax.tree.map(np.asarray, frozen)),
            tokens, {k: v.astype(np.float32) for k, v in prompts.items()},
            pefts)


def _jax_text(frozen, tokens, prompts, peft, peft_name, jimpl):
    """JAX's fp32 text features and the grads of the prompts and the PEFT
    leaves, from one jitted run (in interpret mode each run compiles the
    Pallas kernels anew)."""
    jcfg = None if peft is None else JPEFTConfig(**PEFT_KW[peft_name])

    def loss(lp, p):
        txt = jclip.encode_text(frozen, jnp.asarray(tokens), JTINY,
                                peft_cfg=jcfg, peft=p, layer_prompts=lp,
                                compute_dtype=jnp.float32, attn_impl=jimpl,
                                base_grads=False)
        return jnp.sum(txt.astype(jnp.float32) ** 2), txt

    run = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    args = (jnp.asarray(prompts), jax.tree.map(jnp.asarray, peft))
    if jimpl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            (_, txt), grads = run(*args)
    else:
        (_, txt), grads = run(*args)
    return jax.tree.map(np.asarray, (txt, grads))


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("impl,jimpl,shape,peft_name,remat", CASES,
                         ids=["-".join(map(str, c[:4])) + ("-remat" if c[4]
                                                           else "")
                              for c in CASES])
def test_encode_text_with_prompts_matches_jax(inputs, impl, jimpl, shape,
                                              peft_name, remat):
    frozen, tfrozen, tokens, prompts, pefts = inputs
    peft = pefts[peft_name]
    want, (want_dp, want_dpeft) = _jax_text(frozen, tokens, prompts[shape],
                                            peft, peft_name, jimpl)
    tprompts = torch.tensor(prompts[shape], requires_grad=True)
    tpeft = None if peft is None else params_from_numpy(peft)
    leaves = [] if tpeft is None else list(tpeft[peft_name].values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = tclip.encode_text(
        tfrozen, torch.tensor(tokens), TINY,
        peft_cfg=None if peft is None else PEFTConfig(**PEFT_KW[peft_name]),
        peft=tpeft, layer_prompts=tprompts, compute_dtype=torch.float32,
        attn_impl=impl, base_grads=False, remat=remat)
    (got.float() ** 2).sum().backward()
    # "unfused": fp32 both sides, summation order only. "fused": both round
    # qkv, p and ctx to bf16 at the kernels' points (test_torch_clip.py)
    tol_y, tol_g = (2e-3, 1e-2) if impl == "fused" else (1e-4, 1e-4)
    _close(got.detach().numpy(), want, tol_y)
    assert tprompts.grad.shape == tprompts.shape
    _close(tprompts.grad.numpy(), want_dp, tol_g)
    for k, leaf in (tpeft or {}).get(peft_name, {}).items():
        _close(leaf.grad.numpy(), want_dpeft[peft_name][k], tol_g)


@pytest.mark.parametrize("t,prefix", [(5, 0), (5, 3), (77, 20)])
def test_causal_mask_matches_jax(t, prefix):
    got = causal_mask(t, prefix=prefix)
    assert got.shape == (t, prefix + t)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcausal_mask(t, prefix=prefix)))


@pytest.mark.parametrize("peft_name", ["none", "lora"])
def test_prompts_reach_their_op_with_the_prefix_mask(inputs, monkeypatch,
                                                     peft_name):
    """On the "fused" road each text block takes the KV-prefix op without
    LoRA and the flash op with it, and the op sees the (T, P + T) causal
    prefix mask."""
    _, tfrozen, tokens, prompts, pefts = inputs
    seen = {"prefix": [], "flash": []}
    real_prefix, real_flash = (tclip.fused_prefix_attention_block,
                               tflash.flash_attention)

    def prefix_op(*args):
        seen["prefix"].append(args[10])
        return real_prefix(*args)

    def flash_op(q, k, v, n_heads, mask=None):
        seen["flash"].append(mask)
        return real_flash(q, k, v, n_heads, mask=mask)

    monkeypatch.setattr(tclip, "fused_prefix_attention_block", prefix_op)
    monkeypatch.setattr(tflash, "flash_attention", flash_op)
    peft = pefts[peft_name]
    tclip.encode_text(
        tfrozen, torch.tensor(tokens), TINY,
        peft_cfg=None if peft is None else PEFTConfig(**PEFT_KW[peft_name]),
        peft=None if peft is None else params_from_numpy(peft),
        layer_prompts=torch.tensor(prompts["shared"]),
        compute_dtype=torch.float32)
    want = causal_mask(TINY.context_length, prefix=N_P)
    hit, missed = (("flash", "prefix") if peft_name == "lora"
                   else ("prefix", "flash"))
    assert len(seen[hit]) == TINY.text_layers and not seen[missed], seen
    for mask in seen[hit]:
        torch.testing.assert_close(mask.reshape(want.shape), want,
                                   rtol=0, atol=0)
