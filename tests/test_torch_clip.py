"""The port's CLIP towers against the JAX package's, on the same weights.

Weights come from the JAX init through the bridge; inputs from numpy seeds.
The port's ``"fused"`` road (the kernel op's plain version on the CPU) is
held against JAX's ``"pallas"`` road in interpret mode, and ``"unfused"``
against ``"xla"``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

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
from lifelong_clip_tpu_torch.bridge import params_from_numpy, params_to_numpy
from lifelong_clip_tpu_torch.config import CLIPConfig, PEFTConfig
from lifelong_clip_tpu_torch.models import clip as tclip
from test_engine import TINY as JTINY

TINY = CLIPConfig(**{f: getattr(JTINY, f) for f in (
    "embed_dim", "image_size", "patch_size", "vision_width", "vision_layers",
    "vision_heads", "context_length", "vocab_size", "text_width",
    "text_heads", "text_layers")})
ROUTES = [("fused", "pallas"), ("unfused", "xla")]


@pytest.fixture(scope="module")
def weights():
    frozen = init_clip_params(jax.random.PRNGKey(0), JTINY)
    jcfg = JPEFTConfig(method="lora", encoder="image", lora_r=4,
                       lora_alpha=16)
    peft = init_tower_peft(jax.random.PRNGKey(1), JTINY.vision_layers,
                           JTINY.vision_width, jcfg)
    # out-proj LoRA B inits to zeros, which would make a_out's grad zero:
    # perturb it so every LoRA grad is exercised (test_fused_block.py:233)
    peft["lora"]["b_out"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(3), peft["lora"]["b_out"].shape)
    np_frozen = jax.tree.map(np.asarray, frozen)
    np_peft = jax.tree.map(np.asarray, peft)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((3, JTINY.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:6] = rng.integers(1000, 40000, (3, 5))
    tokens[np.arange(3), [6, 4, 7]] = 49407
    return (frozen, peft, jcfg, params_from_numpy(np_frozen),
            params_from_numpy(np_peft),
            PEFTConfig(method="lora", encoder="image", lora_r=4,
                       lora_alpha=16), images, tokens)


def _jax(fn, impl):
    if impl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return fn()
    return fn()


def test_bridge_round_trip(weights):
    frozen, _, _, tfrozen, *_ = weights
    back = params_to_numpy(tfrozen)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, frozen)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert tfrozen["vision"]["blocks"]["attn"]["w_qkv"].shape == (
        TINY.vision_layers, TINY.vision_width, 3 * TINY.vision_width)


_JAX_IMAGE = {}


def _jax_image(weights, jimpl):
    """JAX's fp32 image embedding and its LoRA grads (engine's
    base_grads=False) from one jitted run per road: in interpret mode each
    run compiles the Pallas kernels anew."""
    if jimpl not in _JAX_IMAGE:
        frozen, peft, jcfg, *_, images, _ = weights

        def jloss(p, frozen, images):
            img = jclip.encode_image(frozen, images, JTINY, peft_cfg=jcfg,
                                     peft=p, compute_dtype=jnp.float32,
                                     attn_impl=jimpl, base_grads=False)
            return jnp.sum(img.astype(jnp.float32) ** 2), img

        (_, img), grads = _jax(lambda: jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(peft, frozen, jnp.asarray(images)), jimpl)
        _JAX_IMAGE[jimpl] = (np.asarray(img),
                             jax.tree.map(np.asarray, grads["lora"]))
    return _JAX_IMAGE[jimpl]


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_encode_image_matches_jax(weights, impl, jimpl):
    _, _, _, tfrozen, tpeft, tcfg, images, _ = weights
    want, _ = _jax_image(weights, jimpl)
    got = tclip.encode_image(tfrozen, torch.tensor(images), TINY,
                             peft_cfg=tcfg, peft=tpeft,
                             compute_dtype=torch.float32, attn_impl=impl)
    # "unfused": fp32 throughout, summation order only. "fused": both round
    # qkv, p and ctx to bf16 at the same points; a flipped bf16 tie
    # (2**-8 relative) is what the looser bound allows
    tol = 2e-3 if impl == "fused" else 1e-4
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * scale)


def test_encode_image_bf16_matches_jax(weights):
    """The main path's dtype: bf16 operands, fp32 LN/softmax/accumulation."""
    frozen, peft, jcfg, tfrozen, tpeft, tcfg, images, _ = weights
    want = np.asarray(_jax(lambda: jax.jit(
        lambda f, p, im: jclip.encode_image(
            f, im, JTINY, peft_cfg=jcfg, peft=p, compute_dtype=jnp.bfloat16,
            attn_impl="pallas"))(frozen, peft, jnp.asarray(images)), "pallas")
        .astype(jnp.float32))
    got = tclip.encode_image(tfrozen, torch.tensor(images), TINY,
                             peft_cfg=tcfg, peft=tpeft).float()
    # bf16 activations between every op: a flipped rounding anywhere moves
    # the embedding by a few bf16 ulps (2**-8 each) of its scale
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2,
                               atol=3e-2 * scale)


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_encode_text_matches_jax(weights, impl, jimpl):
    frozen, _, _, tfrozen, _, _, _, tokens = weights
    want = np.asarray(_jax(lambda: jax.jit(
        lambda f, tok: jclip.encode_text(f, tok, JTINY,
                                         compute_dtype=jnp.float32,
                                         attn_impl=jimpl))(
            frozen, jnp.asarray(tokens)), jimpl))
    got = tclip.encode_text(tfrozen, torch.tensor(tokens), TINY,
                            compute_dtype=torch.float32, attn_impl=impl)
    tol = 2e-3 if impl == "fused" else 1e-4
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(
        tclip.normalize(got).numpy(), np.asarray(jclip.normalize(want)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_lora_grads_match_jax(weights, impl, jimpl):
    """Grads w.r.t. the LoRA tree with the engine's base_grads=False."""
    _, peft, _, tfrozen, _, tcfg, images, _ = weights
    _, want = _jax_image(weights, jimpl)
    tpeft = params_from_numpy(jax.tree.map(np.asarray, peft))
    for leaf in tpeft["lora"].values():
        leaf.requires_grad_(True)
    img = tclip.encode_image(tfrozen, torch.tensor(images), TINY,
                             peft_cfg=tcfg, peft=tpeft,
                             compute_dtype=torch.float32, attn_impl=impl,
                             base_grads=False)
    (img.float() ** 2).sum().backward()
    # "fused": the backward repeats the kernel's bf16 rounding of dqkv/ds,
    # so 1e-2 of each grad's scale; "unfused": fp32 autograd both sides
    tol = 1e-2 if impl == "fused" else 1e-4
    for k, ref in want.items():
        got = tpeft["lora"][k].grad.numpy()
        assert float(np.abs(ref).max()) > 0, k
        np.testing.assert_allclose(got, ref, rtol=tol,
                                   atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_transformer_with_distinct_kv_prompts_matches_jax(weights, impl,
                                                          jimpl):
    """KV-prefix prompts as a {'k', 'v'} pair of (L, P, D) tensors
    (broadcast over the batch), with ln_1 applied to them, a dead slot in
    layer 0 and every slot dead in the last layer: the output and the grads
    of both prompt tensors."""
    frozen, _, _, tfrozen, *_ = weights
    n_l, d, n_p = JTINY.vision_layers, JTINY.vision_width, 3
    rng = np.random.default_rng(5)
    x, pk, pv = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 5, d), (n_l, n_p, d), (n_l, n_p, d)))
    valid = np.ones((n_l, n_p), bool)
    valid[0, 1] = False
    valid[-1] = False

    def jloss(pk, pv):
        y = jclip.transformer(jnp.asarray(x), frozen["vision"]["blocks"],
                              JTINY.vision_heads,
                              layer_prompts={"k": pk, "v": pv},
                              layer_prompt_valid=jnp.asarray(valid),
                              prompt_ln=True, attn_impl=jimpl)
        return jnp.sum(y ** 2), y

    (_, want), (jdpk, jdpv) = _jax(lambda: jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(pk),
                                              jnp.asarray(pv)), jimpl)
    tpk, tpv = (torch.tensor(a, requires_grad=True) for a in (pk, pv))
    got = tclip.transformer(torch.tensor(x), tfrozen["vision"]["blocks"],
                            TINY.vision_heads,
                            layer_prompts={"k": tpk, "v": tpv},
                            layer_prompt_valid=valid, prompt_ln=True,
                            attn_impl=impl)
    (got ** 2).sum().backward()
    # as the towers above: "fused" rounds at the prefix kernel's bf16 points
    tol_y, tol_g = (2e-3, 1e-2) if impl == "fused" else (1e-4, 1e-4)
    for g, w, tol in ((got.detach(), want, tol_y), (tpk.grad, jdpk, tol_g),
                      (tpv.grad, jdpv, tol_g)):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol * scale)
    assert float(tpk.grad[0, 1].abs().max()) == 0.0
    assert float(tpv.grad[-1].abs().max()) == 0.0
