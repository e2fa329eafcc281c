"""Prompted LoRA blocks, and blocks whose mask the fused kernel op cannot
take, against the JAX package: both send them down the general road (LN,
then multi-head attention on the flash-attention op), JAX with its Pallas
flash kernels in interpret mode, the port with the op's plain versions.

Weights come from the JAX init through the bridge, inputs from numpy seeds.
Everything runs in fp32 but one bf16 case: the two sides differ in
summation order only (fp32 tolerance 1e-4 of each output's scale, as the
towers' unfused road in ``test_torch_clip.py``).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import functools

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
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import PEFTConfig
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.ops import flash_attention as tfa
from test_engine import TINY as JTINY
from test_torch_clip import TINY

N_P = 3   # prompt slots a layer


@functools.lru_cache(maxsize=None)
def _setup():
    frozen = init_clip_params(jax.random.PRNGKey(0), JTINY)
    jcfg = JPEFTConfig(method="lora", encoder="image", lora_r=4,
                       lora_alpha=16)
    peft = init_tower_peft(jax.random.PRNGKey(1), JTINY.vision_layers,
                           JTINY.vision_width, jcfg)
    # out-proj LoRA B inits to zeros: perturb it so a_out's grad is not zero
    peft["lora"]["b_out"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(3), peft["lora"]["b_out"].shape)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    prompts = rng.standard_normal(
        (JTINY.vision_layers, N_P, JTINY.vision_width)).astype(np.float32)
    return (jax.tree.map(np.asarray, frozen), jax.tree.map(np.asarray, peft),
            jcfg, images, prompts)


def _tcfg():
    return PEFTConfig(method="lora", encoder="image", lora_r=4, lora_alpha=16)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _count_flash(monkeypatch):
    calls = []
    orig = tfa.flash_attention

    def spy(q, k, v, n_heads, mask=None):
        calls.append((tuple(q.shape), tuple(k.shape),
                      None if mask is None else tuple(mask.shape)))
        return orig(q, k, v, n_heads, mask)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    return calls


_JAX = {}


def _jax_encode(dtype):
    """JAX ``encode_image`` with LoRA and per-layer raw KV prompts on its
    "pallas" road (the flash kernels), and its grads w.r.t. the LoRA tree
    and the prompts; one jitted interpret-mode run per dtype."""
    if dtype not in _JAX:
        frozen, peft, jcfg, images, prompts = _setup()
        jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16

        def loss(p, lp):
            img = jclip.encode_image(frozen, jnp.asarray(images), JTINY,
                                     peft_cfg=jcfg, peft=p, layer_prompts=lp,
                                     compute_dtype=jdt, attn_impl="pallas",
                                     base_grads=False)
            return jnp.sum(img.astype(jnp.float32) ** 2), img

        with pltpu.force_tpu_interpret_mode():
            (_, img), (gp, glp) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(peft, jnp.asarray(prompts))
        _JAX[dtype] = (np.asarray(img.astype(jnp.float32)),
                       jax.tree.map(np.asarray, gp["lora"]), np.asarray(glp))
    return _JAX[dtype]


def test_prompted_lora_encode_image_matches_jax(monkeypatch):
    """The embedding and the grads of every LoRA leaf and of the prompts;
    every layer runs the flash op over S = P + T keys."""
    frozen, peft, _, images, prompts = _setup()
    want_img, want_lora, want_lp = _jax_encode("f32")
    calls = _count_flash(monkeypatch)
    tpeft = params_from_numpy(peft)
    for leaf in tpeft["lora"].values():
        leaf.requires_grad_(True)
    lp = torch.tensor(prompts, requires_grad=True)
    img = tclip.encode_image(params_from_numpy(frozen), torch.tensor(images),
                             TINY, peft_cfg=_tcfg(), peft=tpeft,
                             layer_prompts=lp, compute_dtype=torch.float32,
                             base_grads=False)
    (img.float() ** 2).sum().backward()
    t = 1 + (32 // TINY.patch_size) ** 2
    assert calls == [((2, t, TINY.vision_width),
                      (2, N_P + t, TINY.vision_width), None)] \
        * TINY.vision_layers
    _close(img.detach(), want_img, 1e-4)
    for k, want in want_lora.items():
        _close(tpeft["lora"][k].grad, want, 1e-4)
    _close(lp.grad, want_lp, 1e-4)


def test_prompted_lora_encode_image_bf16_matches_jax():
    """The main path's dtype: bf16 operands, fp32 attention and LoRA terms.
    A flipped bf16 rounding anywhere moves the embedding by a few bf16 ulps
    (2**-8 each) of its scale, as in ``test_torch_clip.py``."""
    frozen, peft, _, images, prompts = _setup()
    want_img, _, _ = _jax_encode("bf16")
    img = tclip.encode_image(params_from_numpy(frozen), torch.tensor(images),
                             TINY, peft_cfg=_tcfg(),
                             peft=params_from_numpy(peft),
                             layer_prompts=torch.tensor(prompts))
    assert img.dtype == torch.bfloat16
    _close(img.float(), want_img, 3e-2)


def test_transformer_prompted_lora_with_valid_slots_matches_jax(monkeypatch):
    """``transformer`` with LoRA, prompts and ``layer_prompt_valid`` (a dead
    slot in layer 0, every slot dead in the last layer): the (1, 1, P + T)
    key-mask row reaches the flash op; output and grads of the prompts and
    of the LoRA tree; dead slots get exactly zero grad."""
    frozen, peft, jcfg, _, prompts = _setup()
    n_l, d = JTINY.vision_layers, JTINY.vision_width
    x = np.random.default_rng(5).standard_normal((2, 5, d)).astype(
        np.float32)
    valid = np.ones((n_l, N_P), bool)
    valid[0, 1] = False
    valid[-1] = False

    def jloss(p, lp):
        y = jclip.transformer(jnp.asarray(x), frozen["vision"]["blocks"],
                              JTINY.vision_heads, peft_cfg=jcfg, peft=p,
                              layer_prompts=lp,
                              layer_prompt_valid=jnp.asarray(valid),
                              attn_impl="pallas")
        return jnp.sum(y ** 2), y

    with pltpu.force_tpu_interpret_mode():
        (_, want), (gp, glp) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(peft, jnp.asarray(prompts))
    calls = _count_flash(monkeypatch)
    tpeft = params_from_numpy(peft)
    for leaf in tpeft["lora"].values():
        leaf.requires_grad_(True)
    lp = torch.tensor(prompts, requires_grad=True)
    y = tclip.transformer(torch.tensor(x),
                          params_from_numpy(frozen)["vision"]["blocks"],
                          TINY.vision_heads, peft_cfg=_tcfg(), peft=tpeft,
                          layer_prompts=lp, layer_prompt_valid=valid)
    (y ** 2).sum().backward()
    assert [c[2] for c in calls] == [(1, 1, N_P + 5)] * n_l
    _close(y.detach(), want, 1e-4)
    _close(lp.grad, glp, 1e-4)
    for k in tpeft["lora"]:
        _close(tpeft["lora"][k].grad, gp["lora"][k], 1e-4)
    assert float(lp.grad[0, 1].abs().max()) == 0.0
    assert float(lp.grad[-1].abs().max()) == 0.0


@pytest.mark.parametrize("shape", [(1, 1, 5), (2, 1, 1, 5)])
def test_non_square_mask_takes_the_general_road(monkeypatch, shape):
    """No prompts and a mask that is not a <= 2-D mask over T keys: JAX
    sends the block to the general road (``models/clip.py:131-134``), so
    does the port. A (1, 1, T) key row runs the flash op; a mask that
    depends on the batch runs the plain attention in both."""
    frozen, *_ = _setup()
    d = JTINY.vision_width
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    mask = np.zeros(shape, np.float32)
    mask[..., 1] = -np.inf
    if len(shape) == 4:
        mask[1, ..., 3] = -np.inf   # a second dead key in batch row 1 only

    def jfwd(x):
        return jclip.transformer(x, frozen["vision"]["blocks"],
                                 JTINY.vision_heads, mask=jnp.asarray(mask),
                                 attn_impl="pallas")

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jfwd)(jnp.asarray(x))
    calls = _count_flash(monkeypatch)
    fused = []
    orig = tclip.fused_ln_attention_block
    monkeypatch.setattr(tclip, "fused_ln_attention_block",
                        lambda *a: fused.append(1) or orig(*a))
    got = tclip.transformer(torch.tensor(x),
                            params_from_numpy(frozen)["vision"]["blocks"],
                            TINY.vision_heads, mask=torch.tensor(mask))
    assert not fused
    assert len(calls) == (JTINY.vision_layers if len(shape) == 3 else 0)
    _close(got, want, 1e-4)
