"""LoRA on both towers (``--peft_encoder both``): ``clip_forward`` and the
lora-clip train step whose text tower runs forward and backward every step,
against the JAX package's on the same weights and inputs; and the text
tower's remat."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import PEFTConfig as JPEFTConfig
from lifelong_clip_tpu.methods import engine as jengine
from lifelong_clip_tpu.models import clip as jclip
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.models.peft import init_tower_peft
from lifelong_clip_tpu.utils.train_utils import make_optimizer as jmake_opt
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import PEFTConfig
from lifelong_clip_tpu_torch.methods import engine as tengine
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer
from test_engine import TINY as JTINY
from test_torch_clip import TINY as TTINY

# one layer a tower, as tests/test_torch_engine.py: each layer's
# interpret-mode Pallas kernels compile anew on the JAX side
JCFG = dataclasses.replace(JTINY, vision_layers=1, text_layers=1)
TCFG = dataclasses.replace(TTINY, vision_layers=1, text_layers=1)
MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.26, 0.27)
LR = 1e-3
ROUTES = [("fused", "pallas"), ("unfused", "xla")]


@pytest.fixture(scope="module")
def setup():
    frozen = init_clip_params(jax.random.PRNGKey(0), JCFG)
    jcfg = JPEFTConfig(method="lora", encoder="both", lora_r=4)
    peft = {"vision": init_tower_peft(jax.random.PRNGKey(1),
                                      JCFG.vision_layers, JCFG.vision_width,
                                      jcfg),
            "text": init_tower_peft(jax.random.PRNGKey(2), JCFG.text_layers,
                                    JCFG.text_width, jcfg)}
    # B_in starts at random (xavier) and B_out at 0: give B_out a value so
    # both LoRA terms move the forward
    for tower in ("vision", "text"):
        lora = peft[tower]["lora"]
        lora["b_out"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(3), lora["b_out"].shape)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    tokens = np.zeros((6, JCFG.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:5] = rng.integers(1000, 40000, (6, 4))
    tokens[:, 5] = 49407
    mask = np.zeros(6, np.float32)
    mask[5] = -np.inf     # one padded class slot
    labels = np.array([0, 3, 1, 4], np.int32)
    return frozen, peft, jcfg, images, tokens, mask, labels


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(fn, impl):
    if impl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return fn()
    return fn()


def _tpeft():
    return PEFTConfig(method="lora", encoder="both", lora_r=4)


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_clip_forward_matches_jax(setup, impl, jimpl):
    """Logits and both normalized feature sets, LoRA on both towers."""
    frozen, peft, jcfg, images, tokens, _, _ = setup
    x = (images.astype(np.float32) / 255.0 - 0.5) / 0.25
    want = _jax(lambda: jclip.clip_forward(
        frozen, jnp.asarray(x), jnp.asarray(tokens), JCFG, peft_cfg=jcfg,
        peft_vision=peft["vision"], peft_text=peft["text"],
        compute_dtype=jnp.float32, attn_impl=jimpl), jimpl)
    got = tclip.clip_forward(
        params_from_numpy(_np(frozen)), torch.tensor(x), torch.tensor(tokens),
        TCFG, peft_cfg=_tpeft(),
        peft_vision=params_from_numpy(_np(peft["vision"])),
        peft_text=params_from_numpy(_np(peft["text"])),
        compute_dtype=torch.float32, attn_impl=impl)
    # fp32 on both roads (the fused one rounds where JAX's interpret-mode
    # kernel does); the logits carry the logit scale (~14)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_three_both_tower_steps_match_jax(setup, impl, jimpl):
    """``make_train_step`` with ``cached_text=False`` (``peft_forward``):
    augment=False, AdamW, CE on probs; per-step loss and both towers'
    updated LoRA leaves after 3 steps on one batch, from bridged weights.
    AdamW moves every weight by ~lr a step whatever its grad's size, so the
    trees agree to a small fraction of lr; on the "fused" road bf16
    rounding can flip the sign of a near-zero grad component, which its
    looser bound allows (at most 3 * 2 * lr), with most entries far
    tighter."""
    frozen, peft, jcfg, images, tokens, mask, labels = setup
    tx = jmake_opt("adamw", LR)
    state = jengine.TrainState.create(trainable=peft, frozen=frozen, tx=tx,
                                      rng=jax.random.PRNGKey(4))
    step = jengine.make_train_step(
        JCFG, jcfg, tx, image_size=32, mean=MEAN, std=STD, augment=False,
        cached_text=False, compute_dtype=jnp.float32, attn_impl=jimpl,
        loss_fn=jengine.ce_on_probs_loss, donate=False)
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels),
             "tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
    jlosses = []
    for _ in range(3):
        state, m = _jax(lambda: step(state, batch), jimpl)
        jlosses.append(float(m["loss"]))

    tstate = tengine.TrainState(
        trainable=params_from_numpy(_np(peft)),
        frozen=params_from_numpy(_np(frozen)),
        make_opt=lambda leaves: make_optimizer("adamw", leaves, LR),
        gen=torch.Generator().manual_seed(0))
    tstep = tengine.make_train_step(
        TCFG, _tpeft(), image_size=32, mean=MEAN, std=STD, augment=False,
        compute_dtype=torch.float32, attn_impl=impl,
        loss_fn=tengine.ce_on_probs_loss)
    tbatch = {"images": torch.tensor(images),
              "labels": torch.tensor(labels, dtype=torch.int64),
              "tokens": torch.tensor(tokens, dtype=torch.int64),
              "mask": torch.tensor(mask)}
    tlosses = [float(tstep(tstate, tbatch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    atol = 6 * LR if impl == "fused" else 1e-3 * LR
    for tower in ("vision", "text"):
        for k, want in state.trainable[tower]["lora"].items():
            got = tstate.trainable[tower]["lora"][k].detach().numpy()
            want = np.asarray(want)
            assert not np.array_equal(want, np.asarray(
                peft[tower]["lora"][k])), (tower, k)
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=f"{tower} {k}")
            if impl == "fused":
                close = np.abs(got - want) <= 1e-2 * LR
                assert close.mean() > 0.95, (tower, k, close.mean())


def test_encode_text_remat_is_bitwise_the_plain_forward(setup):
    """``encode_text(remat=True)`` checkpoints each text block: the same
    features and LoRA grads bit for bit."""
    frozen, peft, _, _, tokens, _, _ = setup
    tfrozen = params_from_numpy(_np(frozen))
    out = {}
    for remat in (False, True):
        lora = params_from_numpy(_np(peft["text"]))
        leaves = tengine.tree_leaves(lora)
        for p in leaves:
            p.requires_grad_(True)
        feats = tclip.encode_text(tfrozen, torch.tensor(tokens), TCFG,
                                  peft_cfg=_tpeft(), peft=lora,
                                  compute_dtype=torch.float32,
                                  base_grads=False, remat=remat)
        grads = torch.autograd.grad((feats * feats.detach()).sum(), leaves)
        out[remat] = (feats.detach(), grads)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
