"""The port's engine (train step, eval step, text features, preprocessing)
against the JAX package's on the same weights and inputs."""

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
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.models.peft import init_tower_peft
from lifelong_clip_tpu.ops import preprocess as jpre
from lifelong_clip_tpu.utils.train_utils import make_optimizer as jmake_opt
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import PEFTConfig
from lifelong_clip_tpu_torch.methods import engine as tengine
from lifelong_clip_tpu_torch.ops import preprocess as tpre
from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer
from test_engine import TINY as JTINY
from test_torch_clip import TINY as TTINY

# one layer a tower: the step, loss, optimizer and pipelines are under test
# here, the towers' loop over layers in test_torch_clip.py. Each layer's
# interpret-mode Pallas kernels compile anew, so this halves the JAX side.
JCFG = dataclasses.replace(JTINY, vision_layers=1, text_layers=1)
TCFG = dataclasses.replace(TTINY, vision_layers=1, text_layers=1)

MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.26, 0.27)
LR = 1e-3
ROUTES = [("fused", "pallas"), ("unfused", "xla")]


@pytest.fixture(scope="module")
def setup():
    frozen = init_clip_params(jax.random.PRNGKey(0), JCFG)
    jcfg = JPEFTConfig(method="lora", encoder="image", lora_r=4)
    peft = {"vision": init_tower_peft(jax.random.PRNGKey(1),
                                      JCFG.vision_layers,
                                      JCFG.vision_width, jcfg),
            "text": None}
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


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_text_features_match_jax(setup, impl, jimpl):
    frozen, peft, jcfg, _, tokens, _, _ = setup
    want = _jax(lambda: jengine.make_text_feature_fn(
        JCFG, jcfg, compute_dtype=jnp.float32, attn_impl=jimpl)(
            frozen, peft, jnp.asarray(tokens)), jimpl)
    got = tengine.make_text_feature_fn(
        TCFG, PEFTConfig(method="lora", lora_r=4),
        compute_dtype=torch.float32, attn_impl=impl)(
            params_from_numpy(_np(frozen)), None, torch.tensor(tokens))
    # normalized features; "fused" rounds qkv/p/ctx to bf16 as the kernel
    tol = 2e-3 if impl == "fused" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_three_train_steps_match_jax(setup, impl, jimpl):
    """augment=False, adamw, CE on probs: per-step loss and the updated
    LoRA tree after 3 steps on one batch, from bridged weights."""
    frozen, peft, jcfg, images, tokens, mask, labels = setup
    txt = jengine.make_text_feature_fn(JCFG, jcfg,
                                       compute_dtype=jnp.float32,
                                       attn_impl="xla")(
        frozen, peft, jnp.asarray(tokens))
    tx = jmake_opt("adamw", LR)
    state = jengine.TrainState.create(trainable=peft, frozen=frozen, tx=tx,
                                      rng=jax.random.PRNGKey(2))
    step = jengine.make_train_step(
        JCFG, jcfg, tx, image_size=32, mean=MEAN, std=STD, augment=False,
        cached_text=True, compute_dtype=jnp.float32, attn_impl=jimpl,
        loss_fn=jengine.ce_on_probs_loss, donate=False)
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels),
             "tokens": txt, "mask": jnp.asarray(mask)}
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
        TCFG, PEFTConfig(method="lora", encoder="image", lora_r=4),
        image_size=32, mean=MEAN, std=STD, augment=False,
        compute_dtype=torch.float32, attn_impl=impl,
        loss_fn=tengine.ce_on_probs_loss, cached_text=True)
    tbatch = {"images": torch.tensor(images),
              "labels": torch.tensor(labels, dtype=torch.int64),
              "tokens": torch.tensor(np.asarray(txt)),
              "mask": torch.tensor(mask)}
    tlosses = [float(tstep(tstate, tbatch)["loss"]) for _ in range(3)]
    assert tstate.step == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    # AdamW moves every weight by ~lr per step whatever its grad's size, so
    # the trees agree to a small fraction of lr; the "fused" road's bf16
    # recompute can flip the sign of a near-zero grad component, which the
    # looser bound for it allows (at most 3 * 2 * lr)
    atol = 6 * LR if impl == "fused" else 1e-3 * LR
    for k, want in state.trainable["vision"]["lora"].items():
        got = tstate.trainable["vision"]["lora"][k].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
        if impl == "fused":   # most entries agree far more tightly
            close = np.abs(got - np.asarray(want)) <= 1e-2 * LR
            assert close.mean() > 0.95, (k, close.mean())


def test_eval_step_matches_jax(setup):
    frozen, peft, jcfg, images, tokens, mask, _ = setup
    txt = jengine.make_text_feature_fn(JCFG, jcfg,
                                       compute_dtype=jnp.float32,
                                       attn_impl="xla")(
        frozen, peft, jnp.asarray(tokens))
    # eval resizes 32 -> 64 then runs the 64-pixel tower: same preset, a
    # larger image_size exercises the resize
    jcfg64 = dataclasses.replace(JCFG, image_size=64)
    tcfg64 = dataclasses.replace(TCFG, image_size=64)
    jfrozen64 = init_clip_params(jax.random.PRNGKey(0), jcfg64)
    preds, logits = jengine.make_eval_step(
        jcfg64, jcfg, image_size=64, mean=MEAN, std=STD,
        compute_dtype=jnp.float32, attn_impl="xla")(
            jfrozen64, peft, jnp.asarray(images), txt, jnp.asarray(mask))
    tp, tl = tengine.make_eval_step(
        tcfg64, PEFTConfig(method="lora", encoder="image", lora_r=4),
        image_size=64, mean=MEAN, std=STD, compute_dtype=torch.float32,
        attn_impl="unfused")(
            params_from_numpy(_np(jfrozen64)), params_from_numpy(_np(peft)),
            torch.tensor(images), torch.tensor(np.asarray(txt)),
            torch.tensor(mask))
    logits = np.asarray(logits)
    finite = np.isfinite(logits)
    np.testing.assert_array_equal(np.isfinite(tl.numpy()), finite)
    # fp32 end to end; logit_scale (~14) amplifies summation-order noise
    np.testing.assert_allclose(tl.numpy()[finite], logits[finite],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(preds))


def test_preprocess_ops_match_jax():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    x = u8.astype(np.float32) / 255.0
    # resize + normalize (the eval pipeline)
    want = jpre.make_eval_pipeline(48, MEAN, STD, out_dtype=jnp.float32)(
        jnp.asarray(u8))
    got = tpre.make_eval_pipeline(48, MEAN, STD, out_dtype=torch.float32)(
        torch.tensor(u8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # crop at the offsets the JAX op draws from its key
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    oy = np.asarray(jax.random.randint(k1, (3,), 0, 9))
    ox = np.asarray(jax.random.randint(k2, (3,), 0, 9))
    want = jpre.resize_pad_random_crop(key, jnp.asarray(x), 48, pad=4)
    got = tpre.resize_pad_crop(torch.tensor(x), 48, torch.tensor(oy),
                               torch.tensor(ox), pad=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # flip at the flags the JAX op draws
    key = jax.random.PRNGKey(6)
    flags = np.asarray(jax.random.bernoulli(key, 0.5, (3,)))
    assert 0 < flags.sum() < 3
    want = jpre.random_hflip(key, jnp.asarray(x))
    got = tpre.hflip(torch.tensor(x), torch.tensor(flags))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the random train pipeline: shape, dtype, normalized range
    out = tpre.make_train_pipeline(48, MEAN, STD)(
        torch.Generator().manual_seed(0), torch.tensor(u8))
    assert out.shape == (3, 48, 48, 3) and out.dtype == torch.bfloat16
    # with AutoAugment (held against JAX in test_torch_autoaugment.py)
    out = tpre.make_train_pipeline(48, MEAN, STD, use_autoaug=True,
                                   autoaug_policy="cifar10")(
        torch.Generator().manual_seed(0), torch.tensor(u8))
    assert out.shape == (3, 48, 48, 3) and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError):
        tpre.make_train_pipeline(48, MEAN, STD, use_autoaug=True,
                                 autoaug_policy="no-such-policy")


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd"])
@pytest.mark.parametrize("sched", ["default", "cos", "exp", "anneal",
                                   "multistep"])
def test_optimizer_and_schedule_match_optax(opt, sched):
    """Three updates of one weight vector by a fixed grad sequence."""
    import optax
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal(5).astype(np.float32)
    grads = rng.standard_normal((3, 5)).astype(np.float32)
    tx = jmake_opt(opt, 0.1, sched_name=sched, total_steps=4)
    params, st = jnp.asarray(w0), None
    st = tx.init(params)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, params)
        params = optax.apply_updates(params, upd)
    w = torch.tensor(w0, requires_grad=True)
    o, s = make_optimizer(opt, [w], 0.1, sched_name=sched, total_steps=4)
    for g in grads:
        w.grad = torch.tensor(g)
        o.step()
        s.step()
    # fp32 in both; the Adam update orders its operations differently
    # (bias corrections folded into the step size in torch), ~1e-5 of the
    # 0.1-sized steps
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                               rtol=1e-5, atol=1e-5)
