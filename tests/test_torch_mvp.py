"""The port's mvp-clip (model, objective, scores, trainer) against the JAX
package's, on the same weights and inputs.

A ``debug-tiny`` tower (6 vision layers): g-prompt layers (0, 1), e-prompt
layers (2, 3, 4) and a layer with no live prefix slot (5) all occur. Weights
come from the JAX init through the bridge, inputs from numpy seeds. The
port's ``"unfused"`` road is held against JAX's ``"xla"`` road in fp32, and
its ``"fused"`` road (the kernel ops' plain versions on the CPU) against
JAX's ``"pallas"`` road with the Pallas kernels in interpret mode.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import CLIP_PRESETS as JPRESETS
from lifelong_clip_tpu.methods import mvp_clip as jmethod
from lifelong_clip_tpu.models import mvp_clip as jmvp
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.ops import attention as jattention
from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import CLIP_PRESETS
from lifelong_clip_tpu_torch.methods import mvp_clip as tmethod
from lifelong_clip_tpu_torch.ops import fused_block_attn as fba

JCFG, TCFG = JPRESETS["debug-tiny"], CLIP_PRESETS["debug-tiny"]
E_POOL, N_CLS, B = 4, 8, 3
MVP_KEYS = ("key", "mask", "g_prompts", "e_prompts")
# (use_mask, use_contrastiv, use_afs, use_gsf, use_last_layer)
NONE = (False, False, False, False, False)
SCRIPT = (True, True, False, False, False)      # scripts/mvp_clip.sh
ALL = (True, True, True, True, True)
ALL_SHALLOW = (True, True, True, True, False)


@functools.lru_cache(maxsize=None)
def _setup():
    frozen = init_clip_params(jax.random.PRNGKey(0), JCFG)
    mvp = jmvp.init_mvp_params(jax.random.PRNGKey(1), JCFG, e_pool=E_POOL,
                               num_classes=N_CLS)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    batch = {"labels": np.array([0, 3, 1], np.int64),
             "txt": rng.standard_normal((6, JCFG.embed_dim)).astype(
                 np.float32),
             "mask": np.array([0, 0, 0, 0, 0, -np.inf], np.float32),
             "slot_globals": np.array([2, 5, 0, 7, 1, -1], np.int64)}
    count = np.array([3.0, 0.0, 1.0, 5.0], np.float32)
    return (jax.tree.map(np.asarray, frozen), jax.tree.map(np.asarray, mvp),
            images, batch, count)


def _flags(flags):
    keys = ("use_mask", "use_contrastiv", "use_afs", "use_gsf",
            "use_last_layer")
    return dict(zip(keys, flags))


def _jax_objective(flags, jimpl):
    """JAX's train objective (``methods/mvp_clip.py:160-198``) on given
    text features: loss, img, cls_mask, similarity loss, new count, idx
    and the grads w.r.t. the mvp tree."""
    f = _flags(flags)
    frozen, mvp, images, batch, count = _setup()

    def objective(mvp, frozen, images, count, txt):
        scale = jnp.exp(frozen["logit_scale"]).astype(jnp.float32)
        labels = jnp.asarray(batch["labels"], jnp.int32)
        mask = jnp.asarray(batch["mask"])
        img, cls_full, sim, new_count, idx = jmvp.mvp_features(
            frozen, mvp, count, images, JCFG,
            use_contrastiv=f["use_contrastiv"],
            use_last_layer=f["use_last_layer"], train=True,
            compute_dtype=jnp.float32)
        cls_mask = cls_full[:, jnp.clip(jnp.asarray(batch["slot_globals"]),
                                         0, None)]
        ign, cps = jmethod.mvp_scores(
            jax.lax.stop_gradient(img), txt, labels,
            jax.lax.stop_gradient(cls_mask), mask, scale, f["use_mask"],
            0.5)
        img_used = img / cps[:, None] if f["use_afs"] else img
        logits = jmvp.mvp_head(frozen, img_used, txt,
                               cls_mask=cls_mask if f["use_mask"] else None,
                               class_mask=mask, use_mask=f["use_mask"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        if f["use_gsf"]:
            loss = 0.5 * loss + 0.5 * jnp.mean(ign ** 2.0) * loss
        return loss + sim, (img, cls_full, sim, new_count, idx)

    def run():
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            objective, has_aux=True))(mvp, frozen, jnp.asarray(images),
                                      jnp.asarray(count),
                                      jnp.asarray(batch["txt"]))
        return (float(loss),) + tuple(np.asarray(a) for a in aux), \
            jax.tree.map(np.asarray, grads)

    if jimpl == "xla":
        return run()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(jattention, "_DEFAULT_IMPL", "pallas")
        return run()


_JAX_CACHE = {}


def _jax_ref(flags, jimpl):
    """One jitted JAX run per (flags, road): interpret mode compiles the
    Pallas kernels anew in each."""
    if (flags, jimpl) not in _JAX_CACHE:
        _JAX_CACHE[flags, jimpl] = _jax_objective(flags, jimpl)
    return _JAX_CACHE[flags, jimpl]


def _torch_objective(flags, impl):
    frozen, mvp, images, batch, count = _setup()
    tmvp = params_from_numpy(mvp)
    for leaf in tmvp.values():
        leaf.requires_grad_(True)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _, new_count = tmethod.mvp_objective(
        params_from_numpy(frozen), tmvp, torch.tensor(count),
        torch.tensor(images), tbatch, TCFG, compute_dtype=torch.float32,
        attn_impl=impl, **_flags(flags))
    loss.backward()
    # a leaf the loss does not reach (the class mask without use_mask) has
    # no grad; JAX's is zeros
    return float(loss.detach()), new_count, {
        k: torch.zeros_like(v) if v.grad is None else v.grad
        for k, v in tmvp.items()}


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale)


@pytest.mark.parametrize("impl,jimpl,flags", [
    ("unfused", "xla", NONE), ("unfused", "xla", SCRIPT),
    ("unfused", "xla", ALL), ("fused", "pallas", ALL_SHALLOW)])
def test_mvp_features_match_jax(impl, jimpl, flags):
    """img, per-sample class mask, similarity loss, new count and idx."""
    (_, jimg, jcls, jsim, jcount, jidx), _ = _jax_ref(flags, jimpl)
    frozen, mvp, images, _, count = _setup()
    img, cls_mask, sim, new_count, idx = tmethod.mvp_features(
        params_from_numpy(frozen), params_from_numpy(mvp),
        torch.tensor(count), torch.tensor(images), TCFG,
        use_contrastiv=_flags(flags)["use_contrastiv"],
        use_last_layer=_flags(flags)["use_last_layer"], train=True,
        compute_dtype=torch.float32, attn_impl=impl)
    # "unfused": fp32 both sides, summation order only; "fused": both round
    # h, q/k/v, p and ctx to bf16 at the same points
    tol = 1e-4 if impl == "unfused" else 2e-3
    _close(img.detach().numpy(), jimg, tol)
    _close(cls_mask.detach().numpy(), jcls, 1e-6)
    _close(float(sim), jsim, tol)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(new_count.numpy(), jcount)
    assert float(new_count.sum() - count.sum()) == B


@pytest.mark.parametrize("impl,jimpl,flags", [
    ("unfused", "xla", NONE), ("unfused", "xla", SCRIPT),
    ("unfused", "xla", ALL), ("fused", "pallas", ALL_SHALLOW)])
def test_objective_and_grads_match_jax(impl, jimpl, flags):
    """The loss and its grads w.r.t. every leaf of the mvp tree."""
    (jloss, *_), jgrads = _jax_ref(flags, jimpl)
    loss, _, grads = _torch_objective(flags, impl)
    # "fused": the backward repeats the prefix kernel's bf16 roundings
    tol = (1e-4, 1e-4) if impl == "unfused" else (2e-3, 1e-2)
    _close(loss, jloss, tol[0])
    for k in MVP_KEYS:
        want = jgrads[k]
        if k != "mask" or flags[0]:   # the class mask reaches the loss
            assert float(np.abs(want).max()) > 0, k
        _close(grads[k].numpy(), want, tol[1])


def test_prompted_pass_runs_the_prefix_op_on_every_layer(monkeypatch):
    """On the fused road the prompted pass calls the prefix op once a layer
    (layer 5's slots all dead), the query pass the plain block op."""
    calls = []
    orig = fba.fused_prefix_attention_block

    def counted(x, pk, pv, *a):
        calls.append(tuple(pk.shape))
        return orig(x, pk, pv, *a)

    from lifelong_clip_tpu_torch.models import clip as tclip
    monkeypatch.setattr(tclip, "fused_prefix_attention_block", counted)
    _torch_objective(SCRIPT, "fused")
    assert calls == [(B, 20, TCFG.vision_width)] * TCFG.vision_layers


@pytest.mark.parametrize("use_mask", [True, False])
def test_mvp_scores_match_jax(use_mask):
    rng = np.random.default_rng(4)
    img = rng.standard_normal((5, 16)).astype(np.float32)
    txt = rng.standard_normal((6, 16)).astype(np.float32)
    y = np.array([0, 1, 2, 1, 4])
    cls_mask = rng.uniform(0.2, 1.8, (5, 6)).astype(np.float32)
    class_mask = np.array([0, 0, 0, 0, 0, -np.inf], np.float32)
    want = jmethod.mvp_scores(jnp.asarray(img), jnp.asarray(txt),
                              jnp.asarray(y, jnp.int32),
                              jnp.asarray(cls_mask), jnp.asarray(class_mask),
                              jnp.asarray(14.0), use_mask, 0.5)
    got = tmethod.mvp_scores(torch.tensor(img), torch.tensor(txt),
                             torch.tensor(y), torch.tensor(cls_mask),
                             torch.tensor(class_mask), torch.tensor(14.0),
                             use_mask, 0.5)
    for g, w in zip(got, want):   # closed form vs vmap(grad), fp32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_bridge_carries_the_mvp_tree():
    _, mvp, *_ = _setup()
    tmvp = params_from_numpy(mvp)
    for k in MVP_KEYS:
        assert tmvp[k].dtype == torch.float32
        np.testing.assert_array_equal(tmvp[k].numpy(), mvp[k])


def test_attr_flags_reach_the_trainer_and_defaults_do_not_override(
        monkeypatch):
    parser = cli.base_parser()
    cls = cli.trainer_class("mvp-clip",
                            parser.parse_args(["--use_mask", "--gamma", "3"]),
                            parser)
    assert cls.use_mask is True and cls.gamma == 3.0
    assert cls.use_contrastiv is False and "margin" not in cls.__dict__
    # a flag left at its default keeps the class's own value
    monkeypatch.setattr(tmethod.CLIP_MVP, "use_contrastiv", True)
    cls = cli.trainer_class("mvp-clip", parser.parse_args([]), parser)
    assert cls is tmethod.CLIP_MVP and cls.use_contrastiv is True


def test_cli_cpu_mvp_clip_run_writes_result(tmp_path, monkeypatch):
    seen = {}
    orig = tmethod.CLIP_MVP.setup_model

    def spy(self):
        orig(self)
        seen["flags"] = (self.use_mask, self.use_contrastiv, self.use_afs)
        seen["trainer"] = self

    monkeypatch.setattr(tmethod.CLIP_MVP, "setup_model", spy)
    out = cli.main(["--method", "mvp-clip", "--model_name", "debug-tiny",
                    "--dataset", "synthetic-10x8", "--n_tasks", "2",
                    "--batchsize", "8", "--test_batchsize", "8",
                    "--eval_period", "32", "--device", "cpu", "--transforms",
                    "--use_mask", "--use_contrastiv", "--log_path",
                    str(tmp_path)])
    assert set(out) == {"A_auc", "A_avg", "A_last", "F_last"}
    assert seen["flags"] == (True, True, False)
    count = seen["trainer"].count
    assert count.device.type == "cpu" and float(count.sum()) > 0
    found = [os.path.join(d, "result.txt") for d, _, fs in os.walk(tmp_path)
             if "result.txt" in fs]
    assert len(found) == 1


def test_a_leaf_the_loss_does_not_reach_updates_as_optax():
    """Without ``use_mask`` the class mask gets no grad. optax updates it
    with a zero grad (AdamW: its decoupled weight decay still applies);
    torch's optimizers skip a leaf whose grad is None, so the step gives it
    a zero grad. The mask after one AdamW step equals optax's."""
    from lifelong_clip_tpu_torch.methods.engine import TrainState
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer
    frozen, mvp, images, batch, count = _setup()
    lr = 1e-2
    state = TrainState(
        trainable=params_from_numpy(mvp), frozen=params_from_numpy(frozen),
        make_opt=lambda lv: make_optimizer("adamw", lv, lr),
        gen=torch.Generator().manual_seed(0))
    step = tmethod.make_mvp_train_step(
        TCFG, image_size=32, mean=(0.5,) * 3, std=(0.25,) * 3,
        compute_dtype=torch.float32, attn_impl="unfused", use_mask=False)
    u8 = np.random.default_rng(1).integers(0, 256, (B, 32, 32, 3),
                                           dtype=np.uint8)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    step(state, dict(tbatch, images=torch.tensor(u8)), torch.tensor(count))
    tx = optax.adamw(lr, weight_decay=1e-5)
    mask = jnp.asarray(mvp["mask"])
    upd, _ = tx.update(jnp.zeros_like(mask), tx.init(mask), mask)
    want = np.asarray(optax.apply_updates(mask, upd))
    assert not np.array_equal(want, mvp["mask"])
    np.testing.assert_allclose(state.trainable["mask"].detach().numpy(), want,
                               rtol=1e-7, atol=0)
