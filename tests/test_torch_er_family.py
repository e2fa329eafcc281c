"""The port's ER family (``methods/{er_baseline,lwf,ewcpp,clib,
rainbow_memory}.py`` and the engine's CutMix) against the JAX package's, on
the same weights and inputs.

The classifier's two halves (``head_features`` / ``head_forward``) run on a
two-block tower (``tests/test_engine.py``'s TINY), FT's whole-tower grads
included: the port's ``"unfused"`` road against JAX's ``"xla"`` in fp32, its
``"fused"`` road (the kernel ops' plain versions on the CPU) against JAX's
``"pallas"`` road with the Pallas kernels in interpret mode. One step of each
of the six trainers runs on ``debug-tiny`` against the JAX trainer's jitted
step, both augmentations replaced by the eval preprocessing (the packages
draw differently). Host-side machinery (CLIB's adaptive LR, RM's memory
epochs and schedule) runs on both packages' code with the same inputs.
Each JAX reference is jitted once and shared.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import CLIPConfig as JCLIPConfig
from lifelong_clip_tpu.config import StreamConfig as JStream
from lifelong_clip_tpu.config import TrainConfig as JTrainConfig
from lifelong_clip_tpu.data.registry import make_synthetic as jsynthetic
from lifelong_clip_tpu.methods import clib as jclib
from lifelong_clip_tpu.methods import er_baseline as jer
from lifelong_clip_tpu.methods import ewcpp as jewc
from lifelong_clip_tpu.methods import lwf as jlwf
from lifelong_clip_tpu.methods import rainbow_memory as jrm
from lifelong_clip_tpu.models.init import init_clip_params as jinit
from lifelong_clip_tpu.ops import attention as jattention
from lifelong_clip_tpu.ops import preprocess as jpre
from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import CLIPConfig, StreamConfig
from lifelong_clip_tpu_torch.config import TrainConfig
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods import clib as tclib
from lifelong_clip_tpu_torch.methods import engine as tengine
from lifelong_clip_tpu_torch.methods import er_baseline as ter
from lifelong_clip_tpu_torch.methods import get_method
from lifelong_clip_tpu_torch.methods import rainbow_memory as trm
from lifelong_clip_tpu_torch.methods.engine import tree_leaves, tree_map
from lifelong_clip_tpu_torch.models.clip import cast_towers
from lifelong_clip_tpu_torch.ops import preprocess as tpre
from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

TINY = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=64,
            vision_layers=2, vision_heads=4, context_length=77,
            vocab_size=49408, text_width=64, text_heads=4, text_layers=2)
JTINY, TTINY = JCLIPConfig(**TINY), CLIPConfig(**TINY)
B, N_CLS = 4, 8
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
LR = 1e-3
JAX_CLASSES = {"er": jer.ER, "Finetuning": jer.FT, "lwf": jlwf.LwF,
               "ewc++": jewc.EWCpp, "clib": jclib.CLIB, "rm": jrm.RM}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny towers gain nothing from intra-op threads, and under the
    suite's parallel workers those threads oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, path=()):
    """{key path: leaf} of a nested dict, whatever its key order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _jax_road(fn, jimpl):
    if jimpl == "xla":
        return fn()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(jattention, "_DEFAULT_IMPL", "pallas")
        return fn()


# ---------------------------------------------------------------------------
# the classifier's halves, FT's whole-tower grads
# ---------------------------------------------------------------------------

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (port road, JAX road, compute dtype): fp32 on the plain roads; the fused
# road (whose kernels take bf16 operands whatever the tower's dtype) at the
# main path's dtype
ROADS = [("unfused", "xla", "float32"), ("fused", "pallas", "bfloat16")]


@functools.lru_cache(maxsize=None)
def _head_setup():
    """The TINY CLIP tree from JAX's init, a random head (so the tower's
    grads are not zero), images and the loss weights, numpy."""
    params = _np(jinit(jax.random.PRNGKey(0), JTINY))
    rng = np.random.default_rng(1)
    head = {"w": (0.3 * rng.standard_normal((64, N_CLS))).astype(np.float32),
            "b": (0.3 * rng.standard_normal(N_CLS)).astype(np.float32)}
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((B, N_CLS)).astype(np.float32)
    return params, head, images, w


_JAX_CACHE = {}


def _jax_head(dtype, jimpl):
    """JAX's FT classifier forward: logits, boundary features and the grads
    of sum(logits * w) w.r.t. the head and the whole CLIP tree."""
    k = (dtype, jimpl)
    if k not in _JAX_CACHE:
        params, head, images, w = _head_setup()

        def loss(trainable, images, w):
            logits, img, _ = jer.head_forward(
                {}, trainable, images, None, clip_cfg=JTINY,
                compute_dtype=_DT[dtype][0])
            return jnp.sum(logits * w), (logits, img)

        (_, aux), grads = _jax_road(lambda: jax.jit(jax.value_and_grad(
            loss, has_aux=True))({"head": head, "backbone": params},
                                 jnp.asarray(images), jnp.asarray(w)), jimpl)
        _JAX_CACHE[k] = tuple(np.asarray(a, np.float32) for a in aux), \
            _np(grads)
    return _JAX_CACHE[k]


@pytest.mark.parametrize("impl,jimpl,dtype", ROADS)
def test_head_forward_and_ft_grads_match_jax(impl, jimpl, dtype):
    """``head_forward`` with FT's trainable tree (``base_grads=True``: the
    fused road's backward computes every block weight's grad): the logits,
    the fp32 boundary features and the grad of every leaf, the text tower's
    zeros (no grad reaches it) included. fp32: summation order only (1e-4
    of each term's max); bf16: the fused kernels' bf16 roundings through two
    blocks and their weight grads (3e-2 of each term's max, as
    ``tests/test_torch_vit_prompt.py``'s bf16 towers)."""
    (jl, jimg), jgrads = _jax_head(dtype, jimpl)
    params, head, images, w = _head_setup()
    tree = params_from_numpy({"head": head, "backbone": params})
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    logits, img, _ = ter.head_forward(
        {}, tree, torch.tensor(images), None, clip_cfg=TTINY,
        compute_dtype=_DT[dtype][1], attn_impl=impl)
    (logits * torch.tensor(w)).sum().backward()
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert logits.dtype == img.dtype == torch.float32
    for got, want in ((logits, jl), (img, jimg)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                                   atol=tol * float(np.abs(want).max()))
    got = _flat(tree)
    n_text = 0
    for key, ref in _flat(jgrads).items():
        g = got[key].grad
        if key[:2] == ("backbone", "text") or key[-1] == "logit_scale":
            assert not np.any(ref) and g is None, key
            n_text += 1
            continue
        scale = float(np.abs(ref).max())
        assert scale > 0, key
        np.testing.assert_allclose(g.numpy(), ref, rtol=tol,
                                   atol=tol * scale, err_msg=str(key))
    assert n_text == len(tree_leaves(tree["backbone"]["text"])) + 1


def test_frozen_head_features_run_no_backward():
    """ER's tower is frozen: ``head_forward`` with a head-only tree leaves
    the tower out of the graph (grads on the head only)."""
    params, head, images, w = _head_setup()
    frozen = params_from_numpy(params)
    tree = params_from_numpy({"head": head})
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    logits, img, _ = ter.head_forward(frozen, tree, torch.tensor(images),
                                      None, clip_cfg=TTINY,
                                      compute_dtype=torch.float32,
                                      attn_impl="unfused")
    assert not img.requires_grad and logits.requires_grad
    (jl, _), _ = _jax_head("float32", "xla")
    np.testing.assert_allclose(logits.detach().numpy(), jl, rtol=1e-4,
                               atol=1e-4 * float(np.abs(jl).max()))


# ---------------------------------------------------------------------------
# one step of each trainer against JAX's
# ---------------------------------------------------------------------------

def _eval_like_jax(rng, images_u8):
    """JAX's train pipeline replaced by its eval preprocessing: the step
    tests hold the trainers, not the augmentation draws."""
    x = images_u8.astype(jnp.float32) / 255.0
    x = jpre.resize_bilinear(x, 32)
    return jpre.normalize(x, MEAN, STD).astype(jnp.float32)


def _trainers(method, tmp_path, monkeypatch, lr=LR, train_backbone=False,
              **cfg_kw):
    """The JAX trainer and the port's on ``debug-tiny`` (fp32, the train
    pipelines replaced by eval preprocessing, the port on ``"unfused"``),
    the port's weights and trainable tree set to JAX's with a random head,
    the optimizers fresh. Returns (JAX trainer, port trainer, the starting
    trainable tree as numpy)."""
    train = jsynthetic(n_classes=N_CLS, per_class=4, image_size=32, seed=0)
    train.mean, train.std = MEAN, STD
    jcfg = JTrainConfig(
        method=method, dataset="synthetic-8", model_name="debug-tiny",
        batchsize=B, test_batchsize=B, online_iter=1, lr=lr,
        opt_name="adamw", memory_size=0, transforms=(), use_bf16=False,
        stream=JStream(n_tasks=2, n=50, m=10, seed=1),
        log_path=str(tmp_path / "jax"), seed=1, **cfg_kw)
    eval_pipe = tpre.make_eval_pipeline(32, MEAN, STD,
                                        out_dtype=torch.float32)
    monkeypatch.setattr(jpre, "make_train_pipeline",
                        lambda *a, **kw: _eval_like_jax)
    monkeypatch.setattr(tpre, "make_train_pipeline",
                        lambda *a, **kw: lambda gen, x: eval_pipe(x))
    jcls, tcls = JAX_CLASSES[method], get_method(method)
    flags = {"train_backbone": True} if train_backbone else {}
    jcls = type(jcls.__name__, (jcls,), flags)
    tcls = type(tcls.__name__, (tcls,), {"attn_impl": "unfused", **flags})
    jtr = jcls(jcfg, train_dataset=train, test_dataset=train)
    tcfg = TrainConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name not in ("stream", "peft", "log_path")},
                       stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1),
                       log_path=str(tmp_path / "torch"), device="cpu")
    ttr = tcls(tcfg, train_dataset=make_synthetic(
        n_classes=N_CLS, per_class=4, image_size=32, seed=0),
        test_dataset=None)

    rng = np.random.default_rng(7)
    start = _np(jtr.state.trainable)
    start["head"] = jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        start["head"])
    jtr.state = jtr.state.replace(
        trainable=jax.tree.map(jnp.asarray, start),
        opt_state=jtr.tx.init(jax.tree.map(jnp.asarray, start)))
    if not train_backbone:
        ttr.state.frozen = cast_towers(params_from_numpy(_np(jtr.params)),
                                       torch.float32)
    want, live = _flat(params_from_numpy(start)), _flat(ttr.state.trainable)
    assert live.keys() == want.keys()
    with torch.no_grad():
        for k, p in live.items():
            p.copy_(want[k])
    ttr.state.reset_optimizer()
    return jtr, ttr, start


def _batch():
    images = np.random.default_rng(8).integers(0, 256, (B, 32, 32, 3),
                                                dtype=np.uint8)
    labels = np.array([0, 3, 1, 2])
    mask = np.zeros(N_CLS, np.float32)
    mask[6:] = -np.inf
    return images, labels, mask


def _batches(jtr, ttr):
    images, labels, mask = _batch()
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels,
                                                               jnp.int32),
          "tokens": jtr._dummy_tokens, "mask": jnp.asarray(mask)}
    tb = {"images": torch.tensor(images), "labels": torch.tensor(labels),
          "tokens": ttr._dummy_tokens, "mask": torch.tensor(mask)}
    return jb, tb


def _check_leaves(got_tree, want_tree, start, lr_sum, keep=lambda k: True):
    """Every trainable leaf (``keep``: those whose key path it passes)
    against JAX's after the step(s). Adam's first steps move each weight by
    ~lr whatever the grad's size, so an entry whose grad sits at rounding
    noise may move differently; nearly all agree far tighter. A leaf JAX's
    step moves, the port's moves too."""
    want, w0 = _flat(_np(want_tree)), _flat(start)
    for k, got in _flat(got_tree).items():
        if not keep(k):
            continue
        got = got.detach().numpy()
        diff = np.abs(got - want[k])
        assert diff.max() <= 2 * lr_sum * (1 + 1e-3), (k, diff.max())
        if k[-2:] == ("attn", "b_qkv"):
            # the key bias's grad is zero but for rounding (softmax does not
            # see a shift of a query's scores): its Adam steps are noise
            d = diff.shape[-1] // 3
            diff = np.concatenate([diff[..., :d], diff[..., 2 * d:]], -1)
        assert np.mean(diff <= 1e-3 * lr_sum) > 0.99, (k, np.mean(
            diff <= 1e-3 * lr_sum))
        if np.abs(want[k] - w0[k]).max() > 0:
            assert np.abs(got - w0[k]).max() > 0, k


def _check_stats(m, jm):
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])


@pytest.mark.parametrize("method", ["er", "rm"])
def test_er_and_rm_step_match_jax(method, tmp_path, monkeypatch):
    """ER's step (head only, AdamW as ``scripts/er.sh``) and RM's (the same
    step under its own constant-schedule optimizer): loss, accuracy and
    every updated leaf."""
    jtr, ttr, start = _trainers(method, tmp_path, monkeypatch)
    jb, tb = _batches(jtr, ttr)
    jtr.state, jm = jtr._train_step(jtr.state, jb)
    m = ttr._train_step(ttr.state, tb)
    _check_stats(m, jm)
    _check_leaves(ttr.state.trainable, jtr.state.trainable, start, LR)
    assert ttr.state.step == int(jtr.state.step) == 1


FT_LR = 5e-2   # AdamW's decay of a leaf with no grad, lr x 1e-5, shows


def test_finetuning_step_matches_jax(tmp_path, monkeypatch):
    """FT's step trains the whole CLIP tree: every vision leaf and the head
    against JAX's; the text tower, which no grad reaches, is decayed by
    AdamW (weight decay 1e-5, decoupled) as optax decays it, within an ulp
    of the weights."""
    jtr, ttr, start = _trainers("Finetuning", tmp_path, monkeypatch,
                                lr=FT_LR)
    jb, tb = _batches(jtr, ttr)
    jtr.state, jm = jtr._train_step(jtr.state, jb)
    m = ttr._train_step(ttr.state, tb)
    _check_stats(m, jm)

    def is_text(k):
        return k[:2] == ("backbone", "text")

    _check_leaves(ttr.state.trainable, jtr.state.trainable, start, FT_LR,
                  keep=lambda k: not is_text(k))
    w, s0 = _flat(_np(jtr.state.trainable)), _flat(start)
    text = {k: v for k, v in _flat(ttr.state.trainable).items()
            if is_text(k)}
    assert len(text) == 2 + 12 + 3   # embeddings, 12 block leaves, ln, proj
    for k, got in text.items():
        got = got.detach().numpy()
        ulp = np.spacing(np.abs(s0[k]).astype(np.float32))
        np.testing.assert_array_less(np.abs(got - w[k]), 1.01 * ulp + 1e-30)
        if k[-1] == "token_embedding":   # a large leaf: the decay shows
            assert np.mean(got != s0[k]) > 0.5, k


def test_lwf_kd_step_matches_jax(tmp_path, monkeypatch):
    """LwF's KD step after a snapshot (the old head differs from the live
    one): cross entropy + 0.2 x the temperature-2 KD over raw logits.
    The port runs the frozen tower once for both heads, JAX twice."""
    jtr, ttr, start = _trainers("lwf", tmp_path, monkeypatch)
    rng = np.random.default_rng(9)
    old = jax.tree.map(lambda a: (a + 0.5 * rng.standard_normal(a.shape))
                       .astype(np.float32), start)
    jb, tb = _batches(jtr, ttr)
    jtr.state, jm = jtr._kd_step(jtr.state, jb,
                                 jax.tree.map(jnp.asarray, old))
    m = ttr._kd_step(ttr.state, tb, params_from_numpy(old))
    _check_stats(m, jm)
    _check_leaves(ttr.state.trainable, jtr.state.trainable, start, LR)


def test_lwf_one_tower_pass_equals_two():
    """The KD step's logits from one frozen-tower pass equal those of a
    pass a model, bit for bit (the same features feed both heads)."""
    params, head, images, _ = _head_setup()
    frozen = params_from_numpy(params)
    new, old = params_from_numpy({"head": head}), params_from_numpy(
        {"head": {"w": head["w"][::-1].copy(), "b": head["b"]}})
    x = torch.tensor(images)
    stub = type("Stub", (), {"clip_cfg": TTINY,
                             "compute_dtype": torch.float32,
                             "attn_impl": "fused"})()
    stub._fwd = functools.partial(ter.head_forward, clip_cfg=TTINY,
                                  compute_dtype=torch.float32)
    got_new, got_old = get_method("lwf").kd_logits(stub, frozen, new, old, x)
    two_new = stub._fwd(frozen, new, x, None)[0]
    two_old = stub._fwd(frozen, old, x, None)[0]
    assert torch.equal(got_new, two_new) and torch.equal(got_old, two_old)


def test_ewcpp_step_with_penalty_matches_jax(tmp_path, monkeypatch):
    """EWC++ on a subclass that trains the tower (so the penalty, which
    leaves the head out, is not zero): a step, the task end (importance
    <- Fisher, parameter snapshot), a second step whose second update
    carries the penalty. Loss, accuracy, every leaf, the Fisher and the
    score against JAX's; the step count advances by two a step."""
    jtr, ttr, start = _trainers("ewc++", tmp_path, monkeypatch,
                                train_backbone=True)
    jtr.ewc_state = dict(jtr.ewc_state, task_param=jtr.state.trainable)
    ttr.ewc_state["task_param"] = tree_map(lambda p: p.detach().clone(),
                                           ttr.state.trainable)
    jb, tb = _batches(jtr, ttr)
    for task_end in (True, False):
        jtr.state, jtr.ewc_state, jm = jtr._ewc_step(jtr.state, jb,
                                                     jtr.ewc_state)
        m = ttr.ewc_step(tb)
        if task_end:
            jtr.online_after_task(0)
            ttr.online_after_task(0)
    _check_stats(m, jm)
    assert ttr.state.step == int(jtr.state.step) == 4
    assert float(ttr.ewc_state["has_reg"]) == 1.0
    _check_leaves(ttr.state.trainable, jtr.state.trainable, start, 4 * LR)
    for name in ("fisher", "score", "importance"):
        want = _flat(_np(jtr.ewc_state[name]))
        for k, got in _flat(ttr.ewc_state[name]).items():
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(
                got.numpy(), want[k], rtol=1e-2, atol=1e-2 * scale + 1e-30,
                err_msg=str((name, k)))
    # the importance of the tower is not zero: the penalty acted
    imp = _flat(ttr.ewc_state["importance"])
    assert float(imp[("backbone", "vision", "proj")].abs().max()) > 0


def test_clib_steps_and_set_lr_match_jax(tmp_path, monkeypatch):
    """CLIB's step under optax.adamw's defaults (weight decay 1e-4, eps
    1e-8; torch's AdamW would decay by 1e-2), then ``_set_lr`` to half
    and a second step: the new lr reaches that update, Adam's moments kept.
    Loss, accuracy and every leaf against JAX's."""
    jtr, ttr, start = _trainers("clib", tmp_path, monkeypatch)
    jb, tb = _batches(jtr, ttr)
    group = ttr.state.opt.param_groups[0]
    assert (group["weight_decay"], group["eps"]) == (1e-4, 1e-8)
    jtr.state, jm = jtr._clib_step(jtr.state, jb)
    ttr.clib_step(ttr.state, tb)
    jtr._set_lr(LR / 2)
    ttr._set_lr(LR / 2)
    jtr.state, jm = jtr._clib_step(jtr.state, jb)
    m = ttr.clib_step(ttr.state, tb)
    assert group["lr"] == LR / 2
    _check_stats(m, jm)
    _check_leaves(ttr.state.trainable, jtr.state.trainable, start,
                  1.5 * LR)


# ---------------------------------------------------------------------------
# CutMix
# ---------------------------------------------------------------------------

def test_er_cutmix_step_soft_label_loss(monkeypatch):
    """ER's step with CutMix at a fixed draw (partner permutation, area,
    centre): the step's loss is JAX's soft-label formula on the mixed
    labels and the step's logits, -inf class slots included, and neither
    it nor any grad is NaN."""
    params, head, _, _ = _head_setup()
    frozen = cast_towers(params_from_numpy(params), torch.float32)
    trainable = params_from_numpy({"head": head})
    state = tengine.TrainState(
        trainable=trainable, frozen=frozen,
        make_opt=lambda lv: make_optimizer("adamw", lv, LR),
        gen=torch.Generator().manual_seed(0))
    seen, draws = [], []

    def fixed_cutmix(gen, x, y):
        out = tpre.cutmix(x, y, torch.tensor([2, 0, 3, 1]), 0.6, 13, 20)
        draws.append(out[1])
        return out

    def fwd(frozen, trainable, images, tokens):
        out = ter.head_forward(frozen, trainable, images, tokens,
                               clip_cfg=TTINY, compute_dtype=torch.float32)
        seen.append(out[0])
        return out

    monkeypatch.setattr(tpre, "random_cutmix", fixed_cutmix)
    step = tengine.make_train_step(
        TTINY, None, image_size=32, mean=MEAN, std=STD, use_cutmix=True,
        compute_dtype=torch.float32, forward_fn=fwd)
    images, labels, mask = _batch()
    batch = {"images": torch.tensor(images), "labels": torch.tensor(labels),
             "tokens": torch.zeros(N_CLS, 1, dtype=torch.int64),
             "mask": torch.tensor(mask)}
    for _ in range(12):
        n = len(draws)
        m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        assert all(torch.isfinite(p).all() for p in tree_leaves(trainable))
        if len(draws) > n:
            break
    assert draws, "no step of 12 drew CutMix"
    y = draws[-1].numpy()
    assert ((y > 0) & (y < 1)).any()   # the labels really mix
    logits = seen[-1].detach().numpy() + mask[None, :]
    ls = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    want = -jnp.sum(jnp.where(y > 0, y * ls, 0.0), axis=-1).mean()
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# CLIB's feature cache and adaptive LR
# ---------------------------------------------------------------------------

def _tiny_cfg(method, tmp_path, **kw):
    base = dict(method=method, dataset="synthetic-8", model_name="debug-tiny",
                batchsize=8, test_batchsize=8, online_iter=1, lr=1e-3,
                opt_name="adamw", eval_period=16, memory_size=16,
                temp_batchsize=4,
                stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1),
                transforms=("cutmix", "autoaug"), use_bf16=False,
                log_path=str(tmp_path / "logs"),
                ckpt_dir=str(tmp_path / "ck"), device="cpu")
    base.update(kw)
    return TrainConfig(**base)


def _data():
    return (make_synthetic(n_classes=8, per_class=6, image_size=32, seed=0),
            make_synthetic(n_classes=8, per_class=2, image_size=32, seed=0,
                           train=False))


def _drive(tr, task_id):
    """One task as ``run`` drives it; returns the step losses."""
    from lifelong_clip_tpu_torch.utils.stream import iter_batches
    losses = []
    tr.online_before_task(task_id)
    for idx in iter_batches(tr.stream.task_indices[task_id],
                            tr.cfg.batchsize):
        images, labels = tr.train_dataset.gather(idx)
        tr.vocab.expose(labels)
        st = tr.online_step(images, labels, idx)
        losses.append(float(st["loss"]) if st else None)
    tr.online_after_task(task_id)
    tr._task_end_eval(task_id)
    return losses


def test_clib_feature_cache_matches_full_forwards(tmp_path):
    """The sweep's losses from the slot feature buffer (incoming features
    scattered in, and after the buffer is dropped, every slot recomputed
    as a miss) equal full forwards over the memory."""
    train, test = _data()
    tr = get_method("clib")(_tiny_cfg("clib", tmp_path, memory_size=12),
                            train_dataset=train, test_dataset=test)
    _drive(tr, 0)
    idx = tr.memory.ordered_indices()
    labels = np.asarray(tr.memory.labels)
    mask = tr._tensor(tr.vocab.logit_mask(), torch.float32)
    cached = tr._memory_losses(idx, labels, mask, 256)
    tr._feat_buf = tr._slot_index = None
    tr._inc_feats = None
    missed = tr._memory_losses(idx, labels, mask, 256)
    tr._feats_cacheable = False
    full = tr._memory_losses(idx, labels, mask, 256)
    assert len(full) == len(idx) == 12 and np.isfinite(full).all()
    np.testing.assert_allclose(cached, full, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(missed, full, rtol=1e-5, atol=1e-6)


def test_clib_scatter_drops_the_sentinel():
    buf = torch.zeros(4, 2)
    feats = torch.arange(6.0).reshape(3, 2)
    tclib.CLIB.scatter_feats(buf, feats, torch.tensor([2, 0, 1]),
                             torch.tensor([1, 4, 3]))
    assert buf.tolist() == [[0, 0], [4, 5], [0, 0], [2, 3]]


class _LRStub:
    """What ``_adaptive_lr`` reads and writes on a trainer."""

    def __init__(self, cfg, lr):
        self.cfg = cfg
        self._lr_high, self._lr_low = lr, cfg.lr_step * lr
        self._lr_is_high = True
        self._high_hist, self._low_hist = [], []
        self._prev_losses = None
        self._train_count = 0
        self._imp_counter = 0
        self._loss_sweep = None
        self._dropped_idx = []
        self.lrs = []

    def _set_lr(self, lr):
        self.lrs.append(lr)

    def state(self):
        return (self._lr_high, self._lr_low, self._lr_is_high,
                list(self._high_hist), list(self._low_hist),
                self._train_count, list(self.lrs))


@pytest.mark.parametrize("trend", ["low wins", "high wins", "no winner"])
def test_clib_adaptive_lr_matches_jax(trend, tmp_path):
    """CLIB's adaptive-LR state machine (the t-test's re-centring both
    ways, and none) on the same sequence of sweeps and replaced slots:
    the port's and JAX's method, each on a stub holding the state, agree
    after every update."""
    cfg = _tiny_cfg("clib", tmp_path, lr_period=2, lr_length=3)
    jstub, tstub = _LRStub(cfg, 1e-2), _LRStub(cfg, 1e-2)
    rng = np.random.default_rng(3)
    loss = np.full(12, 2.0)
    highs = []
    for it in range(200):
        for stub in (jstub, tstub):
            stub._imp_counter += 1
        high = jstub._lr_is_high
        drop = {"low wins": 0.02 if high else 0.08,
                "high wins": 0.08 if high else 0.02,
                "no winner": 0.05}[trend]
        loss = loss - drop + 0.01 * rng.standard_normal(12)
        dropped = [int(rng.integers(0, 12))] if it % 7 == 0 else []
        for stub in (jstub, tstub):
            stub._loss_sweep = loss.copy()
            stub._dropped_idx.extend(dropped)
        jclib.CLIB._adaptive_lr(jstub)
        tclib.CLIB._adaptive_lr(tstub)
        assert tstub.state() == jstub.state(), it
        highs.append(tstub._lr_high)
    if trend == "low wins":
        assert min(highs) < 1e-2
    elif trend == "high wins":
        assert max(highs) > 1e-2


# ---------------------------------------------------------------------------
# Rainbow Memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["imagenet", "cifar100"])
def test_rm_memory_epoch_lr_matches_jax(dataset):
    for epoch in range(13):
        assert trm.RM.memory_epoch_lr(epoch, 0.05, dataset) == \
            jrm.RM.memory_epoch_lr(epoch, 0.05, dataset), epoch


def test_rm_vote_ratio_uncertainty_matches_jax():
    preds = np.random.default_rng(0).integers(0, 5, (12, 9))
    preds[:, 0] = 3          # unanimous: 0
    got = trm.vote_ratio_uncertainty(torch.tensor(preds), 5).numpy()
    want = np.asarray(jrm.vote_ratio_uncertainty(jnp.asarray(preds), 5))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0


def test_rm_memory_epochs_walk_slot_order_like_jax(tmp_path):
    """RM's post-task epochs on the port's and JAX's code (each on a stub
    recording its steps): the same batches in slot order, ``len // bs``
    walks of the memory an epoch, the tail batch unpadded, and the lr of
    each epoch."""
    cfg = _tiny_cfg("rm", tmp_path, memory_epoch=3, batchsize=4,
                    dataset="cifar100")
    rec = {"jax": [], "torch": []}

    class Memory:
        def __init__(self):
            self.idx = np.array([5, 9, 2, 7, 11, 3, 8, 1, 6, 4, 10])

        def __len__(self):
            return len(self.idx)

        def ordered_indices(self):
            return self.idx

    class Data:
        def gather(self, idx):
            idx = np.asarray(idx)
            return np.zeros((len(idx), 2, 2, 3), np.uint8), idx % 8

    class Vocab:
        def remap(self, labels):
            return np.asarray(labels)

        def logit_mask(self):
            return np.zeros(8, np.float32)

    def stub(name):
        s = type("Stub", (), {})()
        s.cfg, s.memory, s.train_dataset, s.vocab = cfg, Memory(), Data(), \
            Vocab()
        s._dp_mesh, s._dummy_tokens, s.state, s.device = None, None, None, \
            torch.device("cpu")
        s._set_lr = lambda lr: rec[name].append(("lr", lr))

        def step(state, batch):
            rec[name].append(("batch", np.asarray(batch["labels"]).tolist()))
            return state, {}
        s._train_step = step
        s.memory_epoch_lr = trm.RM.memory_epoch_lr
        s._tensor = lambda a, dtype=None: torch.as_tensor(np.asarray(a))
        s._batch = lambda imgs, labs, mask=None: \
            ter.ER._batch(s, imgs, labs, mask)
        return s

    jrm.RM._memory_train_epochs(stub("jax"))
    trm.RM._memory_train_epochs(stub("torch"))
    assert rec["torch"] == rec["jax"]
    # 11 slots, bs 4: two walks an epoch, 22 rows: five batches of 4 and an
    # unpadded tail of 2, each epoch at its lr
    want = []
    order = (Memory().idx % 8).tolist() * 2
    for epoch in range(3):
        want.append(("lr", trm.RM.memory_epoch_lr(epoch, cfg.lr,
                                                  "cifar100")))
        want += [("batch", order[lo:lo + 4]) for lo in range(0, 22, 4)]
    assert rec["torch"] == want


# ---------------------------------------------------------------------------
# resume, and the CLI
# ---------------------------------------------------------------------------

def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


RESUME = {"lwf": {}, "ewc++": {}, "clib": {"imp_update_period": 1},
          "rm": {"memory_epoch": 2, "rm_uncertainty": True}}


@pytest.mark.parametrize("method", sorted(RESUME))
def test_resume_is_bitwise(method, tmp_path):
    """Task 0 with a checkpoint after it, restored into a fresh trainer:
    task 1's losses, every trainable tensor, the optimizer's lr, the
    memory and the method's extra state (LwF's teacher, EWC++'s Fisher,
    score, importance and snapshot, CLIB's adaptive-LR state, RM's view
    generator) equal the uninterrupted run's bit for bit."""
    from lifelong_clip_tpu_torch.utils.checkpoints import restore_trainer
    cfg = _tiny_cfg(method, tmp_path, **RESUME[method])
    train, test = _data()
    cls = get_method(method)
    tr = cls(cfg, train_dataset=train, test_dataset=test)
    _drive(tr, 0)
    tr._maybe_checkpoint(0)
    want = _drive(tr, 1)
    tr2 = cls(cfg, train_dataset=train, test_dataset=test)
    restore_trainer(tr2, cfg.ckpt_dir)
    got = _drive(tr2, 1)
    assert got == want and any(v is not None for v in want)
    for a, b in zip(tree_leaves(tr.state.trainable),
                    tree_leaves(tr2.state.trainable)):
        assert torch.equal(a, b)
    assert tr.state.opt.param_groups[0]["lr"] == \
        tr2.state.opt.param_groups[0]["lr"]
    assert _same(tr.memory.state_dict(), tr2.memory.state_dict())
    assert _same(tr.checkpoint_extra(), tr2.checkpoint_extra())


METHODS = ["er", "Finetuning", "lwf", "ewc++", "clib", "rm"]


@pytest.mark.parametrize("method", METHODS)
def test_cli_cpu_run_writes_result(method, tmp_path):
    argv = ["--method", method, "--model_name", "debug-tiny", "--dataset",
            "synthetic-10x8", "--n_tasks", "2", "--batchsize", "8",
            "--temp_batchsize", "4", "--memory_size", "16",
            "--test_batchsize", "8", "--eval_period", "32", "--device",
            "cpu", "--log_path", str(tmp_path)]
    if method == "rm":
        argv += ["--memory_epoch", "2", "--rm_uncertainty"]
    out = cli.main(argv)
    assert set(out) == {"A_auc", "A_avg", "A_last", "F_last"}
    found = [os.path.join(d, "result.txt") for d, _, fs in os.walk(tmp_path)
             if "result.txt" in fs]
    assert len(found) == 1


def test_registry_has_every_jax_name():
    from lifelong_clip_tpu.methods import get_method as jget
    names = ["continual-clip", "lora-clip", "adapter-clip", "moe-clip",
             "er", "Finetuning", "lwf", "ewc++", "clib", "rm", "maple",
             "mvp-clip", "adapter-clip-proto_prompt", "template", "l2p",
             "dualprompt", "mvp"]
    for name in names:
        jget(name)
        assert get_method(name) is not None
    with pytest.raises(NotImplementedError, match="not available"):
        get_method("no-such-method")
