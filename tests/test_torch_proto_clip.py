"""The port's ProtoCLIP (``models/proto_clip.py``, ``methods/proto_clip.py``)
against the JAX package's, on the same weights and inputs.

The towers are ``debug-tiny`` (6 vision layers: the CoPL pool's first 6 of
7 layers live; a 3-layer text tower). Weights come from the JAX init
through the bridge, inputs from numpy seeds. The port's ``"unfused"`` road
is held against JAX's ``"xla"`` road in fp32 (the einsum suffix ``body``),
its ``"fused"`` road (the kernel ops' plain versions on the CPU) against
JAX's ``"pallas"`` road (``fused_body``) with the Pallas kernels in
interpret mode. The host-side pieces (Gram-Schmidt, the drift
displacement, the stage-2 draws) are numpy on both sides and held bit for
bit. Each JAX reference is jitted once and shared.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import CLIP_PRESETS as JPRESETS
from lifelong_clip_tpu.config import StreamConfig as JStream
from lifelong_clip_tpu.config import TrainConfig as JTrainConfig
from lifelong_clip_tpu.data.registry import get_dataset as jget_dataset
from lifelong_clip_tpu.methods import proto_clip as jmethod
from lifelong_clip_tpu.models import proto_clip as jpc
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.ops import attention as jattention
from lifelong_clip_tpu.ops import preprocess as jpre
from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import CLIP_PRESETS, StreamConfig
from lifelong_clip_tpu_torch.config import TrainConfig
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods import proto_clip as tmethod
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.models import proto_clip as tpc
from lifelong_clip_tpu_torch.models.clip import cast_towers
from lifelong_clip_tpu_torch.ops import preprocess as tpre
from lifelong_clip_tpu_torch.utils.checkpoints import restore_trainer
from lifelong_clip_tpu_torch.utils.stream import iter_batches

JCFG, TCFG = JPRESETS["debug-tiny"], CLIP_PRESETS["debug-tiny"]
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
# the text pass's small case: 2 samples x 3 classes, top-2 of 4 prompts
# of 3 ctx tokens (lp = 7), EOT at 9, 12 and 10, so S = 6
B, C, TOP_K, N_CTX = 2, 3, 2, 3
SUFFIX = 12 - (1 + TOP_K * N_CTX) + 1


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


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-12))


@functools.lru_cache(maxsize=None)
def _setup():
    frozen = _np(init_clip_params(jax.random.PRNGKey(0), JCFG))
    proto = _np(jpc.init_proto_params(jax.random.PRNGKey(1), JCFG,
                                      num_prompt=4, n_ctx=N_CTX,
                                      copl_pool=20))
    rng = np.random.default_rng(11)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    img = rng.standard_normal((B, JCFG.embed_dim)).astype(np.float32)
    tokens = np.zeros((C, JCFG.context_length), np.int32)
    for i, e in enumerate([9, 12, 10]):
        tokens[i, 0] = 49406
        tokens[i, 1:e] = rng.integers(1, 40000, e - 1)
        tokens[i, e] = 49407
    w = rng.standard_normal((B, C, JCFG.embed_dim)).astype(np.float32)
    return frozen, proto, images, img, tokens, w


def _torch_tree(tree):
    t = params_from_numpy(tree)
    for leaf in _flat(t).values():
        leaf.requires_grad_(True)
    return t


# ---------------------------------------------------------------------------
# host-side pieces: bit for bit
# ---------------------------------------------------------------------------

def test_gram_schmidt_matches_jax_bitwise():
    rng = np.random.default_rng(2)
    for shape in [(3, 7, 2, 5), (3, 6, 9), (4, 12)]:
        t = rng.uniform(-1, 1, shape).astype(np.float32)
        if len(shape) == 3:
            t[1, 3] = t[1, 2]          # a degenerate vector: the seeded redraw
        np.testing.assert_array_equal(tpc.gram_schmidt(t),
                                      jpc.gram_schmidt(t))


def test_displacement_matches_jax_bitwise():
    rng = np.random.default_rng(3)
    y1 = rng.standard_normal((12, 8))
    y2 = y1 + 0.1 * rng.standard_normal((12, 8))
    old = rng.standard_normal((3, 8))
    np.testing.assert_array_equal(tmethod.displacement(y1, y2, old, 4.0),
                                  jmethod.displacement(y1, y2, old, 4.0))


def test_stage2_draws_match_jax_bitwise():
    """The stage-2 epoch draws (per-class MVN by cholesky where the
    covariance is PD, else svd; the shuffle) from the same numpy seed."""
    rng = np.random.default_rng(4)
    e = 6
    means = rng.standard_normal((5, e))
    covs = np.zeros((5, e, e))
    for i in range(5):
        a = rng.standard_normal((e, e))
        covs[i] = a @ a.T + 1e-3 * np.eye(e)
    covs[3] = -np.eye(e)                  # not PD: the svd road
    me = types.SimpleNamespace(_class_means=means, _class_covs=covs,
                               num_sampled_pcls=7, task_count=2)
    slots, task_size = np.array([0, 1, 3, 4]), 2
    with pytest.warns(RuntimeWarning, match="positive-semidefinite"):
        got = tmethod.Trainer_ProtoCLIP._stage2_sample_epoch(
            me, slots, task_size, np.random.default_rng(9))
    with pytest.warns(RuntimeWarning, match="positive-semidefinite"):
        want = jmethod.Trainer_ProtoCLIP._stage2_sample_epoch(
            me, slots, task_size, np.random.default_rng(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tmethod._is_pd(covs[0]) and not tmethod._is_pd(covs[3])


def test_prompt_combinations_and_fold_match_jax():
    combos, lookup = tpc.prompt_combinations(10, 2)
    jcombos, jlookup = jpc.prompt_combinations(10, 2)
    np.testing.assert_array_equal(combos, jcombos)
    np.testing.assert_array_equal(lookup, jlookup)
    assert len(combos) == 90
    idx = np.array([[3, 7], [9, 0], [4, 4]])
    np.testing.assert_array_equal(
        tpc.fold_selection(torch.tensor(idx), 10).numpy(),
        np.asarray(jpc.fold_selection(jnp.asarray(idx), 10)))
    assert tpc.prompt_combinations(30, 3) == (None, None)
    for need in (3, 8, 9, 45, 60):
        assert tpc.choose_suffix_len(need + 24, 25, 77) == \
            jpc.choose_suffix_len(need + 24, 25, 77)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------

COPL_CASES = {"train, task 0": (0, True), "train, task 1": (1, True),
              "eval, task 1": (1, False)}


@pytest.mark.parametrize("case", sorted(COPL_CASES))
def test_copl_prefixes_match_jax(case):
    """The (Ek, Ev) prefixes, the valid mask and the grads of the pools
    through them: the live slice only in training (earlier slices frozen),
    every slice up to the task's in eval."""
    task_count, train = COPL_CASES[case]
    _, proto, *_ = _setup()
    q = np.random.default_rng(5).standard_normal(
        (3, JCFG.vision_width)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal(
        (JCFG.vision_layers, 3, 4, JCFG.vision_width)).astype(np.float32)
    kw = dict(task_count=task_count, n_tasks=2, train=train)

    def jloss(copl):
        pr, valid = jpc.copl_prefixes(copl, jnp.asarray(q),
                                      JCFG.vision_layers,
                                      dtype=jnp.float32, **kw)
        return jnp.sum(pr["k"] * w) + jnp.sum(pr["v"] * w ** 2), \
            (pr, valid)

    (_, (jpr, jvalid)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, proto["copl"]))
    copl = _torch_tree(proto["copl"])
    pr, valid = tpc.copl_prefixes(copl, torch.tensor(q), TCFG.vision_layers,
                                  dtype=torch.float32, **kw)
    tw = torch.tensor(w)
    if train:
        ((pr["k"] * tw).sum() + (pr["v"] * tw ** 2).sum()).backward()
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    for k in ("k", "v"):
        _close(pr[k].detach().numpy(), jpr[k], 1e-5)
    for k, g in _np(jgrads).items():
        if not train:
            assert not np.any(g)
            continue
        assert np.any(g), k
        _close(copl[k].grad.numpy(), g, 1e-5)
        # the frozen (earlier) and future slices get none
        pt = 10
        dead = np.ones(20, bool)
        dead[task_count * pt:(task_count + 1) * pt] = False
        assert not np.any(copl[k].grad.numpy()[:, dead])


def _jax_road(fn, jimpl):
    if jimpl == "xla":
        return fn()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(jattention, "_DEFAULT_IMPL", "pallas")
        # interpret-mode Pallas carries an effect jax.checkpoint cannot
        # partial-eval (tests/test_proto_clip.py:409-412)
        mp.setenv("LLC_SUFFIX_REMAT", "none")
        return fn()


ROADS = [("unfused", "xla"), ("fused", "pallas")]
_JAX_CACHE = {}


def _cached(key, fn):
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = fn()
    return _JAX_CACHE[key]


def _jax_image(jimpl):
    frozen, proto, images, *_ = _setup()

    def run():
        def loss(p, frozen, images):
            img = jpc.proto_encode_image(frozen, p, images, JCFG,
                                         task_count=1, n_tasks=2, train=True,
                                         compute_dtype=jnp.float32)
            return jnp.sum(img * jnp.arange(img.shape[-1])), img

        (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            proto, frozen, jnp.asarray(images))
        return np.asarray(img), _np(g)

    return _cached(("image", jimpl), lambda: _jax_road(run, jimpl))


@pytest.mark.parametrize("impl,jimpl", ROADS)
def test_proto_encode_image_matches_jax(impl, jimpl):
    """The CoPL-prompted image tower (pk != pv, P = 4, layer 5 of the
    6 live): the normalized features and the grads of the CoPL pools."""
    want, jgrads = _jax_image(jimpl)
    frozen, proto, images, *_ = _setup()
    tproto = _torch_tree(proto)
    img = tpc.proto_encode_image(params_from_numpy(frozen), tproto,
                                 torch.tensor(images), TCFG, task_count=1,
                                 n_tasks=2, train=True,
                                 compute_dtype=torch.float32,
                                 attn_impl=impl)
    (img * torch.arange(img.shape[-1])).sum().backward()
    tol, gtol = (1e-4, 1e-4) if impl == "unfused" else (2e-3, 1e-2)
    _close(img.detach().numpy(), want, tol)
    for k, g in _flat(jgrads["copl"]).items():
        assert np.any(g), k
        _close(tproto["copl"][k[0]].grad.numpy(), g, gtol)


def _jax_text(jimpl, suffix_len):
    frozen, proto, _, img, tokens, w = _setup()

    def run():
        def loss(p, frozen, img, tokens, w):
            txt, idx = jpc.proto_text_features(
                frozen, p, img, tokens, JCFG, top_k=TOP_K, n_ctx=N_CTX,
                suffix_len=suffix_len, compute_dtype=jnp.float32)
            return jnp.sum(txt * w), (txt, idx)

        (_, (txt, idx)), g = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(proto, frozen, jnp.asarray(img),
                                 jnp.asarray(tokens), jnp.asarray(w))
        return np.asarray(txt), np.asarray(idx), _np(g)

    return _cached(("text", jimpl, suffix_len),
                   lambda: _jax_road(run, jimpl))


def _torch_text(impl, suffix_len):
    frozen, proto, _, img, tokens, w = _setup()
    tproto = _torch_tree(proto)
    txt, idx = tpc.proto_text_features(
        params_from_numpy(frozen), tproto, torch.tensor(img),
        torch.tensor(tokens), TCFG, top_k=TOP_K, n_ctx=N_CTX,
        suffix_len=suffix_len, compute_dtype=torch.float32, attn_impl=impl)
    (txt * torch.tensor(w)).sum().backward()
    return txt.detach().numpy(), idx.numpy(), tproto["text_prompt"].grad


@pytest.mark.parametrize("impl,jimpl", ROADS)
def test_prefix_shared_text_matches_jax(impl, jimpl):
    """The prefix-shared text pass (the prefix through the plain block op
    at T = lp under its causal mask, collecting each block's input; the
    class suffixes as one flat C * S row a sample through the prefix op
    under the block-diagonal mask, or JAX's einsum ``body``): the features,
    the selection and the grads of the selected prompts."""
    want, jidx, jgrads = _jax_text(jimpl, SUFFIX)
    txt, idx, grad = _torch_text(impl, SUFFIX)
    tol, gtol = (1e-4, 1e-4) if impl == "unfused" else (2e-3, 1e-2)
    np.testing.assert_array_equal(idx, jidx)
    _close(txt, want, tol)
    assert np.any(jgrads["text_prompt"])
    _close(grad.numpy(), jgrads["text_prompt"], gtol)


def test_prefix_shared_text_equals_the_full_pass():
    """Prefix sharing is exact: against B * C full 77-token passes (the
    port's and JAX's) in fp32, values and the prompts' grads."""
    want, _, jgrads = _jax_text("xla", None)
    full, _, gfull = _torch_text("unfused", None)
    shared, _, gshared = _torch_text("unfused", SUFFIX)
    _close(full, want, 1e-4)
    _close(gfull.numpy(), jgrads["text_prompt"], 1e-4)
    _close(shared, full, 1e-4)
    _close(gshared.numpy(), gfull.numpy(), 1e-4)


def test_proto_passes_run_the_fused_ops_on_every_block(monkeypatch):
    """On the fused road: the image pass runs the prefix op (P = 4) in all
    6 blocks, the text prefix the plain block op at T = lp in the first 2
    of 3, and the suffix pass the prefix op at T = C * S with P = lp in all
    3."""
    calls = []

    def counted(name, orig):
        def f(x, *a, **kw):
            calls.append((name, x.shape[1], a[0].shape[1]
                          if name == "prefix" else None))
            return orig(x, *a, **kw)
        return f

    monkeypatch.setattr(tclip, "fused_ln_attention_block", counted(
        "block", tclip.fused_ln_attention_block))
    monkeypatch.setattr(tclip, "fused_prefix_attention_block", counted(
        "prefix", tclip.fused_prefix_attention_block))
    monkeypatch.setattr(tpc, "fused_prefix_attention_block", counted(
        "prefix", tpc.fused_prefix_attention_block))
    frozen, proto, images, img, tokens, _ = _setup()
    tpc.proto_encode_image(params_from_numpy(frozen), _torch_tree(proto),
                           torch.tensor(images), TCFG, task_count=0,
                           n_tasks=2, train=True,
                           compute_dtype=torch.float32)
    n_v, n_t, lp = TCFG.vision_layers, TCFG.text_layers, 1 + TOP_K * N_CTX
    assert calls == [("block", 17, None)] * n_v + [("prefix", 17, 4)] * n_v
    calls.clear()
    # the forward alone: the backward recomputes each checkpointed suffix
    # layer, as JAX's remat does
    tpc.proto_text_features(
        params_from_numpy(frozen), _torch_tree(proto), torch.tensor(img),
        torch.tensor(tokens), TCFG, top_k=TOP_K, n_ctx=N_CTX,
        suffix_len=SUFFIX, compute_dtype=torch.float32)
    # the prefix pass stops before the last block, whose output no layer
    # reads (JAX's jit drops it)
    assert calls == [("block", lp, None)] * (n_t - 1) \
        + [("prefix", C * SUFFIX, lp)] * n_t


def test_suffix_mask_is_block_diagonal_causal():
    m = tpc.suffix_mask(3, 4, 5)
    assert m.shape == (12, 17)
    assert not torch.isinf(m[:, :5]).any()
    live = ~torch.isinf(m[:, 5:])
    want = torch.block_diag(*[torch.tril(torch.ones(4, 4, dtype=bool))] * 3)
    assert torch.equal(live, want)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _eval_like_jax(rng, images_u8):
    """JAX's train pipeline replaced by its eval preprocessing: the tests
    hold the trainers, not the augmentation draws (which come from
    different generators in the two packages)."""
    x = images_u8.astype(jnp.float32) / 255.0
    x = jpre.resize_bilinear(x, 32)
    return jpre.normalize(x, MEAN, STD).astype(jnp.float32)


def _eval_like_port():
    pipe = tpre.make_eval_pipeline(32, MEAN, STD, out_dtype=torch.float32)
    return lambda gen, x: pipe(x)


def _jax_cfg(tmp_path, **kw):
    base = dict(method="adapter-clip-proto_prompt", dataset="synthetic-10x8",
                model_name="debug-tiny", batchsize=8, test_batchsize=8,
                online_iter=1, lr=5e-3, opt_name="adam", memory_size=0,
                eval_period=32, transforms=(), use_bf16=False,
                stream=JStream(n_tasks=2, n=50, m=10, seed=1),
                log_path=str(tmp_path / "jax"), seed=1)
    base.update(kw)
    return JTrainConfig(**base)


def _port_cfg(jcfg, tmp_path):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)
              if f.name not in ("stream", "peft", "log_path")}
    s = jcfg.stream
    return TrainConfig(**fields, log_path=str(tmp_path / "torch"),
                       stream=StreamConfig(n_tasks=s.n_tasks, n=s.n, m=s.m,
                                           seed=s.seed), device="cpu")


def _given_proto(seed=5):
    return _np(jpc.init_proto_params(jax.random.PRNGKey(seed), JCFG))


def test_stage1_step_matches_jax(tmp_path, monkeypatch):
    """One stage-1 step at task 1 (CoPL slice 1 live, slice 0 frozen) of
    the port's trainer on the JAX trainer's
    weights and pools (``"unfused"``, fp32, Adam): the loss and every
    updated pool. Adam's first step moves each weight by ~lr whatever its
    grad's size, so an entry whose grad sits at rounding noise may move
    differently; nearly all agree far tighter."""
    monkeypatch.setattr(jpre, "make_train_pipeline",
                        lambda *a, **kw: _eval_like_jax)
    jcfg = _jax_cfg(tmp_path)
    train = jget_dataset("synthetic-10x8", train=True)
    jtr = jmethod.Trainer_ProtoCLIP(jcfg, train_dataset=train,
                                    test_dataset=train)
    tcls = type("Trainer_ProtoCLIP", (tmethod.Trainer_ProtoCLIP,),
                {"attn_impl": "unfused"})
    ttr = tcls(_port_cfg(jcfg, tmp_path), train_dataset=make_synthetic(
        n_classes=10, per_class=8, seed=0))
    start = _given_proto()
    jtr.state = jtr.state.replace(
        trainable=jax.tree.map(jnp.asarray, start),
        opt_state=jtr.tx.init(jax.tree.map(jnp.asarray, start)))
    ttr.state.frozen = cast_towers(params_from_numpy(_np(jtr.params)),
                                   torch.float32)
    live = _flat(ttr.state.trainable)
    with torch.no_grad():
        for k, v in _flat(params_from_numpy(start)).items():
            live[k].copy_(v)
    ttr.state.reset_optimizer()
    ttr._pipeline = _eval_like_port()
    assert ttr.suffix_len == jtr.suffix_len is not None

    labels = np.array([0, 3, 1, 2, 0, 5, 3, 1])
    for tr in (jtr, ttr):
        tr.vocab.expose(labels)
    tokens, mask, y, _ = jtr.vocab.batch_table(labels, jtr.step_capacity)
    images = np.random.default_rng(8).integers(0, 256, (8, 32, 32, 3),
                                                dtype=np.uint8)
    jstate, jm = jtr._stage1_step(
        jtr.state, {"images": jnp.asarray(images),
                    "labels": jnp.asarray(y, jnp.int32),
                    "tokens": jnp.asarray(tokens),
                    "mask": jnp.asarray(mask)}, 1)
    ttr.task_count = 1
    m = ttr.stage1_step({"images": torch.tensor(images),
                         "labels": torch.tensor(y, dtype=torch.int64),
                         "tokens": torch.tensor(tokens, dtype=torch.int64),
                         "mask": torch.tensor(mask)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    lr = jcfg.lr
    want = _flat(_np(jstate.trainable))
    w0 = _flat(start)
    for k, got in _flat(ttr.state.trainable).items():
        got = got.detach().numpy()
        diff = np.abs(got - want[k])
        assert diff.max() <= 2 * lr * (1 + 1e-3), (k, diff.max())
        assert np.mean(diff <= 1e-3 * lr) > 0.99, (k, np.mean(
            diff <= 1e-3 * lr))
        moved = np.abs(want[k] - w0[k]).max() > 0
        assert moved == (np.abs(got - w0[k]).max() > 0), k
        # the selected text prompts and the live CoPL slice train; the
        # keys are reached only through a top-k (no grad), as in JAX
        assert moved == (k != ("text_key",)), k


def _result_lines(root):
    found = [os.path.join(d, "result.txt") for d, _, fs in os.walk(root)
             if "result.txt" in fs]
    assert len(found) == 1
    return open(found[0]).read().splitlines()


def test_two_task_run_through_main_matches_jax(tmp_path, monkeypatch):
    """A two-task run of the port through ``main --device cpu`` and the JAX
    trainer's ``run``, on the same frozen towers, pools and (augmentation
    replaced by the eval preprocessing) inputs: both build the same
    prototypes and covariances, stage 2 runs after task 2, and result.txt
    holds the same accuracies."""
    frozen = _np(init_clip_params(jax.random.PRNGKey(0), JCFG))
    start = _given_proto()
    monkeypatch.setattr(jpre, "make_train_pipeline",
                        lambda *a, **kw: _eval_like_jax)
    monkeypatch.setattr(jpc, "init_proto_params",
                        lambda *a, **kw: jax.tree.map(jnp.asarray, start))
    monkeypatch.setattr(jmethod, "build_clip", lambda *a, **kw: (
        jax.tree.map(jnp.asarray, frozen), JCFG))
    port = {}
    orig_setup = tmethod.Trainer_ProtoCLIP.setup_model

    def setup(self):
        orig_setup(self)
        port["trainer"] = self

    monkeypatch.setattr(tmethod.Trainer_ProtoCLIP, "setup_model", setup)
    monkeypatch.setattr(tmethod.Trainer_ProtoCLIP, "attn_impl", "unfused")
    # stage 2 at 2 epochs of 8 draws a class (the scripts: 5 of 64) keeps
    # its every step and draw at a tenth of the test's time
    for cls in (tmethod.Trainer_ProtoCLIP, jmethod.Trainer_ProtoCLIP):
        monkeypatch.setattr(cls, "ca_epochs", 2)
        monkeypatch.setattr(cls, "num_sampled_pcls", 8)
    monkeypatch.setattr(tpre, "make_train_pipeline",
                        lambda *a, **kw: _eval_like_port())
    monkeypatch.setattr(tpc, "init_proto_params",
                        lambda *a, device=None, **kw: params_from_numpy(
                            start, device))
    monkeypatch.setattr(tmethod, "build_clip", lambda *a, device=None, **kw: (
        params_from_numpy(frozen, device), TCFG))

    jcfg = _jax_cfg(tmp_path, note="proto")
    jtr = jmethod.Trainer_ProtoCLIP(jcfg, synthetic_fallback=True)
    jout = jtr.run()
    out = cli.main(["--method", "adapter-clip-proto_prompt", "--model_name",
                    "debug-tiny", "--dataset", "synthetic-10x8",
                    "--n_tasks", "2", "--batchsize", "8",
                    "--test_batchsize", "8", "--eval_period", "32",
                    "--lr", "5e-3", "--opt_name", "adam", "--seed", "1",
                    "--device", "cpu", "--no_bf16", "--transforms",
                    "--log_path", str(tmp_path / "torch"), "--note",
                    "proto"])
    tr = port["trainer"]
    assert tr.task_count == jtr.task_count == 1
    np.testing.assert_array_equal(tr._have_proto, jtr._have_proto)
    assert tr._have_proto.sum() == 10
    _close(tr._class_means, jtr._class_means, 1e-5)
    _close(tr._class_covs, jtr._class_covs, 1e-4)
    assert set(out) == set(jout)
    jlines = _result_lines(tmp_path / "jax")
    lines = _result_lines(tmp_path / "torch")
    assert len(lines) == len(jlines) == 3
    assert lines[0] == jlines[0], (lines[0], jlines[0])
    assert lines[1] == jlines[1]


def test_resume_is_bitwise(tmp_path):
    """Task 0 with a checkpoint after it, restored into a fresh trainer:
    the first task-1 step (after the drift features, the CoPL advance and
    its Gram-Schmidt) and, after task 1 with its prototypes and stage 2,
    the prototypes, covariances, task counter and every pool equal the
    uninterrupted run's bit for bit."""
    cfg = TrainConfig(method="adapter-clip-proto_prompt",
                      dataset="synthetic-8", model_name="debug-tiny",
                      batchsize=8, test_batchsize=8, online_iter=1, lr=1e-3,
                      eval_period=16, memory_size=0,
                      stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1),
                      transforms=("autoaug",), use_bf16=False,
                      log_path=str(tmp_path / "logs"),
                      ckpt_dir=str(tmp_path / "ck"), device="cpu")
    train = make_synthetic(n_classes=8, per_class=6, image_size=32, seed=0)
    test = make_synthetic(n_classes=8, per_class=2, image_size=32, seed=0,
                          train=False)
    cls = type("Trainer_ProtoCLIP", (tmethod.Trainer_ProtoCLIP,),
               {"ca_epochs": 1, "num_sampled_pcls": 8})

    def drive(tr, task_id):
        tr.online_before_task(task_id)
        losses = []
        for idx in iter_batches(tr.stream.task_indices[task_id], 8):
            images, labels = tr.train_dataset.gather(idx)
            tr.vocab.expose(labels)
            losses.append(float(tr.online_step(images, labels, idx)["loss"]))
        tr.online_after_task(task_id)
        tr._task_end_eval(task_id)
        return losses

    tr = cls(cfg, train_dataset=train, test_dataset=test)
    drive(tr, 0)
    tr._maybe_checkpoint(0)
    want = drive(tr, 1)
    tr2 = cls(cfg, train_dataset=train, test_dataset=test)
    restore_trainer(tr2, cfg.ckpt_dir)
    got = drive(tr2, 1)
    assert got == want
    assert tr2.task_count == tr.task_count == 1
    for a in ("_class_means", "_class_covs", "_have_proto"):
        np.testing.assert_array_equal(getattr(tr2, a), getattr(tr, a))
    assert tr._have_proto.any()
    for (k, a), b in zip(_flat(tr.state.trainable).items(),
                         _flat(tr2.state.trainable).values()):
        assert torch.equal(a, b), k
    assert tr.metrics.task_acc == tr2.metrics.task_acc
