"""The port's vit-prompt family (``models/vit_prompt.py``,
``methods/vit_prompt_methods.py``, ``models/convert.py:timm_vit_to_params``)
against the JAX package's, on the same weights and inputs.

The tower is ``debug-tiny`` (6 vision layers, so DualPrompt's e-prompt
layers (2, 3, 4) place and layer 5 has no live slot) in its timm variant:
exact GELU, no ln_pre, and a patch bias, with weights from a timm-layout
state dict written here from a numpy seed and read by both packages'
converters. The port's ``"unfused"`` road is held against JAX's ``"xla"``
road in fp32; its ``"fused"`` road (the kernel ops' plain versions on the
CPU) against JAX's ``"pallas"`` road with the Pallas kernels in interpret
mode, in fp32 and in bf16. Each JAX reference is jitted once and shared.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import CLIP_PRESETS as JPRESETS
from lifelong_clip_tpu.config import StreamConfig as JStream
from lifelong_clip_tpu.config import TrainConfig as JTrainConfig
from lifelong_clip_tpu.data.registry import make_synthetic as jsynthetic
from lifelong_clip_tpu.methods import vit_prompt_methods as jmethods
from lifelong_clip_tpu.models import clip as jclip
from lifelong_clip_tpu.models import convert as jconvert
from lifelong_clip_tpu.models import vit_prompt as jvp
from lifelong_clip_tpu.ops import attention as jattention
from lifelong_clip_tpu.ops import preprocess as jpre
from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import CLIP_PRESETS, StreamConfig
from lifelong_clip_tpu_torch.config import TrainConfig
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods import get_method
from lifelong_clip_tpu_torch.methods import vit_prompt_methods as tmethods
from lifelong_clip_tpu_torch.methods.engine import tree_leaves
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.models import convert as tconvert
from lifelong_clip_tpu_torch.models import vit_prompt as tvp
from lifelong_clip_tpu_torch.models.clip import cast_towers
from lifelong_clip_tpu_torch.ops import preprocess as tpre

TIMM = dict(act="gelu", use_ln_pre=False)
JCFG = dataclasses.replace(JPRESETS["debug-tiny"], **TIMM)
TCFG = dataclasses.replace(CLIP_PRESETS["debug-tiny"], **TIMM)
B, N_CLS, E_POOL = 4, 8, 3
L2P_KW = dict(selection_size=5, prompt_len=5)
DUAL_KW = dict(pos_g=(0, 1), pos_e=(2, 3, 4), len_g=5, len_e=20)
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny towers gain nothing from intra-op threads, and under the
    suite's parallel workers those threads oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_block_a_scan_step():
    """JAX's towers here scan one block a step: the TPU's group of 4
    unrolls 3 blocks at 6 layers, and XLA compiles (interpret mode: each
    Pallas kernel instance) every unrolled block; one a step is a third of
    the compile time for the same arithmetic."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvp, "_SCAN_GROUP", 1)
        yield


def timm_state_dict(seed=0, width=64, layers=6, patch=8, grid=4,
                    n_cls=N_CLS):
    """A timm ViT state dict (``vit_base_patch16_224``'s key names and
    shapes, at the tiny tower's sizes) of fp32 arrays from a numpy seed."""
    rng = np.random.default_rng(seed)
    w = width

    def n(*shape, std=1.0):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    sd = {"cls_token": n(1, 1, w, std=0.5),
          "pos_embed": n(1, grid * grid + 1, w, std=0.5),
          "patch_embed.proj.weight": n(w, 3, patch, patch, std=0.05),
          "patch_embed.proj.bias": n(w, std=0.1),
          "norm.weight": 1 + n(w, std=0.1), "norm.bias": n(w, std=0.1),
          "head.weight": n(n_cls, w, std=0.2), "head.bias": n(n_cls, std=0.1)}
    for i in range(layers):
        p = f"blocks.{i}"
        sd.update({
            f"{p}.norm1.weight": 1 + n(w, std=0.1),
            f"{p}.norm1.bias": n(w, std=0.1),
            f"{p}.attn.qkv.weight": n(3 * w, w, std=w ** -0.5),
            f"{p}.attn.qkv.bias": n(3 * w, std=0.02),
            f"{p}.attn.proj.weight": n(w, w, std=w ** -0.5),
            f"{p}.attn.proj.bias": n(w, std=0.02),
            f"{p}.norm2.weight": 1 + n(w, std=0.1),
            f"{p}.norm2.bias": n(w, std=0.1),
            f"{p}.mlp.fc1.weight": n(4 * w, w, std=w ** -0.5),
            f"{p}.mlp.fc1.bias": n(4 * w, std=0.02),
            f"{p}.mlp.fc2.weight": n(w, 4 * w, std=(4 * w) ** -0.5),
            f"{p}.mlp.fc2.bias": n(w, std=0.02)})
    return sd


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


@functools.lru_cache(maxsize=None)
def _setup():
    """Weights and inputs, numpy: the frozen tower from the timm converter
    (JAX's), an L2P tree, a DualPrompt tree (heads random so the prompts'
    grads are not zero) and images."""
    frozen, cfg, head = jconvert.timm_vit_to_params(timm_state_dict())
    assert (cfg.act, cfg.use_ln_pre) == ("gelu", False)
    rng = np.random.default_rng(1)

    def given(*shape, std=0.3):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    d = JCFG.vision_width
    l2p = {"pool": _np(jvp.init_prompt_pool(jax.random.PRNGKey(1), 10, 5,
                                            d)),
           "head": {"w": given(d, N_CLS), "b": given(N_CLS)}}
    dual = {"g_pool": _np(jvp.init_prompt_pool(jax.random.PRNGKey(2), 1, 10,
                                               d)),
            "e_pool": _np(jvp.init_prompt_pool(jax.random.PRNGKey(3), E_POOL,
                                               60, d)),
            "head": {"w": given(d, N_CLS), "b": given(N_CLS)}}
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    freq = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], np.float32)
    e_freq = np.array([2, 1, 3], np.float32)
    w = given(B, N_CLS, std=1.0)
    return (_np(frozen), _np(head), l2p, dual, images, freq, e_freq, w)


def test_timm_converter_matches_jax():
    """``timm_vit_to_params``: the same tree leaf for leaf in fp32 (qkv,
    proj and fc transposed, the patch bias, identity ln_pre and proj), the
    same config and the head apart."""
    sd = timm_state_dict()
    jparams, jcfg, jhead = jconvert.timm_vit_to_params(sd)
    tparams, tcfg, thead = tconvert.timm_vit_to_params(
        {k: torch.tensor(v) for k, v in sd.items()}, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jflat, tflat = _flat(_np(jparams)), _flat(tparams)
    assert jflat.keys() == tflat.keys()
    for key, want in jflat.items():
        np.testing.assert_array_equal(tflat[key].numpy(), want,
                                      err_msg=str(key))
    for k in ("w", "b"):
        np.testing.assert_array_equal(thead[k].numpy(), np.asarray(jhead[k]))
    assert "patch_bias" in tparams["vision"]
    np.testing.assert_array_equal(tparams["vision"]["proj"].numpy(),
                                  np.eye(64, dtype=np.float32))


def test_seeded_timm_tower_has_the_jax_init_layout():
    """A seeded init of the timm variant (``vit_base_patch16_224``'s knobs on
    the tiny tower) has JAX's tree: the same leaves and shapes, ln_pre the
    identity the config skips."""
    from lifelong_clip_tpu.models.init import init_clip_params as jinit
    from lifelong_clip_tpu_torch.models.init import init_clip_params
    want = _flat(_np(jinit(jax.random.PRNGKey(0), JCFG)))
    got = _flat(init_clip_params(torch.Generator().manual_seed(0), TCFG,
                                 device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(got[("vision", "ln_pre", k)].numpy(),
                                      want[("vision", "ln_pre", k)])


POOL_CASES = {"diversified, train": (True, True),
              "diversified, eval": (True, False),
              "plain, train": (False, True), "ties": (True, True)}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_select_matches_jax(case):
    """The selection (indices, similarities, prompts, counts) equal to
    JAX's; "ties": duplicated keys and equal frequencies make equal
    scores, which ``jax.lax.top_k`` orders lowest index first."""
    diversified, train = POOL_CASES[case]
    rng = np.random.default_rng(5)
    key = rng.uniform(-1, 1, (8, 16)).astype(np.float32)
    prompts = rng.uniform(-1, 1, (8, 3, 16)).astype(np.float32)
    query = rng.standard_normal((5, 16)).astype(np.float32)
    freq = rng.integers(1, 6, 8).astype(np.float32)
    if case == "ties":
        key[[1, 4, 6]] = key[2]
        freq[[1, 2, 4, 6]] = 3.0
        query[:, :] = key[2] + 0.01 * query
    pool = {"key": key, "prompts": prompts}
    want = jvp.pool_select({k: jnp.asarray(v) for k, v in pool.items()},
                           jnp.asarray(query), jnp.asarray(freq), 4,
                           diversified=diversified, train=train)
    got = tvp.pool_select({k: torch.tensor(v) for k, v in pool.items()},
                          torch.tensor(query), torch.tensor(freq), 4,
                          diversified=diversified, train=train)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if case == "ties":   # the tie is real: four keys score alike
        assert float(got[2][[1, 2, 4, 6]].sum()) > 0


def _jax_road(fn, jimpl):
    if jimpl == "xla":
        return fn()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(jattention, "_DEFAULT_IMPL", "pallas")
        return fn()


_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _trees(method):
    s = _setup()
    return s[2] if method == "l2p" else s[3]


def _jax_forward_fn(method, jdt):
    frozen, _, _, _, _, freq, e_freq, _ = _setup()
    if method == "l2p":
        return functools.partial(jvp.l2p_forward, cfg=JCFG, train=True,
                                 frequency=jnp.asarray(freq),
                                 compute_dtype=jdt, **L2P_KW)
    return functools.partial(jvp.dualprompt_forward, cfg=JCFG, train=True,
                             e_frequency=jnp.asarray(e_freq),
                             compute_dtype=jdt, **DUAL_KW)


_JAX_CACHE = {}


@contextlib.contextmanager
def _prompted_inputs(mod):
    """Record the (token row, layer prompts, or the row again) of each
    ``mod.transformer`` call; the forward's second call is its prompted
    pass."""
    seen, orig = [], mod.transformer

    def recording(x, blocks, n_heads, **kw):
        seen.append((x, kw.get("layer_prompts", x)))
        return orig(x, blocks, n_heads, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "transformer", recording)
        yield seen


def _jax_forward(method, dtype, jimpl):
    """JAX's forward of ``method`` on the shared inputs: logits, mean
    similarity, counts, the prompted pass's inputs (``_prompted_inputs``)
    and the grads of sum(logits * w) + sim w.r.t. the trainable tree."""
    k = (method, dtype, jimpl)
    if k not in _JAX_CACHE:
        frozen, _, _, _, images, _, _, w = _setup()
        fwd = _jax_forward_fn(method, _DT[dtype][0])

        def loss(tr, frozen, images, w):
            with _prompted_inputs(jclip) as seen:
                logits, sim, counts = fwd(frozen, tr, images)
            return jnp.sum(logits * w) + sim, (logits, sim, counts,
                                               *seen[1])

        (_, aux), grads = _jax_road(lambda: jax.jit(jax.value_and_grad(
            loss, has_aux=True))(_trees(method), frozen,
                                 jnp.asarray(images), jnp.asarray(w)),
            jimpl)
        _JAX_CACHE[k] = tuple(np.asarray(a, np.float32) for a in aux), \
            _np(grads)
    return _JAX_CACHE[k]


def _torch_forward(method, dtype, impl, count_ops=None):
    frozen, _, _, _, images, freq, e_freq, w = _setup()
    tree = params_from_numpy(_trees(method))
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    kw = dict(train=True, compute_dtype=_DT[dtype][1], attn_impl=impl)
    if method == "l2p":
        logits, sim, counts = tvp.l2p_forward(
            params_from_numpy(frozen), tree, torch.tensor(images), TCFG,
            frequency=torch.tensor(freq), **L2P_KW, **kw)
    else:
        logits, sim, counts = tvp.dualprompt_forward(
            params_from_numpy(frozen), tree, torch.tensor(images), TCFG,
            e_frequency=torch.tensor(e_freq), **DUAL_KW, **kw)
    ((logits * torch.tensor(w)).sum() + sim).backward()
    return (logits.detach(), sim.detach(), counts), tree


# (port road, JAX road, compute dtype): fp32 on the plain roads; the fused
# road at the main path's dtype
ROADS = [("unfused", "xla", "float32"), ("fused", "pallas", "bfloat16")]


@pytest.mark.parametrize("method", ["l2p", "dualprompt"])
@pytest.mark.parametrize("impl,jimpl,dtype", ROADS)
def test_prompted_forward_matches_jax(method, impl, jimpl, dtype):
    """Logits, similarity, counts and the grads of every prompt-pool and
    head leaf. fp32 "unfused": summation order only. bf16 "fused":
    activations in bf16 between every op of six blocks and the kernels'
    bf16 roundings, so a flipped rounding anywhere moves the outputs by a
    few bf16 ulps of their scale, as ``tests/test_torch_clip.py``'s bf16
    tower allows."""
    (jl, jsim, jcounts, *_), jgrads = _jax_forward(method, dtype, jimpl)
    (logits, sim, counts), tree = _torch_forward(method, dtype, impl)
    tol = gtol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    scale = float(np.abs(jl).max())
    np.testing.assert_allclose(logits.float().numpy(), jl, rtol=tol,
                               atol=tol * scale)
    np.testing.assert_allclose(float(sim), float(jsim), rtol=tol, atol=tol)
    got = {k: v.grad for k, v in _flat(tree).items()}
    for key, ref in _flat(jgrads).items():
        if key == ("g_pool", "key"):   # a pool of one: its match is unused
            assert not np.any(ref) and got[key] is None
            continue
        assert float(np.abs(ref).max()) > 0, key
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=gtol,
                                   atol=gtol * float(np.abs(ref).max()),
                                   err_msg=str(key))


@pytest.mark.parametrize("method", ["l2p", "dualprompt"])
def test_prompted_pass_inputs_round_as_jax_in_bf16(method):
    """The bf16 tensors this slice builds before the prompted pass: L2P's
    row (CLS, the 25 selected prompt tokens + pos_embed[0] rounded once,
    the embedded patches) and DualPrompt's (L, B, 20, D) layer prompts
    with the same row. Both round the same fp32 values once, so > 99% of
    their elements are equal and the rest within one bf16 ulp. (The
    forward test above holds the outputs to 3e-2 of their scale: past one
    block, flipped roundings compound beyond this criterion.)"""
    with _prompted_inputs(tclip) as seen:
        _torch_forward(method, "bfloat16", "fused")
    wants = _jax_forward(method, "bfloat16", "pallas")[0][3:]
    for got, want in zip(seen[1], wants):
        got = got.detach().float().numpy()
        assert got.shape == want.shape
        ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
        assert np.all(np.abs(got - want) <= ulp)
        assert np.mean(got == want) > 0.99, np.mean(got == want)


def test_prompted_passes_run_the_fused_ops_on_every_block(monkeypatch):
    """On the fused road: L2P runs the plain block op in all layers of both
    passes (query and prompted: 2 x 6 here, 24 at ViT-B/16); DualPrompt
    the plain block op in its query pass and the prefix op in every layer
    of its prompted pass (P = 20), layer 5's slots all dead."""
    calls = []

    def counted(name, orig):
        def f(x, *a, **kw):
            calls.append((name, x.shape[1], a[0].shape[1] if name ==
                          "prefix" else None))
            return orig(x, *a, **kw)
        return f

    monkeypatch.setattr(tclip, "fused_ln_attention_block", counted(
        "block", tclip.fused_ln_attention_block))
    monkeypatch.setattr(tclip, "fused_prefix_attention_block", counted(
        "prefix", tclip.fused_prefix_attention_block))
    n_l = TCFG.vision_layers
    _torch_forward("l2p", "float32", "fused")
    assert calls == [("block", 17, None)] * n_l + [("block", 42, None)] * n_l
    calls.clear()
    _torch_forward("dualprompt", "float32", "fused")
    assert calls == [("block", 17, None)] * n_l + [("prefix", 17, 20)] * n_l


@pytest.mark.parametrize("use_mask", [True, False])
def test_mvp_head_scores_match_jax(use_mask):
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    y = np.array([0, 1, 2, 1, 4])
    cls_mask = rng.uniform(0.2, 1.8, (5, 6)).astype(np.float32)
    class_mask = np.array([0, 0, 0, 0, 0, -np.inf], np.float32)
    want = jmethods.mvp_head_scores(
        jnp.asarray(feat), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(y, jnp.int32), jnp.asarray(cls_mask),
        jnp.asarray(class_mask), use_mask, 0.5)
    got = tmethods.mvp_head_scores(
        torch.tensor(feat), torch.tensor(w), torch.tensor(b),
        torch.tensor(y), torch.tensor(cls_mask), torch.tensor(class_mask),
        use_mask, 0.5)
    for g, wnt in zip(got, want):   # closed form both sides, fp32
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# one train step of each trainer against the JAX trainer's jitted step
# ---------------------------------------------------------------------------

STEP_METHODS = {"l2p": "l2p", "dualprompt": "dualprompt",
                "mvp, every option": "mvp"}
LR = 1e-3


def _eval_like_jax(rng, images_u8):
    """JAX's train pipeline replaced by its eval preprocessing: the step
    test holds the trainers, not the augmentation draws (which come from
    different generators in the two packages)."""
    x = images_u8.astype(jnp.float32) / 255.0
    x = jpre.resize_bilinear(x, 32)
    return jpre.normalize(x, MEAN, STD).astype(jnp.float32)


@pytest.mark.parametrize("case", sorted(STEP_METHODS))
def test_train_step_matches_jax(case, tmp_path, monkeypatch):
    """One step of the port's trainer on the JAX trainer's weights, trees
    and counter (``"unfused"`` road, fp32, Adam as the scripts): the loss,
    the counter and every updated trainable leaf. Adam's first step moves
    each weight by ~lr whatever the grad's size, so an entry whose grad
    sits at rounding noise may move differently; nearly all agree far
    tighter."""
    method = STEP_METHODS[case]
    train = jsynthetic(n_classes=N_CLS, per_class=4, image_size=32, seed=0)
    train.mean, train.std = MEAN, STD
    jcfg = JTrainConfig(
        method=method, dataset="synthetic-8", model_name="debug-tiny",
        batchsize=B, test_batchsize=B, online_iter=1, lr=LR,
        opt_name="adam", memory_size=0, transforms=(), use_bf16=False,
        stream=JStream(n_tasks=E_POOL, n=50, m=10, seed=1),
        log_path=str(tmp_path / "jax"), seed=1)
    monkeypatch.setattr(jpre, "make_train_pipeline",
                        lambda *a, **kw: _eval_like_jax)
    jcls = {"l2p": jmethods.L2P, "dualprompt": jmethods.DualPrompt,
            "mvp": jmethods.MVP}[method]
    tcls = get_method(method)
    if method == "mvp":
        flags = dict(use_mask=True, use_contrastiv=True, use_afs=True,
                     use_gsf=True)
        jcls = type(jcls.__name__, (jcls,), flags)
        tcls = type(tcls.__name__, (tcls,), flags)
    jtr = jcls(jcfg, train_dataset=train, test_dataset=train)
    tcfg = TrainConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name not in ("stream", "peft")},
                       stream=StreamConfig(n_tasks=E_POOL, n=50, m=10,
                                           seed=1), device="cpu")
    tcfg = dataclasses.replace(tcfg, log_path=str(tmp_path / "torch"))
    tcls = type(tcls.__name__, (tcls,), {"attn_impl": "unfused"})
    ttr = tcls(tcfg, train_dataset=make_synthetic(
        n_classes=N_CLS, per_class=4, image_size=32, seed=0),
        test_dataset=None)

    # the same weights, trees (random heads and masks, so every leaf gets
    # a grad) and counter on both sides
    rng = np.random.default_rng(7)
    jtrain = jax.tree.map(
        lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(a.shape)
                   ).astype(np.float32), _np(jtr.state.trainable))
    jtr.state = jtr.state.replace(
        trainable=jax.tree.map(jnp.asarray, jtrain),
        opt_state=jtr.tx.init(jax.tree.map(jnp.asarray, jtrain)))
    ttr.state.frozen = cast_towers(params_from_numpy(_np(jtr.params)),
                                   torch.float32)
    start = _flat(params_from_numpy(jtrain))
    live = _flat(ttr.state.trainable)
    assert live.keys() == start.keys()
    with torch.no_grad():
        for k, p in live.items():
            p.copy_(start[k])
    ttr.state.reset_optimizer()
    jcounter = {"l2p": "frequency", "dualprompt": "e_frequency",
                "mvp": "count"}[method]
    counter = np.asarray(getattr(jtr, jcounter)) + np.arange(
        len(getattr(jtr, jcounter)), dtype=np.float32)
    ttr.counter = torch.tensor(counter)
    eval_pipe = tpre.make_eval_pipeline(32, MEAN, STD,
                                        out_dtype=torch.float32)
    ttr._pipeline = lambda gen, x: eval_pipe(x)

    images = np.random.default_rng(8).integers(0, 256, (B, 32, 32, 3),
                                                dtype=np.uint8)
    labels = np.array([0, 3, 1, 2])
    mask = np.zeros(N_CLS, np.float32)
    mask[6:] = -np.inf
    jstate, jcount, jm = jtr._step(
        jtr.state, {"images": jnp.asarray(images),
                    "labels": jnp.asarray(labels, jnp.int32),
                    "mask": jnp.asarray(mask)}, jnp.asarray(counter))
    m = ttr.train_step({"images": torch.tensor(images),
                        "labels": torch.tensor(labels),
                        "mask": torch.tensor(mask)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    np.testing.assert_array_equal(ttr.counter.numpy(), np.asarray(jcount))
    assert float(ttr.counter.sum()) > counter.sum()
    want = _flat(_np(jstate.trainable))
    for k, got in _flat(ttr.state.trainable).items():
        got, w0 = got.detach().numpy(), start[k].numpy()
        diff = np.abs(got - want[k])
        assert diff.max() <= 2 * LR * (1 + 1e-3), (k, diff.max())
        assert np.mean(diff <= 1e-3 * LR) > 0.99, (k, np.mean(
            diff <= 1e-3 * LR))
        # a leaf JAX's step moves, the port's moves too
        if np.abs(want[k] - w0).max() > 0:
            assert np.abs(got - w0).max() > 0.5 * LR, k


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["l2p", "dualprompt", "mvp"])
def test_cli_cpu_run_writes_result(method, tmp_path):
    argv = ["--method", method, "--model_name", "debug-tiny", "--dataset",
            "synthetic-10x8", "--n_tasks", "2", "--batchsize", "8",
            "--test_batchsize", "8", "--eval_period", "32", "--device",
            "cpu", "--transforms", "--online_iter", "2", "--opt_name",
            "adam", "--lr", "5e-3", "--log_path", str(tmp_path)]
    if method == "mvp":
        argv += ["--use_mask", "--use_contrastiv", "--use_afs", "--use_gsf"]
    out = cli.main(argv)
    assert set(out) == {"A_auc", "A_avg", "A_last", "F_last"}
    found = [os.path.join(d, "result.txt") for d, _, fs in os.walk(tmp_path)
             if "result.txt" in fs]
    assert len(found) == 1


@pytest.mark.parametrize("method", ["l2p", "dualprompt", "mvp",
                                    "adapter-clip-proto_prompt",
                                    "template"])
def test_new_methods_run_on_cuda_by_default(method, tmp_path):
    """Without ``--device`` the trainers ask for the GPU, and raise where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="(?i)cuda|gpu"):
        cli.main(["--method", method, "--model_name", "debug-tiny",
                  "--dataset", "synthetic-10x8", "--n_tasks", "2",
                  "--log_path", str(tmp_path)])


def test_l2p_resume_is_bitwise(tmp_path):
    """Task 0 with a checkpoint after it, restored into a fresh trainer:
    task 1's losses, every trainable tensor and the selection frequency
    counter equal the uninterrupted run's bit for bit."""
    from lifelong_clip_tpu_torch.utils.checkpoints import restore_trainer
    from lifelong_clip_tpu_torch.utils.stream import iter_batches
    cfg = TrainConfig(method="l2p", dataset="synthetic-8",
                      model_name="debug-tiny", batchsize=8, test_batchsize=8,
                      online_iter=2, lr=5e-3, opt_name="adam",
                      eval_period=16, memory_size=0,
                      stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1),
                      transforms=("autoaug",), use_bf16=False,
                      log_path=str(tmp_path / "logs"),
                      ckpt_dir=str(tmp_path / "ck"), device="cpu")
    train = make_synthetic(n_classes=8, per_class=6, image_size=32, seed=0)
    test = make_synthetic(n_classes=8, per_class=2, image_size=32, seed=0,
                          train=False)

    def drive(tr, task_id):
        losses = []
        for idx in iter_batches(tr.stream.task_indices[task_id], 8):
            images, labels = tr.train_dataset.gather(idx)
            tr.vocab.expose(labels)
            losses.append(float(tr.online_step(images, labels, idx)["loss"]))
        tr._task_end_eval(task_id)
        return losses

    cls = get_method("l2p")
    tr = cls(cfg, train_dataset=train, test_dataset=test)
    drive(tr, 0)
    tr._maybe_checkpoint(0)
    want = drive(tr, 1)
    tr2 = cls(cfg, train_dataset=train, test_dataset=test)
    restore_trainer(tr2, cfg.ckpt_dir)
    assert torch.equal(tr2.checkpoint_extra()["l2p"]["frequency"],
                       torch.load(os.path.join(cfg.ckpt_dir,
                                               "checkpoint.pt"),
                                  weights_only=False)["extra"]["l2p"][
                                      "frequency"])
    got = drive(tr2, 1)
    assert got == want
    assert torch.equal(tr.counter, tr2.counter)
    assert float(tr.counter.sum()) > tr.pool_size
    for (k, a), b in zip(_flat(tr.state.trainable).items(),
                         _flat(tr2.state.trainable).values()):
        assert torch.equal(a, b), k
