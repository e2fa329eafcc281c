"""adapter-clip and moe-clip: the bottleneck adapter, the noisy top-k gates,
the dense mixture of adapters and their blocks in both towers, and one
train step of each method, against the JAX package's on the same weights
and inputs. The MoE gate noise is JAX's own: the port takes the N(0, 1)
draws as a tensor, and the tests feed it the draws JAX makes from its key.

Weights come from the JAX init through the bridge, with the zero-initialized
leaves (adapter up-projections, biases, routers) given values so that every
term and every grad is seen; inputs from numpy seeds. The port's "fused"
road (the kernel op's plain version on the CPU) is held against JAX's
"pallas" road in interpret mode, and "unfused" against "xla".
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
from lifelong_clip_tpu.methods import engine as jengine
from lifelong_clip_tpu.models import clip as jclip
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.models.peft import init_peft as jinit_peft
from lifelong_clip_tpu.models.peft import init_tower_peft
from lifelong_clip_tpu.ops import moe as jmoe
from lifelong_clip_tpu.utils.train_utils import make_optimizer as jmake_opt
from lifelong_clip_tpu_torch.bridge import params_from_numpy, params_to_numpy
from lifelong_clip_tpu_torch.config import PEFTConfig
from lifelong_clip_tpu_torch.methods import engine as tengine
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.models.peft import init_peft
from lifelong_clip_tpu_torch.ops import moe as tmoe
from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer
from test_engine import TINY as JTINY
from test_torch_clip import TINY as TTINY

ROUTES = [("fused", "pallas"), ("unfused", "xla")]
# three experts, two selected: the top-k mask drops one expert a sample
PEFT_KW = dict(adapter_dim=8, adapter_scale=0.1, moe_experts=3, moe_top_k=2)
MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.26, 0.27)
LR = 1e-3


def _jax(fn, impl):
    if impl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return fn()
    return fn()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _given_values(tree, seed):
    """The tree with each all-zero leaf (up-projections, biases, router and
    noise weights) drawn at std 0.2 instead."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(treedef, [
        0.2 * jax.random.normal(k, a.shape) if not np.any(np.asarray(a))
        else a for k, a in zip(keys, leaves)])


def _layer_noise(key, layers, rows, experts):
    """The gate noise JAX's ``transformer`` draws from ``key``: one key a
    layer (``jax.random.split(key, L)``), (rows, E) N(0, 1) draws each."""
    return np.stack([np.asarray(jax.random.normal(k, (rows, experts)))
                     for k in jax.random.split(key, layers)])


@pytest.fixture(scope="module")
def setup():
    frozen = init_clip_params(jax.random.PRNGKey(0), JTINY)
    trees = {}
    for method in ("adapter", "moe"):
        jcfg = JPEFTConfig(method=method, encoder="both", **PEFT_KW)
        trees[method] = _given_values(
            jinit_peft(jax.random.PRNGKey(1), JTINY, jcfg), 7)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((3, JTINY.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:6] = rng.integers(1000, 40000, (3, 5))
    tokens[np.arange(3), [6, 4, 7]] = 49407
    return frozen, params_from_numpy(_np(frozen)), trees, images, tokens


def _cfgs(method, encoder="both"):
    return (JPEFTConfig(method=method, encoder=encoder, **PEFT_KW),
            PEFTConfig(method=method, encoder=encoder, **PEFT_KW))


# ---------------------------------------------------------------------------
# trees and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["adapter", "moe"])
def test_init_layouts_match_jax_and_bridge_both_ways(method):
    """The port's init gives JAX's layout (adapter ``w_down`` (L, D, k) ...;
    MoE ``router``/``w_noise`` (L, D, E) zeros, experts stacked on axis 1);
    the bridge carries JAX's nested trees to tensors and back unchanged."""
    jcfg, tcfg = _cfgs(method)
    jtree = _np(jinit_peft(jax.random.PRNGKey(1), JTINY, jcfg))
    ttree = init_peft(torch.Generator().manual_seed(1), TTINY, tcfg,
                      device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = jax.tree_util.tree_flatten_with_path(params_to_numpy(ttree))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        # the same leaves start at zero (up-projections, biases, routers)
        assert np.any(a) == np.any(b), path
    if method == "moe":
        e = PEFT_KW["moe_experts"]
        assert ttree["vision"]["moe"]["experts"]["w_down"].shape == (
            TTINY.vision_layers, e, TTINY.vision_width, PEFT_KW["adapter_dim"])
        assert ttree["text"]["moe"]["router"].shape == (
            TTINY.text_layers, TTINY.text_width, e)
    back = params_to_numpy(params_from_numpy(jtree))
    for (path, a), (_, b) in zip(jl, jax.tree_util.tree_flatten_with_path(
            back)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adapter_apply_matches_jax(setup, dtype):
    """``_adapter_apply``: the biases added and the scale applied in fp32
    before the one rounding. In bf16 both sides round the same fp32 value
    once, so they agree exactly wherever the fp32 sums (in another order)
    fall on the same side of a rounding boundary, and by one bf16 ulp
    elsewhere; rounding twice would miss on a large share."""
    p = jax.tree.map(lambda a: a[0], setup[2]["adapter"]["vision"]["adapter"])
    y = np.random.default_rng(1).standard_normal((3, 17, 64)).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jclip._adapter_apply(
        jnp.asarray(y, jdt), jax.tree.map(lambda a: a.astype(jdt), p),
        0.1).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = tclip._adapter_apply(
        torch.tensor(y).to(tdt),
        {k: v.to(tdt) for k, v in params_from_numpy(_np(p)).items()},
        0.1).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        return
    ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got == want) > 0.99, np.mean(got == want)


@pytest.mark.parametrize("case", ["jax noise", "clean", "ties"])
def test_noisy_top_k_gates_match_jax(case):
    """Gates and importance on JAX's own noise draws, on clean logits, and
    with tied logits (a zero router, and two equal router columns with
    top_k = 1): every logit >= the k-th largest is kept, as in JAX."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((6, 16)).astype(np.float32)
    router = rng.standard_normal((16, 4)).astype(np.float32)
    w_noise = 0.3 * rng.standard_normal((16, 4)).astype(np.float32)
    top_k, noise, key = 2, None, None
    if case == "jax noise":
        key = jax.random.PRNGKey(11)
        noise = np.asarray(jax.random.normal(key, (6, 4)))
    if case == "ties":
        router[:, 1] = router[:, 0]
        top_k = 1
    want = jmoe.noisy_top_k_gates(jnp.asarray(feats), jnp.asarray(router),
                                  jnp.asarray(w_noise), top_k, rng=key)
    got = tmoe.noisy_top_k_gates(
        torch.tensor(feats), torch.tensor(router), torch.tensor(w_noise),
        top_k, noise=None if noise is None else torch.tensor(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    kept = (got[0] > 0).sum(-1)
    if case == "ties":
        # expert 0 and 1 tie for the top: both kept, at half each
        tied = feats @ router[:, 0] >= (feats @ router).max(-1) - 1e-6
        assert (kept[torch.tensor(tied)] == 2).all()
    else:
        assert (kept == 2).all()
    zero = jmoe.noisy_top_k_gates(jnp.asarray(feats), jnp.zeros((16, 3)),
                                  jnp.zeros((16, 3)), 1)[0]
    tzero = tmoe.noisy_top_k_gates(torch.tensor(feats), torch.zeros(16, 3),
                                   torch.zeros(16, 3), 1)[0]
    np.testing.assert_allclose(tzero.numpy(), np.asarray(zero), rtol=0,
                               atol=0)
    assert torch.equal(tzero, torch.full((6, 3), 1 / 3))


@pytest.mark.parametrize("x", [[3.0], [1.0, 2.0, 3.0, 7.0], [0.0, 0.0],
                               [0.5, 0.5, 0.5]])
def test_cv_squared_matches_jax(x):
    """The population variance over the squared mean (``jnp.var``, not
    torch's unbiased default); 0 for a single entry."""
    want = float(jmoe.cv_squared(jnp.asarray(x, jnp.float32)))
    got = tmoe.cv_squared(torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    if len(x) == 1:
        assert float(got) == 0.0


def _jax_moe_bf16(x, p, cfg, *, rng):
    """JAX ``moe_adapter_apply``'s arithmetic in bf16, one expert at a
    time: XLA's CPU runtime has no bf16 x bf16 -> fp32 batched dot, so the
    function itself cannot run on this backend in bf16. Its gates, plain
    dots with fp32 accumulation, fp32 biases and scale, the hidden rounded
    to bf16, the fp32 gated sum and one rounding at the end."""
    gates, _ = jmoe.noisy_top_k_gates(x[:, 0], p["router"], p["w_noise"],
                                      cfg.moe_top_k, rng=rng)
    ex = p["experts"]
    out = 0.0
    for e in range(gates.shape[-1]):
        h = jnp.einsum("btd,dk->btk", x, ex["w_down"][e],
                       preferred_element_type=jnp.float32) + ex["b_down"][e]
        h = jax.nn.relu(h).astype(x.dtype)
        y = jnp.einsum("btk,kd->btd", h, ex["w_up"][e],
                       preferred_element_type=jnp.float32) + ex["b_up"][e]
        out = out + gates[:, e, None, None] * (cfg.adapter_scale * y)
    return out.astype(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_adapter_apply_matches_jax(setup, dtype):
    """The gated combine of all experts on JAX's noise: in fp32 against
    ``moe_adapter_apply`` to summation order; in bf16 against its
    arithmetic (``_jax_moe_bf16``), with the expert hidden and the output
    each rounded once: a flip of the hidden's rounding moves the output by
    a small share of its ulp, so nearly all elements agree exactly."""
    jcfg, tcfg = _cfgs("moe")
    p = jax.tree.map(lambda a: a[0], setup[2]["moe"]["vision"]["moe"])
    x = np.random.default_rng(3).standard_normal((4, 9, 64)).astype(
        np.float32)
    key = jax.random.PRNGKey(12)
    noise = np.asarray(jax.random.normal(key, (4, PEFT_KW["moe_experts"])))
    jdt = jnp.dtype(dtype)
    ref = jmoe.moe_adapter_apply if dtype == "float32" else _jax_moe_bf16
    want = np.asarray(jax.jit(lambda x, p, key: ref(x, p, jcfg, rng=key))(
        jnp.asarray(x, jdt), jax.tree.map(lambda a: a.astype(jdt), p),
        key).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tp = params_from_numpy(_np(p), dtype=tdt)
    got = tmoe.moe_adapter_apply(torch.tensor(x).to(tdt), tp, tcfg,
                                 noise=torch.tensor(noise)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got == want) > 0.99, np.mean(got == want)


# ---------------------------------------------------------------------------
# the blocks, in each tower and on each road
# ---------------------------------------------------------------------------

_JAX_TOWERS = {}


def _jax_tower(setup, method, tower, jimpl):
    """JAX's fp32 tower output and its grads w.r.t. the PEFT tree
    (base_grads=False), MoE gates on the noise from key 13; and with MoE
    the clean-gate (eval) output. One jitted run per case."""
    k = (method, tower, jimpl)
    if k not in _JAX_TOWERS:
        frozen, _, trees, images, tokens = setup
        jcfg, _ = _cfgs(method)
        key = jax.random.PRNGKey(13) if method == "moe" else None

        def run(p, frozen, inp, key):
            enc = jclip.encode_image if tower == "vision" else \
                jclip.encode_text
            return enc(frozen, inp, JTINY, peft_cfg=jcfg, peft=p,
                       compute_dtype=jnp.float32, attn_impl=jimpl,
                       base_grads=False, moe_rng=key)

        def loss(p, frozen, inp, key, w):
            out = run(p, frozen, inp, key)
            return jnp.sum(out * w), out

        inp = jnp.asarray(images if tower == "vision" else tokens)
        w = jnp.asarray(np.random.default_rng(4).standard_normal(
            (inp.shape[0], JTINY.embed_dim)).astype(np.float32))
        (_, out), grads = _jax(lambda: jax.jit(jax.value_and_grad(
            loss, has_aux=True))(trees[method][tower], frozen, inp, key, w),
            jimpl)
        clean = None
        if method == "moe":
            clean = np.asarray(_jax(lambda: jax.jit(run)(
                trees[method][tower], frozen, inp, None), jimpl))
        _JAX_TOWERS[k] = (np.asarray(out), _np(grads), clean, np.asarray(w))
    return _JAX_TOWERS[k]


@pytest.mark.parametrize("method", ["adapter", "moe"])
@pytest.mark.parametrize("tower", ["vision", "text"])
@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_peft_tower_matches_jax(setup, method, tower, impl, jimpl):
    """``encode_image`` / ``encode_text`` with the adapter (on the fused
    road it reads the attention delta y - x, on the general road the
    attention output) or the MoE (gated on x[:, 0] of the MLP half's input;
    noise from JAX's per-layer keys): the output and every grad of the PEFT
    tree; with MoE also the clean-gate output."""
    _, tfrozen, trees, images, tokens = setup
    want, jgrads, clean, w = _jax_tower(setup, method, tower, jimpl)
    _, tcfg = _cfgs(method)
    tree = params_from_numpy(_np(trees[method][tower]))
    leaves = tengine.tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    n_l = JTINY.vision_layers if tower == "vision" else JTINY.text_layers
    rows = images.shape[0] if tower == "vision" else tokens.shape[0]
    noise = None
    if method == "moe":
        noise = torch.tensor(_layer_noise(jax.random.PRNGKey(13), n_l, rows,
                                          PEFT_KW["moe_experts"]))
    enc = tclip.encode_image if tower == "vision" else tclip.encode_text
    inp = torch.tensor(images if tower == "vision" else tokens)

    def run(noise):
        return enc(tfrozen, inp, TTINY, peft_cfg=tcfg, peft=tree,
                   compute_dtype=torch.float32, attn_impl=impl,
                   base_grads=False, moe_noise=noise)

    out = run(noise)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), leaves)
    # as tests/test_torch_clip.py: "fused" rounds qkv, p and ctx (and the
    # backward dqkv/ds) to bf16 where the kernel does, so a flipped
    # rounding is what the looser bounds allow
    tol, gtol = (2e-3, 1e-2) if impl == "fused" else (1e-4, 1e-4)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=tol,
                               atol=tol * scale)
    for (path, ref), got in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0], grads):
        assert float(np.abs(ref).max()) > 0, path
        np.testing.assert_allclose(got.numpy(), ref, rtol=gtol,
                                   atol=gtol * float(np.abs(ref).max()),
                                   err_msg=str(path))
    if method == "moe":
        with torch.no_grad():
            got_clean = run(None).numpy()
        np.testing.assert_allclose(got_clean, clean, rtol=tol,
                                   atol=tol * scale)
        # the noise moves the gates: the two outputs differ
        assert np.abs(clean - want).max() > 10 * tol * scale


# ---------------------------------------------------------------------------
# one train step of each method
# ---------------------------------------------------------------------------

# one layer a tower, as tests/test_torch_engine.py
SCFG = dataclasses.replace(JTINY, vision_layers=1, text_layers=1)
STCFG = dataclasses.replace(TTINY, vision_layers=1, text_layers=1)
STEPS = {"adapter-clip, image tower, cached text": ("adapter", "image"),
         "moe-clip, both towers": ("moe", "both")}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_matches_jax(case, monkeypatch):
    """``make_train_step`` (augment=False, AdamW, CE on probs) on the fused
    road: adapter-clip on the image tower against cached text features,
    moe-clip on both towers with the gate noise of both towers replayed
    from the JAX step's key. The loss, every grad of the PEFT tree and the
    updated tree. AdamW's first step moves each weight by ~lr whatever the
    grad's size, so a grad component near zero whose sign the bf16
    roundings flip moves by up to 2 lr; most entries agree far tighter."""
    method, encoder = STEPS[case]
    cached = encoder == "image"
    jcfg, tcfg = _cfgs(method, encoder)
    frozen = init_clip_params(jax.random.PRNGKey(0), SCFG)
    peft = {"vision": init_tower_peft(jax.random.PRNGKey(1),
                                      SCFG.vision_layers, SCFG.vision_width,
                                      jcfg),
            "text": None if cached else init_tower_peft(
                jax.random.PRNGKey(2), SCFG.text_layers, SCFG.text_width,
                jcfg)}
    peft = _given_values(peft, 8)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    tokens = np.zeros((6, SCFG.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:5] = rng.integers(1000, 40000, (6, 4))
    tokens[:, 5] = 49407
    mask = np.zeros(6, np.float32)
    mask[5] = -np.inf
    labels = np.array([0, 3, 1, 4], np.int32)

    tx = jmake_opt("adamw", LR)
    key = jax.random.PRNGKey(4)
    state = jengine.TrainState.create(trainable=peft, frozen=frozen, tx=tx,
                                      rng=key)
    step = jengine.make_train_step(
        SCFG, jcfg, tx, image_size=32, mean=MEAN, std=STD, augment=False,
        cached_text=cached, compute_dtype=jnp.float32, attn_impl="pallas",
        loss_fn=jengine.ce_on_probs_loss, donate=False)
    feats = None
    if cached:
        feats = _jax(lambda: jengine.make_text_feature_fn(
            SCFG, jcfg, compute_dtype=jnp.float32, attn_impl="pallas")(
                frozen, peft, jnp.asarray(tokens)), "pallas")
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels),
             "tokens": feats if cached else jnp.asarray(tokens),
             "mask": jnp.asarray(mask)}
    new_state, m = _jax(lambda: step(state, batch), "pallas")

    # the step's objective again, for its grads: the same split of the
    # state key gives the MoE key (engine.py:264)
    moe_key = jax.random.split(key, 4)[3]
    fwd = jengine.peft_forward_cached_text if cached else \
        jengine.peft_forward

    def objective(trainable):
        kw = {"moe_rng": moe_key} if method == "moe" else {}
        logits, _, _ = fwd(frozen, trainable,
                           jnp.asarray(images, jnp.float32), batch["tokens"],
                           SCFG, jcfg, jnp.float32, "pallas", **kw)
        return jengine.ce_on_probs_loss(logits + batch["mask"][None, :],
                                        batch["labels"])

    jgrads = _np(_jax(lambda: jax.jit(jax.grad(objective))(peft), "pallas"))

    replay = []
    if method == "moe":
        k_v, k_t = jax.random.split(moe_key)
        e = PEFT_KW["moe_experts"]
        replay = [_layer_noise(k_v, SCFG.vision_layers, 4, e),
                  _layer_noise(k_t, SCFG.text_layers, 6, e)]

    def replayed(gen, shape, device):
        want = replay.pop(0)
        assert tuple(shape) == want.shape
        return torch.tensor(want, device=device)

    monkeypatch.setattr(tmoe, "draw_gate_noise", replayed)
    tstate = tengine.TrainState(
        trainable=params_from_numpy(_np(peft)),
        frozen=params_from_numpy(_np(frozen)),
        make_opt=lambda leaves: make_optimizer("adamw", leaves, LR),
        gen=torch.Generator().manual_seed(0))
    tstep = tengine.make_train_step(
        STCFG, tcfg, image_size=32, mean=MEAN, std=STD, augment=False,
        cached_text=cached, compute_dtype=torch.float32, attn_impl="fused",
        loss_fn=tengine.ce_on_probs_loss)
    tbatch = {"images": torch.tensor(images),
              "labels": torch.tensor(labels, dtype=torch.int64),
              "tokens": (torch.tensor(np.asarray(feats)) if cached
                         else torch.tensor(tokens, dtype=torch.int64)),
              "mask": torch.tensor(mask)}
    out = tstep(tstate, tbatch)
    assert replay == []     # every tower's noise drawn, in order
    np.testing.assert_allclose(float(out["loss"]), float(m["loss"]),
                               rtol=1e-4)

    towers = ["vision"] if cached else ["vision", "text"]
    for tower in towers:
        jl = jax.tree_util.tree_flatten_with_path(jgrads[tower])[0]
        tl = tengine.tree_leaves(tstate.trainable[tower])
        new = jax.tree.leaves(new_state.trainable[tower])
        old = jax.tree.leaves(peft[tower])
        assert len(jl) == len(tl) == len(new)
        for (path, g), p, want, before in zip(jl, tl, new, old):
            name = f"{tower} {jax.tree_util.keystr(path)}"
            assert float(np.abs(g).max()) > 0, name
            np.testing.assert_allclose(
                p.grad.numpy(), g, rtol=1e-2,
                atol=1e-2 * float(np.abs(g).max()), err_msg=name)
            got, want = p.detach().numpy(), np.asarray(want)
            assert not np.array_equal(want, np.asarray(before)), name
            np.testing.assert_allclose(got, want, rtol=0, atol=2.01 * LR,
                                       err_msg=name)
            assert np.mean(np.abs(got - want) <= 1e-2 * LR) > 0.95, name
