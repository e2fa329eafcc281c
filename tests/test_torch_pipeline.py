"""The port's depth pipeline (``parallel/pipeline.py``,
``parallel/mesh.py:shard_params_pp``, ``encode_image(depth_runner=...)``)
against JAX's (``tests/test_pipeline.py``'s cases, JAX's 8 virtual
devices): ``gloo`` CPU ranks of one pool of 8 for the file
(``tests/torch_mesh_ranks.py``), fp32, the weights bridged from JAX's
``init_clip_params`` / ``build_peft`` at JAX's keys.

Tolerances, JAX's own: the pipelined tower's output at atol 2e-5 / rtol
1e-5 (``test_pipeline.py:55``); the train step's loss at rtol 1e-5 and the
updated LoRA leaves at atol 1e-5 / rtol 1e-4 (``:99-107``; the
microbatches' grad sums reorder the adds); the one-stage fallback at atol
1e-6 (``:122``). Remat and ``depth_runner=transformer`` reschedule nothing
the CPU computes: bit for bit.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks as R  # noqa: E402

from lifelong_clip_tpu.config import CLIPConfig as JCLIPConfig  # noqa: E402
from lifelong_clip_tpu.config import PEFTConfig as JPEFT  # noqa: E402
from lifelong_clip_tpu.methods.engine import TrainState as JState  # noqa
from lifelong_clip_tpu.methods.engine import \
    make_train_step as jmake_step  # noqa: E402
from lifelong_clip_tpu.models import build_peft as jbuild_peft  # noqa
from lifelong_clip_tpu.models import clip as jclip  # noqa: E402
from lifelong_clip_tpu.models.init import init_clip_params  # noqa: E402
from lifelong_clip_tpu.ops import preprocess as jpre  # noqa: E402
from lifelong_clip_tpu.parallel import mesh as jmesh  # noqa: E402
from lifelong_clip_tpu.parallel import pipeline as jpipe  # noqa: E402
from lifelong_clip_tpu.utils.train_utils import \
    make_optimizer as jmake_opt  # noqa: E402
from lifelong_clip_tpu_torch.bridge import params_from_numpy  # noqa: E402
from lifelong_clip_tpu_torch.config import CLIPConfig, PEFTConfig  # noqa
from lifelong_clip_tpu_torch.models import build_peft  # noqa: E402
from lifelong_clip_tpu_torch.models import clip as tclip  # noqa: E402
from lifelong_clip_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from lifelong_clip_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

# tests/test_pipeline.py:25-28: 4 layers, so 4 stages hold one layer each
TINY4_KW = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=128,
                vision_layers=4, vision_heads=4, context_length=16,
                vocab_size=512, text_width=128, text_heads=4, text_layers=2)
TINY4 = JCLIPConfig(**TINY4_KW)
HEADS = TINY4.vision_heads


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = R.RankPool(8, str(tmp_path_factory.mktemp("pg")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_params():
    """JAX's CLIP tree at key 0 and its vision blocks, as numpy."""
    params = init_clip_params(jax.random.PRNGKey(0), TINY4)
    return jax.tree.map(np.asarray, params)


def _x(b):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1), (b, 17, 128),
                                        jnp.float32))


@pytest.mark.parametrize("shape,micro", [((2, 4), 2), ((4, 2), 2)])
def test_pipelined_transformer_matches_jax(pool, jax_params, shape, micro):
    """(a) JAX's ``test_pipelined_transformer_matches_scan``: every rank's
    gathered output equals JAX's ``pipelined_transformer`` on its 8-device
    mesh and JAX's ``transformer``."""
    blocks = jax_params["vision"]["blocks"]
    x = _x(8)
    ref = np.asarray(jclip.transformer(jnp.asarray(x), blocks, HEADS,
                                       attn_impl="xla"))
    jm = jmesh.make_mesh(shape)
    blocks_s = jmesh.shard_params_pp({"vision": {"blocks": blocks}},
                                     jm)["vision"]["blocks"]
    jgot = np.asarray(jax.jit(lambda a, b: jpipe.pipelined_transformer(
        a, b, HEADS, mesh=jm, n_microbatches=micro, attn_impl="xla"))(
        jnp.asarray(x), blocks_s))
    for got in pool.run(R.pp_transformer, 8, shape, micro, x, blocks, HEADS):
        np.testing.assert_allclose(got["out"], jgot, atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(got["out"], ref, atol=2e-5, rtol=1e-5)


def _batch(b, n_cls=8, seed=0):
    """tests/test_pipeline.py:31-42's batch, as numpy, but with a token row
    of its own for each class: JAX's rows are all the same (511 at 0, 510
    at 3), so every class gets the same text feature, the logits' grads sum
    to zero through it, and the step moves the leaves by rounding noise
    alone (by ~3e-5 at lr 1e-3), which two implementations cannot share.
    Here the row pools at its largest id, 510 at 3, after a class token."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((n_cls, TINY4.context_length), np.int32)
    tokens[:, 0] = 509
    tokens[:, 1] = 100 + np.arange(n_cls)
    tokens[:, 3] = 510
    return {"images": rng.integers(0, 255, (b, 32, 32, 3), np.uint8),
            "labels": rng.integers(0, n_cls, (b,)).astype(np.int32),
            "tokens": tokens, "mask": np.zeros((n_cls,), np.float32)}


def _jax_eval_like(rng, images_u8, mean=(0.5,) * 3, std=(0.25,) * 3):
    """The eval preprocessing (``torch_mesh_ranks.same_pixels``'s)."""
    x = images_u8.astype(jnp.float32) / 255.0
    x = jpre.resize_bilinear(x, TINY4.image_size)
    return jpre.normalize(x, mean, std).astype(jnp.float32)


def test_pp_train_step_matches_jax_and_one_process(pool, jax_params,
                                                   monkeypatch):
    """(b) JAX's ``test_pp_train_step_matches_single_device`` at dp 2 x pp
    4 (image LoRA r = 4, AdamW 1e-3, bs 16, 2 microbatches, augmentation
    replaced by the eval preprocessing on both sides): the loss and the
    gathered ``a_in`` / ``b_in`` after the step equal JAX's pipelined step
    and the port's own 1-process step; the stages of a data row share
    their per-row draws (``Mesh.fold_gen``)."""
    monkeypatch.setattr(jpre, "make_train_pipeline",
                        lambda *a, **kw: _jax_eval_like)
    peft_cfg = JPEFT(method="lora", encoder="image", lora_r=4)
    params = jax.tree.map(jnp.asarray, jax_params)
    peft = jbuild_peft(jax.random.PRNGKey(1), TINY4, peft_cfg)
    peft_np = jax.tree.map(np.asarray, peft)
    tx = jmake_opt("adamw", 1e-3)
    batch = _batch(16)
    mesh = jmesh.make_mesh((2, 4))
    state = JState.create(trainable=jmesh.shard_params_pp(
        peft, mesh, match=("vision",)), frozen=jmesh.shard_params_pp(
        params, mesh), tx=tx, rng=jax.random.PRNGKey(2))
    fwd = jpipe.make_pp_forward(TINY4, peft_cfg, mesh, n_microbatches=2,
                                compute_dtype=jnp.float32, attn_impl="xla")
    step = jmake_step(TINY4, peft_cfg, tx, image_size=32, mean=(0.5,) * 3,
                      std=(0.25,) * 3, compute_dtype=jnp.float32,
                      forward_fn=fwd, donate=False)
    sharded = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P("data") if k in ("images", "labels") else P()))
        for k, v in batch.items()}
    new, metrics = step(state, sharded)
    jloss = float(metrics["loss"])
    jlora = {k: np.asarray(v) for k, v in
             new.trainable["vision"]["lora"].items()}

    one = R.pp_train_step(0, 1, (1, 1), 2, TINY4_KW, jax_params, peft_np,
                          batch)
    np.testing.assert_allclose(one["loss"], jloss, rtol=1e-5)
    ranks = pool.run(R.pp_train_step, 8, (2, 4), 2, TINY4_KW, jax_params,
                     peft_np, batch)
    # every stage of a data row draws its rows' augmentation alike; the
    # rows' draws differ
    draws = [r["draw"] for r in ranks]
    assert draws[:4] == [draws[0]] * 4 and draws[4:] == [draws[4]] * 4
    assert draws[0] != draws[4]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        for k in ("a_in", "b_in"):
            key = ("vision", "lora", k)
            np.testing.assert_allclose(got["trainable"][key], jlora[k],
                                       atol=1e-5, rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(got["trainable"][key],
                                       one["trainable"][key], atol=1e-5,
                                       rtol=1e-4, err_msg=k)


def test_pp_single_stage_falls_back(pool, jax_params):
    """(c) JAX's ``test_pp_single_stage_falls_back``: a model axis of 1 is
    the port's ``transformer`` itself (atol 1e-6, JAX's), on every rank of
    an (8, 1) mesh, and so within (a)'s atol 2e-5 of JAX's."""
    blocks = jax_params["vision"]["blocks"]
    x = _x(4)
    ref = np.asarray(jclip.transformer(jnp.asarray(x), blocks, HEADS,
                                       attn_impl="xla"))
    own = tclip.transformer(torch.tensor(x), params_from_numpy(blocks),
                            HEADS, attn_impl="unfused").numpy()
    # each rank holds 4 of the 32 rows; JAX's fallback ignores the data
    # axis too
    for got in pool.run(R.pp_transformer, 8, (8, 1), 2, np.tile(x, (8, 1, 1)),
                        blocks, HEADS):
        for rows in np.split(got["out"], 8):
            np.testing.assert_allclose(rows, own, atol=1e-6)
            np.testing.assert_allclose(rows, ref, atol=2e-5, rtol=1e-5)


def _lora(seed=3):
    """A vision LoRA stack for TINY4 with every factor nonzero (b_in and
    b_out start at zero in ``build_peft``; seeded draws make every grad
    live), as numpy."""
    cfg = CLIPConfig(**TINY4_KW)
    peft = build_peft(torch.Generator().manual_seed(1), cfg,
                      PEFTConfig(method="lora", encoder="image", lora_r=4),
                      device="cpu")
    rng = np.random.default_rng(seed)
    return {"lora": {k: (0.05 * rng.standard_normal(tuple(v.shape)))
                     .astype(np.float32)
                     for k, v in peft["vision"]["lora"].items()}}


def test_pp_remat_matches_plain(pool, jax_params):
    """(d) ``remat=True`` checkpoints each tick's local stack: the same
    output and grads (of x and of every LoRA leaf) as without it, bit for
    bit; and ``make_train_step(remat=True, forward_fn=pp)`` (one checkpoint
    around the whole forward, whose recompute issues the permutes again)
    finishes on 2 ranks with the loss and leaves of the step without it."""
    blocks = jax_params["vision"]["blocks"]
    x, lora = _x(8), _lora()
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    plain, remat = (pool.run(R.pp_transformer, 2, (1, 2), 4, x, blocks,
                             HEADS, lora, cot, "unfused", r)
                    for r in (False, True))
    for a, b in zip(plain, remat):
        for k in ("out", "gx"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["glora"].keys() == b["glora"].keys()
        for k, v in a["glora"].items():
            assert np.abs(v).max() > 0, k
            np.testing.assert_array_equal(b["glora"][k], v)
    peft = jbuild_peft(jax.random.PRNGKey(1), TINY4,
                       JPEFT(method="lora", encoder="image", lora_r=4))
    peft_np = jax.tree.map(np.asarray, peft)
    batch = _batch(8)
    steps = [pool.run(R.pp_train_step, 2, (1, 2), 2, TINY4_KW, jax_params,
                      peft_np, batch, r) for r in (False, True)]
    for a, b in zip(*steps):
        assert a["loss"] == b["loss"] and np.isfinite(a["loss"])
        for k, v in a["trainable"].items():
            np.testing.assert_array_equal(b["trainable"][k], v)


class _Staged:
    """Stage ``model_rank`` of a ``model``-stage axis (all
    ``shard_params_pp`` reads)."""

    def __init__(self, model, model_rank):
        self.model, self.model_rank = model, model_rank


def test_shard_params_pp_follows_jax_rules(jax_params):
    """(e) Which leaves ``shard_params_pp`` cuts, by JAX's placement on its
    (2, 4) mesh (``P('model')`` or ``P()``), and what each stage keeps: the
    contiguous layers ``[s * L/S, (s + 1) * L/S)`` as fresh leaves; an
    indivisible leading dim kept whole; ``match=()`` for the LoRA stack;
    one stage gives the tree back."""
    tree = {"vision": {"blocks": jax_params["vision"]["blocks"],
                       "odd": {"blocks": np.zeros((3, 5), np.float32)},
                       "proj": jax_params["vision"]["proj"]},
            "text": {"blocks": jax_params["text"]["blocks"]}}
    jtree = jmesh.shard_params_pp(jax.tree.map(jnp.asarray, tree),
                                  jmesh.make_mesh((2, 4)))
    want = {k: bool(v) for k, v in R.flat(jax.tree.map(
        lambda a: np.array(a.sharding.spec == P("model")), jtree)).items()}
    whole = R.flat(tree)
    ttree = params_from_numpy(tree)
    for s in range(4):
        got = tmesh.shard_params_pp(ttree, _Staged(4, s))
        for k, leaf in R.flat(got).items():
            if want[k]:
                k4 = whole[k].shape[0] // 4
                np.testing.assert_array_equal(
                    leaf, whole[k][s * k4:(s + 1) * k4], err_msg=str(k))
            else:
                np.testing.assert_array_equal(leaf, whole[k], err_msg=str(k))
    assert want[("vision", "blocks", "attn", "w_qkv")]
    assert not want[("vision", "odd", "blocks")]
    assert not want[("vision", "proj")] and not want[
        ("text", "blocks", "attn", "w_qkv")]
    lora = params_from_numpy(_lora())
    cut = tmesh.shard_params_pp(lora, _Staged(2, 1), match=())
    assert cut["lora"]["a_in"].shape[0] == 2
    assert torch.equal(cut["lora"]["a_in"], lora["lora"]["a_in"][2:])
    cut["lora"]["a_in"].add_(1.0)     # a fresh leaf, not a view
    assert not torch.equal(cut["lora"]["a_in"], lora["lora"]["a_in"][2:])
    assert tmesh.shard_params_pp(lora, _Staged(1, 0), match=()) is lora


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_image_depth_runner_is_transformer(jax_params, dtype):
    """(f) ``encode_image(depth_runner=transformer)`` equals the default
    tower, bit for bit, on the fused road with LoRA, remat on and off."""
    cfg = CLIPConfig(**TINY4_KW)
    params = params_from_numpy(jax_params)
    peft = params_from_numpy(_lora())
    pcfg = PEFTConfig(method="lora", encoder="image", lora_r=4)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    for remat in (False, True):
        a, b = (tclip.encode_image(params, images, cfg, peft_cfg=pcfg,
                                   peft=peft, compute_dtype=dtype,
                                   remat=remat, depth_runner=r)
                for r in (None, tclip.transformer))
        assert torch.equal(a, b)


def test_pp_refuses_prompts_and_an_indivisible_batch(jax_params):
    """(g) Per-layer prompts and a per-rank batch that the microbatches do
    not divide are refused (JAX ``pipeline.py:85-86, 99-100``)."""
    blocks = params_from_numpy(jax_params["vision"]["blocks"])
    x = torch.zeros(6, 17, 128)
    mesh = _Staged(2, 0)
    with pytest.raises(ValueError, match="per-layer prompts"):
        tpipe.pipelined_transformer(x, blocks, HEADS, mesh=mesh,
                                    n_microbatches=2,
                                    layer_prompts=torch.zeros(4, 2, 128))
    with pytest.raises(ValueError, match="not divisible by 4"):
        tpipe.pipelined_transformer(x, blocks, HEADS, mesh=mesh,
                                    n_microbatches=4)
    with pytest.raises(TypeError):   # no MoE gate noise: JAX takes none
        tpipe.pipelined_transformer(x, blocks, HEADS, mesh=mesh,
                                    n_microbatches=2, moe_noise=None)


def test_pp_stages_run_the_fused_op(pool, jax_params):
    """(h) On the fused road each stage's blocks go through the fused block
    op, forward and backward: (M + S - 1) ticks x L/S layers a rank (JAX's
    schedule runs every stage at every tick); the output and grads within
    1e-5 of their largest entry of the 1-process fused tower's (the op's
    bf16 roundings are per row; only fp32 sums over the microbatches
    reorder: 1.4e-7 to 2.5e-7 here)."""
    blocks = jax_params["vision"]["blocks"]
    x, lora = _x(8), _lora()
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    want = R.pp_transformer(0, 1, (1, 1), 4, x, blocks, HEADS, lora, cot,
                            "fused")
    assert want["calls"] == {"fwd": 4, "bwd": 4}
    for got in pool.run(R.pp_transformer, 2, (1, 2), 4, x, blocks, HEADS,
                        lora, cot, "fused"):
        assert got["calls"] == {"fwd": (4 + 2 - 1) * 2,
                                "bwd": (4 + 2 - 1) * 2}
        for k in ("out", "gx"):
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * scale)
        for k, v in want["glora"].items():
            np.testing.assert_allclose(got["glora"][k], v, rtol=0,
                                       atol=1e-5 * np.abs(v).max())
