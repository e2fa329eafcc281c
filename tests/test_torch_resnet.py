"""The port's ModifiedResNet tower (``models/resnet.py``) and the RN branches
of ``models/{init,clip,convert}.py`` and ``bridge.py`` against the JAX
package's, on a tiny RN (stem width 16, stages (1, 1, 2, 1), 64 px input,
the 2 x 2 attention-pool grid of ``tests/test_resnet.py``) whose weights
and BatchNorm statistics come from a numpy seed; and continual-clip from a
tiny RN checkpoint through the CLI."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_clip_tpu.config import CLIPConfig as JCLIPConfig
from lifelong_clip_tpu.models import clip as jclip
from lifelong_clip_tpu.models import convert as jconvert
from lifelong_clip_tpu.models import resnet as jresnet
from lifelong_clip_tpu.models.init import init_clip_params as jinit
from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.bridge import params_from_numpy, params_to_numpy
from lifelong_clip_tpu_torch.config import CLIPConfig
from lifelong_clip_tpu_torch.methods.engine import tree_leaves
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.models import convert as tconvert
from lifelong_clip_tpu_torch.models import resnet as tresnet
from lifelong_clip_tpu_torch.models.init import init_clip_params

RN = dict(embed_dim=32, image_size=64, patch_size=32, vision_width=16,
          vision_layers=(1, 1, 2, 1), vision_heads=8, context_length=77,
          vocab_size=49408, text_width=64, text_heads=1, text_layers=2,
          tower="rn")
JRN, TRN = JCLIPConfig(**RN), CLIPConfig(**RN)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=()):
    """(key path, numpy leaf) of a tree of dicts, lists and None, in a
    fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, np.asarray(tree)


def _same_tree(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


@pytest.fixture(scope="module")
def rn_params():
    """The tiny RN tree JAX's converter reads from ``_rn_state_dict`` (every
    BatchNorm with random statistics and scales), as numpy."""
    return _np(jconvert.state_dict_to_params(_rn_state_dict())[0])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_rn_encode_image_matches_jax(rn_params, dtype, tol):
    """The tower's embedding, on the same weights and images. fp32:
    summation order only (1e-4 of the output's max); bf16: activations
    rounded to bf16 after every convolution and BatchNorm of 5 bottlenecks
    (3e-2 of the max, as the bf16 ViT towers' tests)."""
    images = np.random.default_rng(1).standard_normal(
        (3, 64, 64, 3)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(jax.jit(lambda p, x: jresnet.rn_encode_image(
        p, x, JRN, compute_dtype=jdt))(rn_params, jnp.asarray(images)),
        np.float32)
    params = params_from_numpy(rn_params)
    got = tresnet.rn_encode_image(params, torch.tensor(images), TRN,
                                  compute_dtype=tdt)
    assert got.dtype == tdt and got.shape == (3, 32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)
    # encode_image dispatches the RN tower; cast_towers leaves it fp32
    frozen = tclip.cast_towers(params, tdt)
    assert all(t.dtype == torch.float32
               for t in tree_leaves(frozen["vision"]))
    assert frozen["text"]["pos_embed"].dtype == tdt
    via = tclip.encode_image(frozen, torch.tensor(images), TRN,
                             compute_dtype=tdt)
    assert torch.equal(via, got)


def test_rn_tower_grads_reach_fp32_leaves(rn_params):
    """A trained RN tower (FT) keeps fp32 masters: a bf16 forward's grads
    land on them, every stem and block leaf getting one."""
    params = params_from_numpy(rn_params)
    for p in tree_leaves(params["vision"]):
        p.requires_grad_(True)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    tresnet.rn_encode_image(params, x, TRN,
                            compute_dtype=torch.bfloat16).float().sum() \
        .backward()
    for k, p in zip(_leaves(rn_params["vision"]),
                    tree_leaves(params["vision"])):
        assert p.grad is not None and p.grad.dtype == torch.float32, k[0]


def _rn_state_dict(seed=0):
    """A tiny OpenAI ModifiedResNet state dict (the reference
    ``build_model``'s key names and shapes: conv kernels OIHW, Linear
    weights (out, in), BatchNorm running statistics), numpy fp32, written
    out here and not taken from either converter."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.1, shift=0.0):
        return (shift + std * rng.standard_normal(shape)).astype(np.float32)

    def bn(name, c):
        return {f"{name}.weight": n(c, shift=1.0), f"{name}.bias": n(c),
                f"{name}.running_mean": n(c),
                f"{name}.running_var": np.abs(n(c, shift=1.0))}

    w = RN["vision_width"]
    sd = {"visual.conv1.weight": n(w // 2, 3, 3, 3),
          "visual.conv2.weight": n(w // 2, w // 2, 3, 3),
          "visual.conv3.weight": n(w, w // 2, 3, 3),
          **bn("visual.bn1", w // 2), **bn("visual.bn2", w // 2),
          **bn("visual.bn3", w)}
    inplanes = w
    for s, depth in enumerate(RN["vision_layers"]):
        planes = w * 2 ** s
        for b in range(depth):
            p = f"visual.layer{s + 1}.{b}"
            sd.update({f"{p}.conv1.weight": n(planes, inplanes, 1, 1),
                       f"{p}.conv2.weight": n(planes, planes, 3, 3),
                       f"{p}.conv3.weight": n(planes * 4, planes, 1, 1),
                       **bn(f"{p}.bn1", planes), **bn(f"{p}.bn2", planes),
                       **bn(f"{p}.bn3", planes * 4)})
            if b == 0:
                sd.update({f"{p}.downsample.0.weight":
                           n(planes * 4, inplanes, 1, 1),
                           **bn(f"{p}.downsample.1", planes * 4)})
            inplanes = planes * 4
    c = w * 32
    sd["visual.attnpool.positional_embedding"] = n(2 * 2 + 1, c)
    for name, dout in (("q", c), ("k", c), ("v", c), ("c", RN["embed_dim"])):
        sd[f"visual.attnpool.{name}_proj.weight"] = n(dout, c, std=c ** -0.5)
        sd[f"visual.attnpool.{name}_proj.bias"] = n(dout)
    tw = RN["text_width"]
    sd.update({"token_embedding.weight": n(RN["vocab_size"], tw, std=0.02),
               "positional_embedding": n(77, tw, std=0.01),
               "text_projection": n(tw, RN["embed_dim"]),
               "ln_final.weight": n(tw, shift=1.0), "ln_final.bias": n(tw),
               "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)})
    for i in range(RN["text_layers"]):
        p = f"transformer.resblocks.{i}"
        sd.update({f"{p}.ln_1.weight": n(tw, shift=1.0),
                   f"{p}.ln_1.bias": n(tw),
                   f"{p}.attn.in_proj_weight": n(3 * tw, tw),
                   f"{p}.attn.in_proj_bias": n(3 * tw),
                   f"{p}.attn.out_proj.weight": n(tw, tw),
                   f"{p}.attn.out_proj.bias": n(tw),
                   f"{p}.ln_2.weight": n(tw, shift=1.0),
                   f"{p}.ln_2.bias": n(tw),
                   f"{p}.mlp.c_fc.weight": n(4 * tw, tw),
                   f"{p}.mlp.c_fc.bias": n(4 * tw),
                   f"{p}.mlp.c_proj.weight": n(tw, 4 * tw),
                   f"{p}.mlp.c_proj.bias": n(tw)})
    return sd


def test_rn_converter_matches_jax(tmp_path):
    """The RN state dict read by both converters: the same architecture
    (stage depths from the key families, the pool grid, the heads) and the
    same tree leaf for leaf (HWIO kernels, (in, out) linear weights), from
    the dict and from a ``torch.save`` file; the tower's output on it
    against JAX's."""
    sd = _rn_state_dict()
    jparams, jcfg = jconvert.state_dict_to_params(sd)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tparams, tcfg = tconvert.state_dict_to_params(tsd, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) == \
        dataclasses.asdict(TRN)
    _same_tree(_np(jparams), params_to_numpy(tparams))
    path = str(tmp_path / "RN-tiny.pt")
    torch.save(tsd, path)
    fparams, fcfg = tconvert.load_clip_params(path, device="cpu")
    assert fcfg == tcfg
    _same_tree(params_to_numpy(fparams), params_to_numpy(tparams))
    x = np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jclip.encode_image(jparams, jnp.asarray(x), jcfg,
                                         compute_dtype=jnp.float32))
    got = tclip.encode_image(tparams, torch.tensor(x), tcfg,
                             compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_rn_init_and_bridge_keep_jax_layout(rn_params):
    """The port's seeded RN tree has the structure and shapes of JAX's
    seeded init (its draws are its own), and the bridge carries an RN tree
    both ways unchanged."""
    seeded = params_to_numpy(init_clip_params(
        torch.Generator().manual_seed(0), TRN, device="cpu"))
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), JRN))
    la, lb = list(_leaves(seeded)), list(_leaves(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)))
    assert [(k, a.shape) for k, a in la] == [(k, b.shape) for k, b in lb]
    assert seeded["vision"]["layers"][1][0]["downsample"] is not None
    assert rn_params["vision"]["layers"][0][0]["downsample"] is not None
    _same_tree(params_to_numpy(params_from_numpy(rn_params)), rn_params)


def test_continual_clip_cli_on_tiny_rn(tmp_path):
    """continual-clip from a tiny RN checkpoint (``--pretrained_path``) with
    the zero-shot evaluation, through the CLI on the CPU: result.txt ends
    with the zero-shot line."""
    path = str(tmp_path / "RN-tiny.pt")
    torch.save({k: torch.from_numpy(v) for k, v in _rn_state_dict().items()},
               path)
    out = cli.main(["--method", "continual-clip", "--model_name", "RN50",
                    "--pretrained_path", path, "--dataset", "synthetic-10x8",
                    "--n_tasks", "2", "--batchsize", "8",
                    "--test_batchsize", "8", "--eval_period", "32",
                    "--zero_shot_evaluation", "--zero_shot_dataset",
                    "synthetic-10x8", "--device", "cpu", "--log_path",
                    str(tmp_path / "logs")])
    assert set(out) == {"A_auc", "A_avg", "A_last", "F_last"}
    found = [os.path.join(d, "result.txt")
             for d, _, fs in os.walk(tmp_path / "logs") if "result.txt" in fs]
    assert len(found) == 1
    assert "Dataset:synthetic-10x8 | test_acc:" in open(found[0]).read()
