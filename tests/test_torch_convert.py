"""The port's checkpoint reader (``models/convert.py``) against the JAX
package's, on tiny OpenAI-layout CLIP state dicts written in the test from
a numpy seed: the same parameter tree bit for bit in fp32, the same
architecture, the same tower outputs, from a plain ``torch.save`` file and
from a TorchScript archive; and ``build_clip``'s choice between the file and
a seeded init."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import dataclasses
import math
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_clip_tpu.models import clip as jclip
from lifelong_clip_tpu.models import convert as jconvert
from lifelong_clip_tpu_torch.bridge import params_from_numpy, params_to_numpy
from lifelong_clip_tpu_torch.models import build_clip
from lifelong_clip_tpu_torch.models import clip as tclip
from lifelong_clip_tpu_torch.models import convert as tconvert
from lifelong_clip_tpu_torch.models.init import init_clip_params

# tiny OpenAI-layout ViT: 32 px images of 8 px patches, width 64 (one head
# of 64, as infer_config derives heads from the width)
TINY_SD = dict(width=64, layers=2, patch=8, grid=4, text_width=64,
               text_layers=2, embed=32, context=77, vocab=49408)


def _block_sd(rng, prefix, w, layers):
    sd = {}
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        sd.update({
            f"{p}.ln_1.weight": 1 + 0.1 * rng.standard_normal(w),
            f"{p}.ln_1.bias": 0.1 * rng.standard_normal(w),
            f"{p}.attn.in_proj_weight":
                rng.standard_normal((3 * w, w)) * w ** -0.5,
            f"{p}.attn.in_proj_bias": 0.02 * rng.standard_normal(3 * w),
            f"{p}.attn.out_proj.weight":
                rng.standard_normal((w, w)) * w ** -0.5,
            f"{p}.attn.out_proj.bias": 0.02 * rng.standard_normal(w),
            f"{p}.ln_2.weight": 1 + 0.1 * rng.standard_normal(w),
            f"{p}.ln_2.bias": 0.1 * rng.standard_normal(w),
            f"{p}.mlp.c_fc.weight":
                rng.standard_normal((4 * w, w)) * w ** -0.5,
            f"{p}.mlp.c_fc.bias": 0.02 * rng.standard_normal(4 * w),
            f"{p}.mlp.c_proj.weight":
                rng.standard_normal((w, 4 * w)) * (4 * w) ** -0.5,
            f"{p}.mlp.c_proj.bias": 0.02 * rng.standard_normal(w),
        })
    return sd


def openai_state_dict(seed=0, **kw):
    """An OpenAI CLIP ViT state dict (reference ``build_model``'s key names
    and shapes) of float32 tensors from a numpy seed."""
    s = dict(TINY_SD, **kw)
    rng = np.random.default_rng(seed)
    w, tw = s["width"], s["text_width"]
    sd = {
        "visual.class_embedding": rng.standard_normal(w) * w ** -0.5,
        "visual.positional_embedding":
            rng.standard_normal((s["grid"] ** 2 + 1, w)) * w ** -0.5,
        "visual.proj": rng.standard_normal((w, s["embed"])) * w ** -0.5,
        "visual.conv1.weight":
            rng.standard_normal((w, 3, s["patch"], s["patch"])) * 0.05,
        "visual.ln_pre.weight": 1 + 0.1 * rng.standard_normal(w),
        "visual.ln_pre.bias": 0.1 * rng.standard_normal(w),
        "visual.ln_post.weight": 1 + 0.1 * rng.standard_normal(w),
        "visual.ln_post.bias": 0.1 * rng.standard_normal(w),
        **_block_sd(rng, "visual.transformer", w, s["layers"]),
        "positional_embedding":
            0.01 * rng.standard_normal((s["context"], tw)),
        "text_projection":
            rng.standard_normal((tw, s["embed"])) * tw ** -0.5,
        "logit_scale": np.asarray(math.log(1 / 0.07)),
        "token_embedding.weight":
            0.02 * rng.standard_normal((s["vocab"], tw)),
        "ln_final.weight": 1 + 0.1 * rng.standard_normal(tw),
        "ln_final.bias": 0.1 * rng.standard_normal(tw),
        **_block_sd(rng, "transformer", tw, s["text_layers"]),
    }
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def write_checkpoint(path, seed=0, **kw):
    """``torch.save`` a tiny OpenAI-layout state dict; returns it."""
    sd = openai_state_dict(seed, **kw)
    torch.save(sd, path)
    return sd


class _Holder(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def write_torchscript(path, sd):
    """A TorchScript archive whose ``state_dict`` is ``sd`` (OpenAI ships
    its checkpoints as such archives)."""
    root = _Holder()
    for key, value in sd.items():
        *parents, leaf = key.split(".")
        m = root
        for p in parents:
            if not hasattr(m, p):
                m.add_module(p, _Holder())
            m = getattr(m, p)
        m.register_parameter(leaf, torch.nn.Parameter(value.clone()))
    torch.jit.save(torch.jit.script(root), path)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _same_tree(jtree, ttree):
    jl, tl = list(_leaves(jtree)), list(_leaves(params_to_numpy(ttree)))
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (k, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype == np.float32, k
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=str(k))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    path = str(d / "ViT-tiny.pt")
    sd = write_checkpoint(path)
    jit_path = str(d / "ViT-tiny-jit.pt")
    write_torchscript(jit_path, sd)
    return path, jit_path, sd


@pytest.fixture(scope="module")
def loaded(ckpt):
    path = ckpt[0]
    return jconvert.load_clip_params(path), tconvert.load_clip_params(
        path, device="cpu")


def test_load_clip_params_gives_jax_tree_and_config(loaded):
    """The file read by both packages: the same tree (exact in fp32) and
    the same inferred architecture."""
    (jparams, jcfg), (tparams, tcfg) = loaded
    _same_tree(jparams, tparams)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.image_size, tcfg.vision_layers, tcfg.vision_heads,
            tcfg.text_layers) == (32, 2, 1, 2)


def test_state_dict_to_params_matches_jax(ckpt):
    """From the state dict in memory (tensors here, numpy arrays in JAX)."""
    sd = ckpt[2]
    jparams, _ = jconvert.state_dict_to_params(
        {k: v.numpy() for k, v in sd.items()})
    tparams, _ = tconvert.state_dict_to_params(sd, device="cpu")
    _same_tree(jparams, tparams)
    # the OpenAI orientation is (out, in); the port keeps x @ W
    np.testing.assert_array_equal(
        tparams["vision"]["blocks"]["attn"]["w_qkv"][1].numpy(),
        sd["visual.transformer.resblocks.1.attn.in_proj_weight"].numpy().T)


def test_torchscript_archive_reads_as_the_plain_file(ckpt, loaded):
    """A TorchScript archive (told apart by its constants.pkl) gives the
    same tree through both packages as the plain file."""
    _, jit_path, _ = ckpt
    names = zipfile.ZipFile(jit_path).namelist()
    assert any(n.endswith("constants.pkl") for n in names)
    assert tconvert._is_jit_archive(jit_path)
    assert not tconvert._is_jit_archive(ckpt[0])
    jparams, _ = jconvert.load_clip_params(jit_path)
    tparams, _ = tconvert.load_clip_params(jit_path, device="cpu")
    _same_tree(jparams, tparams)
    _same_tree(jax.tree.map(np.asarray, loaded[0][0]), tparams)


def test_loaded_towers_match_jax(loaded):
    """encode_image / encode_text on the loaded weights (fp32, the unfused
    road against JAX's "xla"): the checkpoint's layout is read as JAX
    reads it."""
    (jparams, jcfg), (tparams, tcfg) = loaded
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((3, 77), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:6] = rng.integers(1000, 40000, (3, 5))
    tokens[np.arange(3), [6, 4, 7]] = 49407
    want_i = jclip.encode_image(jparams, jnp.asarray(images), jcfg,
                                compute_dtype=jnp.float32, attn_impl="xla")
    want_t = jclip.encode_text(jparams, jnp.asarray(tokens), jcfg,
                               compute_dtype=jnp.float32, attn_impl="xla")
    got_i = tclip.encode_image(tparams, torch.tensor(images), tcfg,
                               compute_dtype=torch.float32,
                               attn_impl="unfused")
    got_t = tclip.encode_text(tparams, torch.tensor(tokens), tcfg,
                              compute_dtype=torch.float32,
                              attn_impl="unfused")
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-5,
                               rtol=1e-5)


def test_build_clip_reads_the_file_when_it_exists(ckpt, loaded, tmp_path):
    """``build_clip`` takes the checkpoint's weights and architecture when
    the file exists, and a seeded init of the preset otherwise (as JAX)."""
    tparams, tcfg = build_clip("ViT-B/16", ckpt[0], device="cpu")
    _same_tree(jax.tree.map(np.asarray, loaded[0][0]), tparams)
    assert tcfg == loaded[1][1]
    missing = str(tmp_path / "ViT-B-16.pt")
    assert not os.path.exists(missing)
    params, cfg = build_clip("debug-tiny", missing,
                             gen=torch.Generator().manual_seed(0),
                             device="cpu")
    seeded, _ = build_clip("debug-tiny", gen=torch.Generator().manual_seed(0),
                           device="cpu")
    assert cfg.vision_width == 64 and cfg.vision_layers == 6
    for (_, a), (_, b) in zip(_leaves(params_to_numpy(params)),
                              _leaves(params_to_numpy(seeded))):
        np.testing.assert_array_equal(a, b)


def test_resnet_layout_is_inferred_and_refused(tmp_path):
    """A ModifiedResNet checkpoint (no ``visual.proj``) is inferred as the
    RN tower with JAX's config, from the dict and through the loader from a
    file; the RN tower refuses a PEFT tree, as JAX's does (the reference
    puts PEFT only into transformer blocks). The RN converter itself is
    held against JAX's in ``tests/test_torch_resnet.py``."""
    sd = {k: v for k, v in openai_state_dict(text_layers=1).items()
          if not k.startswith("visual.")}
    for b, depth in zip((1, 2, 3, 4), (1, 1, 2, 1)):
        for i in range(depth):
            sd[f"visual.layer{b}.{i}.conv1.weight"] = torch.zeros(8, 8, 1, 1)
    sd["visual.attnpool.positional_embedding"] = torch.zeros(50, 256)
    jcfg = jconvert.infer_config({k: v.numpy() for k, v in sd.items()})
    tcfg = tconvert.infer_config(sd)
    assert jcfg.tower == tcfg.tower == "rn"
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.vision_layers == (1, 1, 2, 1) and tcfg.image_size == 224
    params = init_clip_params(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    with pytest.raises(ValueError, match="no PEFT"):
        tclip.encode_image(params, torch.zeros(1, 224, 224, 3), tcfg,
                           peft={"lora": {}})


def test_bridged_params_equal_loaded_params(loaded):
    """The bridge carries the JAX-loaded tree to the same tensors the port
    reads itself (how the other tests feed the port JAX's weights)."""
    (jparams, _), (tparams, _) = loaded
    _same_tree(jax.tree.map(np.asarray, jparams),
               params_from_numpy(jax.tree.map(np.asarray, jparams)))
    _same_tree(jax.tree.map(np.asarray, jparams), tparams)
