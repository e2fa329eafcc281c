"""The port's attribute cache (``data/gpt_attributes.py``) against the JAX
package's, on the same tiny tower and a JSON cache the test writes."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import json

import jax
import numpy as np
import torch

from lifelong_clip_tpu.config import CLIPConfig as JCLIPConfig
from lifelong_clip_tpu.data import gpt_attributes as jga
from lifelong_clip_tpu.models.init import init_clip_params as jinit
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import CLIPConfig
from lifelong_clip_tpu_torch.data import gpt_attributes as tga

TINY = dict(embed_dim=64, image_size=32, patch_size=8, vision_width=64,
            vision_layers=2, vision_heads=4, context_length=77,
            vocab_size=49408, text_width=64, text_heads=4, text_layers=2)
CACHE = {"apple": ["red | round | shiny skin", "a short stem|green leaf"],
         "baby": ["small | chubby cheeks", "soft skin | tiny hands"],
         "bus": ["long | yellow | many windows"]}


def _write(tmp_path):
    d = tmp_path / "attribute"
    d.mkdir()
    path = d / "cifar100.json"
    path.write_text(json.dumps(CACHE))
    return str(path)


def test_cache_and_centroids_match_jax(tmp_path):
    """The same flattened phrases; the same centroids (within 1e-5) from
    the same weights in fp32 (the port's plain road against JAX's "xla"
    road on the CPU), through sklearn's KMeans on both sides; zeros for a
    class not in the cache."""
    path = _write(tmp_path)
    assert tga.load_attribute_cache(path) == jga.load_attribute_cache(path)
    cache = tga.load_attribute_cache(path)
    jparams = jinit(jax.random.PRNGKey(0), JCLIPConfig(**TINY))
    params = jax.tree.map(np.asarray, jparams)
    names = ["apple", "baby", "bus", "not_in_cache"]
    want = jga.class_attribute_centroids(jparams, JCLIPConfig(**TINY), cache,
                                         names, n_clusters=2,
                                         compute_dtype=np.float32)
    got = tga.class_attribute_centroids(
        params_from_numpy(params), CLIPConfig(**TINY), cache, names,
        n_clusters=2, compute_dtype=torch.float32, attn_impl="unfused")
    assert got.shape == want.shape == (4, 2, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[3] == 0) and np.abs(got[:3]).max() > 0.01
    # bus has one phrase in three parts: k = 2 of its 3 rows
    assert np.abs(got[2]).sum(-1).min() > 0


def test_kmeans_numpy_matches_jax():
    x = np.random.default_rng(0).standard_normal((40, 16)).astype(
        np.float32)
    for k in (1, 3, 5):
        np.testing.assert_array_equal(tga._kmeans_numpy(x, k),
                                      jga._kmeans_numpy(x, k))


def test_find_attribute_cache(tmp_path):
    assert tga.find_attribute_cache(str(tmp_path), "cifar100") == ""
    path = _write(tmp_path)
    assert tga.find_attribute_cache(str(tmp_path), "cifar100") == path
    assert tga.find_attribute_cache(str(tmp_path), "cifar100") == \
        jga.find_attribute_cache(str(tmp_path), "cifar100")
