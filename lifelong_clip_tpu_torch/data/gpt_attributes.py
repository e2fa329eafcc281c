"""Class visual-attribute cache for ProtoCLIP (offline ingestion).

Counterpart of ``lifelong_clip_tpu/data/gpt_attributes.py`` (reference
``datasets/gpt/attributes.py`` + ``Trainer_ProtoCLIP.py:718-785``): the
per-class visual-attribute texts an LLM wrote once, cached as JSON
(``<gpt_dir>/attribute/<dataset>.json``), embedded with the text tower and
KMeans-clustered into per-class attribute centroids. Only the offline JSON
cache is read; nothing is fetched.

JSON format: {class_name: [attribute_string, ...]} where each string is a
'|'-separated list of attribute phrases.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch


def load_attribute_cache(path: str) -> Dict[str, List[str]]:
    """Load and flatten the attribute JSON: class -> phrase list."""
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for cls, entries in raw.items():
        phrases: List[str] = []
        for entry in entries:
            phrases.extend(p.strip() for p in entry.split("|")
                           if p.strip())
        out[cls] = phrases
    return out


def _kmeans_numpy(x: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    """Lloyd's KMeans from ``k`` seeded distinct rows (the JAX module's
    fallback where sklearn is not importable, as on the card's machine)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = np.stack([x[assign == i].mean(0) if (assign == i).any()
                        else centers[i] for i in range(len(centers))])
        if np.allclose(new, centers):
            break
        centers = new
    return centers


@torch.no_grad()
def class_attribute_centroids(frozen, clip_cfg, cache: Dict[str, List[str]],
                              class_names: List[str], *, n_clusters: int = 3,
                              template: str = "{}",
                              compute_dtype=torch.bfloat16,
                              attn_impl: str = "fused", batch: int = 256):
    """Embed each class's attribute phrases (its first 64) and cluster them
    to centroids: (n_classes, n_clusters, embed_dim) float32, zeros for a
    class missing from the cache. Every phrase of every class goes through
    one batched text-tower pass, ``batch`` rows a call, on the device the
    tower lies on (``attn_impl``: its road, ``models/clip.py``)."""
    from ..models import clip as clip_fns
    from ..utils.tokenizer import tokenize

    all_phrases: List[str] = []
    spans = []
    for name in class_names:
        phrases = cache.get(name, [])[:64]
        spans.append((len(all_phrases), len(phrases)))
        all_phrases.extend(template.format(p) for p in phrases)
    out = np.zeros((len(class_names), n_clusters, clip_cfg.embed_dim),
                   np.float32)
    if not all_phrases:
        return out

    tokens = torch.as_tensor(tokenize(all_phrases), dtype=torch.int64)
    dev = frozen["text"]["token_embedding"].device
    feats = np.concatenate([
        clip_fns.normalize(clip_fns.encode_text(
            frozen, tokens[lo:lo + batch].to(dev), clip_cfg,
            compute_dtype=compute_dtype,
            attn_impl=attn_impl)).float().cpu().numpy()
        for lo in range(0, len(tokens), batch)])

    try:
        from sklearn.cluster import KMeans
    except ImportError:
        KMeans = None
    for ci, (lo, n) in enumerate(spans):
        if n == 0:
            continue
        x = feats[lo:lo + n]
        k = min(n_clusters, len(x))
        if KMeans is not None:
            centers = KMeans(n_clusters=k, n_init=4,
                             random_state=0).fit(x).cluster_centers_
        else:
            centers = _kmeans_numpy(x, k)
        out[ci, :k] = centers
    return out


def find_attribute_cache(gpt_dir: str, dataset: str) -> str:
    """Locate <gpt_dir>/attribute/<dataset>.json if present."""
    p = os.path.join(gpt_dir, "attribute", f"{dataset}.json")
    return p if os.path.exists(p) else ""
