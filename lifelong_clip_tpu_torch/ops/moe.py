"""Dense mixture-of-adapter-experts: noisy top-k gates and the gated combine.

Counterpart of ``lifelong_clip_tpu/ops/moe.py``: every expert computes and a
top-k-masked gate matrix weights the combine (the reference's
``SparseDispatcher`` scatters samples to their experts instead; for the
samples inside the top k the result is the same). Products take bf16
operands with fp32 accumulation (``mm32``), biases are added in fp32, the
expert hidden is rounded once to the input dtype and the gated sum once at
the end, as in JAX.

The gate noise is an explicit tensor of N(0, 1) draws (``noise``, (B, E)),
drawn by ``draw_gate_noise`` from a ``torch.Generator``: the port cannot
reproduce JAX's key stream, so the tests feed the draws JAX makes from its
key into the same core.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import PEFTConfig
from ..parallel import mesh as mesh_lib
from .attention import mm32


def draw_gate_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1) gate-noise draws of ``shape`` ((L, B, E): one (B, E) a
    layer) from ``gen`` on the host, uploaded to ``device`` without waiting
    for the device's queue."""
    noise = torch.randn(shape, generator=gen, dtype=torch.float32)
    return noise.to(device, non_blocking=True)


def noisy_top_k_gates(cls_feats, router, w_noise, top_k: int, *, noise=None,
                      noise_eps: float = 1e-2):
    """Per-sample noisy-top-k gates (reference model.py:559-594).

    cls_feats: (B, D); router/w_noise: (D, E); noise: (B, E) N(0, 1) draws,
    or None for clean-logit gating (eval). Returns (gates (B, E),
    importance (E,)), the gates softmaxed over the selected top k only.
    Every logit >= the k-th largest is kept, so tied logits (a zero-init
    router) are all selected, as in JAX."""
    x32 = cls_feats.float()
    clean = mm32(x32, router)
    logits = clean
    if noise is not None:
        std = F.softplus(mm32(x32, w_noise)) + noise_eps
        logits = clean + noise.float() * std
    k = min(top_k, logits.shape[-1])
    thresh = logits.topk(k, dim=-1).values[:, k - 1:k]
    masked = torch.where(logits >= thresh, logits,
                         torch.full_like(logits, float("-inf")))
    gates = torch.softmax(masked, dim=-1)
    return gates, gates.sum(dim=0)


def moe_adapter_apply(x, moe, cfg: PEFTConfig, *, noise=None):
    """Gated sum of the expert adapters' deltas over the whole sequence.

    x: (B, T, D) block activations (the gates read x[:, 0]); moe: one
    layer of ``models.peft.init_moe``'s tree (``router``/``w_noise`` (D, E),
    experts' leaves (E, ...)); noise: (B, E) or None. Under a model-axis
    mesh (``parallel/mesh.py``) each rank runs its E/M experts; the router
    and the expert leaves stay whole on every rank."""
    gates, _ = noisy_top_k_gates(x[:, 0], moe["router"], moe["w_noise"],
                                 cfg.moe_top_k, noise=noise)
    ex = moe["experts"]
    tp = mesh_lib.tensor_parallel()
    if tp is not None:
        # expert parallelism: this rank's E/M experts on the whole
        # sequence, the gated sums reduced over the model group
        e = gates.shape[-1]
        if e % tp.model:
            raise ValueError(f"{e} experts do not split over a "
                             f"{tp.model}-way model axis")
        cols = mesh_lib.head_columns(e, tp)
        gates = mesh_lib.take(gates, 1, cols, tp)
        ex = {k: mesh_lib.take(v, 0, cols, tp) for k, v in ex.items()}
        x = mesh_lib.copy_to_model(x, tp)
    h = mm32(x[:, None], ex["w_down"][None])          # (B, E, T, k)
    h = torch.relu(h + ex["b_down"].float()[None, :, None, :]).to(x.dtype)
    y = mm32(h, ex["w_up"][None]) + ex["b_up"].float()[None, :, None, :]
    y = cfg.adapter_scale * y                         # (B, E, T, D) fp32
    # elementwise, so no TF32 product on the card
    out = (gates[:, :, None, None] * y).sum(dim=1)
    if tp is not None:
        out = mesh_lib.reduce_from_model(out, tp)
    return out.to(x.dtype)


def cv_squared(x, eps: float = 1e-10):
    """Load-balancing penalty: the squared coefficient of variation
    (reference model.py:497-515), with the population variance as
    ``jnp.var``; 0 for fewer than two entries."""
    x = x.float()
    if x.shape[0] <= 1:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return x.var(correction=0) / (x.mean() ** 2 + eps)
