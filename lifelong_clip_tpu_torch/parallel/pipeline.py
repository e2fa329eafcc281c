"""GPipe-style pipeline parallelism over the vision tower's depth.

Counterpart of ``lifelong_clip_tpu/parallel/pipeline.py``: the road for
towers too deep for one device (ViT-L/14 and up at large batch). It runs on
``parallel/mesh.py``'s one process a device, rank ``r`` at ``(r // S, r %
S)`` of a ``D x S`` mesh:

  * each model rank is one stage and holds L/S contiguous layers of the
    layer-stacked block leaves (``mesh.shard_params_pp``);
  * activations go from stage to stage with ``mesh.ring_permute`` (JAX
    ``lax.ppermute``), whose backward is the inverse permutation;
  * the rank's batch rows split into M microbatches; the schedule runs M +
    S - 1 ticks, of which (S - 1) / (M + S - 1) are the bubble;
  * the data axis splits the batch rows as everywhere in the port, so data
    and pipeline parallelism compose.

Each stage runs its layers whole through ``models/clip.py:transformer``,
so its blocks take the fused attention kernels (#1/#2) on the card. Every
rank runs the same operations in the same order at every tick, JAX's SPMD
schedule: the stage index enters only as values (which microbatch or
carry a ``torch.where`` keeps, which stage writes the output), and the
bubble ticks compute activations that never reach an output, whose grads
are exactly zero. So every rank builds the same autograd graph, and its
backward, and the recompute of a checkpoint around it, issue the
collectives in the same order on every rank.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from ..config import CLIPConfig, PEFTConfig
from . import mesh as mesh_lib


def _local_stack(h, blocks_local, peft_local, n_heads, mask, peft_cfg,
                 attn_impl, act, base_grads):
    """This stage's layers (JAX ``_local_stack``), whole on every rank: a
    model axis's tensor parallelism is switched off around them, also when
    a checkpoint recomputes them inside a caller's ``model_parallel``."""
    from ..models.clip import transformer
    with mesh_lib.model_parallel(None):
        return transformer(h, blocks_local, n_heads, mask=mask,
                           peft_cfg=peft_cfg, peft=peft_local,
                           attn_impl=attn_impl, act=act,
                           base_grads=base_grads)


def pipelined_transformer(x, blocks, n_heads: int, *, mesh: mesh_lib.Mesh,
                          n_microbatches: int, mask=None,
                          peft_cfg: Optional[PEFTConfig] = None, peft=None,
                          layer_prompts=None, layer_prompt_valid=None,
                          attn_impl: str = "fused", act: str = "quick_gelu",
                          prompt_ln: bool = False, remat: bool = False,
                          base_grads: bool = True):
    """Depth-pipelined drop-in for ``models/clip.py:transformer`` (JAX
    ``:61-144``).

    ``x``: this rank's (B, T, D) rows; ``blocks`` / ``peft``: this stage's
    slices of the layer-stacked trees (``mesh.shard_params_pp``). B must
    divide into ``n_microbatches``. ``remat`` checkpoints each tick's local
    layer stack (JAX wraps ``run`` alone); no collective runs inside a
    checkpoint. ``x`` enters through ``copy_to_model`` (its grad, stage 0's,
    summed over the model group) and the finished activations reach every
    stage through ``reduce_from_model`` (the last stage's, all-reduced; the
    backward passes the replicated grad through, so the epilogue's loss is
    counted once). Per-layer prompts are refused, as JAX refuses them; it
    takes no MoE gate noise (JAX's signature has no ``moe_rng``).
    """
    if layer_prompts is not None or layer_prompt_valid is not None:
        raise ValueError("pipelined_transformer does not take per-layer "
                         "prompts")
    del prompt_ln
    n_stages = mesh.model
    if n_stages == 1:
        from ..models.clip import transformer
        return transformer(x, blocks, n_heads, mask=mask, peft_cfg=peft_cfg,
                           peft=peft, attn_impl=attn_impl, act=act,
                           remat=remat, base_grads=base_grads)
    m = int(n_microbatches)
    b = x.shape[0]
    if b % m:
        raise ValueError(f"per-rank batch {b} not divisible by {m} "
                         f"microbatches")
    run = functools.partial(_local_stack, n_heads=n_heads, mask=mask,
                            peft_cfg=peft_cfg, attn_impl=attn_impl, act=act,
                            base_grads=base_grads)
    if remat:
        run = functools.partial(torch.utils.checkpoint.checkpoint, run,
                                use_reentrant=False, preserve_rng_state=False)
    s = mesh.model_rank
    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == n_stages - 1, device=x.device)
    mb = mesh_lib.copy_to_model(x, mesh).reshape(m, b // m, *x.shape[1:])
    carry = torch.zeros_like(mb[0])
    outputs = [None] * m
    for t in range(m + n_stages - 1):
        # stage 0 ingests microbatch t; later stages consume the activation
        # handed over by the previous stage last tick
        out = run(torch.where(first, mb[min(t, m - 1)], carry), blocks, peft)
        # the last stage owns microbatch t - (S - 1)'s final activation
        if t >= n_stages - 1:
            outputs[t - (n_stages - 1)] = out
        carry = mesh_lib.ring_permute(out, mesh)
    done = torch.stack(outputs)
    done = mesh_lib.reduce_from_model(
        torch.where(last, done, torch.zeros_like(done)), mesh)
    return done.reshape(x.shape)


def make_pp_forward(clip_cfg: CLIPConfig, peft_cfg: PEFTConfig,
                    mesh: mesh_lib.Mesh, n_microbatches: int, *,
                    compute_dtype=torch.bfloat16, attn_impl: str = "fused"):
    """``forward_fn`` for ``engine.make_train_step`` with a pipelined vision
    tower (JAX ``:147-189``): the vision blocks and any vision PEFT stack
    are the stages' slices (``mesh.shard_params_pp(frozen, mesh)``,
    ``shard_params_pp(trainable, mesh, match=("vision",))``); the text
    tower runs replicated on every rank. Returns ``fwd(frozen, trainable,
    images, tokens) -> (logits, img, txt)``: fp32 logits at
    ``exp(logit_scale)`` of the normalized features."""
    from ..models import clip as clip_fns

    depth_runner = functools.partial(
        pipelined_transformer, mesh=mesh, n_microbatches=n_microbatches)

    def fwd(frozen, trainable, images, tokens):
        img = clip_fns.normalize(clip_fns.encode_image(
            frozen, images, clip_cfg,
            peft_cfg=peft_cfg if peft_cfg.on_vision() else None,
            peft=trainable.get("vision"), compute_dtype=compute_dtype,
            attn_impl=attn_impl, base_grads=False,
            depth_runner=depth_runner))
        txt = clip_fns.normalize(clip_fns.encode_text(
            frozen, tokens, clip_cfg,
            peft_cfg=peft_cfg if peft_cfg.on_text() else None,
            peft=trainable.get("text"), compute_dtype=compute_dtype,
            attn_impl=attn_impl, base_grads=False))
        scale = torch.exp(frozen["logit_scale"]).float()
        return scale * (img.float() @ txt.float().T), img, txt

    return fwd
