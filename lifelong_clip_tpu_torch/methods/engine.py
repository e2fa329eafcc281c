"""The online-learning engine: one train step, one eval step, the text pass.

Counterpart of ``lifelong_clip_tpu/methods/engine.py``: the
towers with their PEFT trees (LoRA, adapter or MoE) run forward and
backward through the fused attention kernels (``base_grads=False``), the
text tower too where it trains (``peft_forward``), else logits go against
cached normalized class-text features (``peft_forward_cached_text``), and a
``torch.optim`` optimizer updates the PEFT tree. A MoE step draws its gate
noise from the state's generator. The step runs eagerly (the JAX package
jits it); its state is an explicit ``TrainState`` object. ``remat``
checkpoints the tower forward and ``remat_fallback`` retries a step once
with it after the card runs out of memory, as the JAX engine does; each
rank of a mesh retries on its own. The data-parallel road (JAX
``:83-113``, ``:255-340``): the step runs on the rank's rows with the
rank's draws and ``TrainState.apply`` averages the grads over the data
group in one all-reduce.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import CLIPConfig, PEFTConfig
from ..models import clip as clip_fns
from ..ops import moe as moe_ops
from ..ops import preprocess

log = logging.getLogger("lifelong_clip_tpu_torch")


def tree_leaves(tree):
    """Tensors of a nested dict (or list: the ModifiedResNet tower's stages
    and blocks) in a fixed (insertion) order; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``,
    trees of its structure), keeping the structure (``jax.tree.map``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


class TrainState:
    """Trainable (fp32 masters) and frozen trees, the optimizer over the
    trainable leaves, its schedule, the step count and the augmentation
    generator."""

    def __init__(self, *, trainable, frozen, make_opt: Callable,
                 gen: torch.Generator):
        self.trainable = trainable
        self.frozen = frozen
        self.make_opt = make_opt
        self.gen = gen
        self.step = 0
        for p in tree_leaves(trainable):
            p.requires_grad_(True)
        self.reset_optimizer()

    def reset_optimizer(self):
        """Fresh moments and a restarted schedule (``tx.init``)."""
        self.opt, self.sched = self.make_opt(tree_leaves(self.trainable))

    def apply(self, loss, dp=None, mean=(), total=()):
        """One update from ``loss`` (``tx.update`` + ``apply_updates``):
        backward, the optimizer's and the schedule's step.

        ``dp``: the step's data-parallel mesh (``parallel/mesh.py``), or
        None. Under it the trainable grads, the tensors of ``mean`` (the
        step's loss and accuracy) and those of ``total`` (usage-count
        increments) ride one all-reduce over the data group between the
        backward and the optimizer's step: the grads and ``mean`` come back
        as the ranks' mean (JAX's ``pmean``; equal shards make it the
        global batch's), ``total`` as their sum, each in place. Without it
        nothing is reduced or copied."""
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        leaves = tree_leaves(self.trainable)
        fill_missing_grads(leaves)
        if dp is not None:
            dp.all_mean([p.grad for p in leaves] + list(mean), total)
        self.opt.step()
        self.sched.step()
        self.step += 1


def fill_missing_grads(leaves):
    """Zero grads for the leaves the loss does not reach (``grad`` None),
    so that the optimizer updates them as optax updates a leaf whose grad
    is zeros: its moments decay and any weight decay applies. torch's
    optimizers skip a leaf with no grad."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def remat_fallback(build: Callable[[bool], Callable]) -> Callable:
    """A train step that falls back to remat once the card runs out of
    memory (JAX ``engine.py:33-79``).

    ``build(remat) -> step`` makes the step ``step(state, *args)``. The
    step built with ``remat=False`` runs; if its first call raises
    ``torch.cuda.OutOfMemoryError`` the cache is freed, the step is rebuilt
    with remat and the call retried once, with the augmentation generator
    (``state.gen``) restored to where the failed call found it. The step
    mutates nothing else before ``opt.step()``, which the OOM precedes.
    Once a call has succeeded the step provably fits, so a later OOM
    raises, as does one after the fallback."""
    fn = build(False)
    fell_back = False
    ran_once = False

    def step(state, *args):
        nonlocal fn, fell_back, ran_once
        first = not (ran_once or fell_back)
        gen_state = state.gen.get_state() if first else None
        try:
            out = fn(state, *args)
        except torch.cuda.OutOfMemoryError as e:
            if not first:
                raise
            msg = str(e).splitlines()[0][:160] if str(e) else "OOM"
        else:
            ran_once = True
            return out
        # retried outside the handler: the exception's traceback holds the
        # failed call's tensors
        log.warning("train step exceeds device memory un-remat'd; "
                    "rebuilding with remat (%s)", msg)
        torch.cuda.empty_cache()
        state.gen.set_state(gen_state)
        fn = build(True)
        fell_back = True
        return fn(state, *args)

    return step


def peft_forward(frozen, trainable, images, tokens, clip_cfg: CLIPConfig,
                 peft_cfg: PEFTConfig, compute_dtype, attn_impl: str = "fused",
                 remat: bool = False, moe_noise=None):
    """CLIP forward over both towers with the PEFT trees routed to them
    (``engine.py:130-142``): the text tower runs forward and backward every
    step. The towers' own weights are frozen (``base_grads=False``).
    ``moe_noise``: ``{'vision', 'text'}`` gate noise (``clip_forward``)."""
    return clip_fns.clip_forward(
        frozen, images, tokens, clip_cfg, peft_cfg=peft_cfg,
        peft_vision=trainable.get("vision"), peft_text=trainable.get("text"),
        compute_dtype=compute_dtype, attn_impl=attn_impl, base_grads=False,
        remat=remat, moe_noise=moe_noise)


def peft_forward_cached_text(frozen, trainable, images, txt_features,
                             clip_cfg: CLIPConfig, peft_cfg: PEFTConfig,
                             compute_dtype, attn_impl: str = "fused",
                             remat: bool = False, moe_noise=None):
    """Image-only-PEFT forward against precomputed normalized text
    features (``engine.py:145-167``); ``remat`` checkpoints each vision
    block; ``moe_noise``: ``{'vision'}`` gate noise."""
    img = clip_fns.encode_image(
        frozen, images, clip_cfg,
        peft_cfg=peft_cfg if peft_cfg.on_vision() else None,
        peft=trainable.get("vision"), compute_dtype=compute_dtype,
        attn_impl=attn_impl, base_grads=False, remat=remat,
        moe_noise=(moe_noise or {}).get("vision"))
    img = clip_fns.normalize(img)
    scale = torch.exp(frozen["logit_scale"]).float()
    logits = scale * (img.float() @ txt_features.float().T)
    return logits, img, txt_features


def ce_on_probs_loss(logits, labels):
    """CE applied to softmaxed probs (``engine.py:170-179``); padded -inf
    class slots are excluded from both softmaxes."""
    probs = torch.softmax(logits, dim=-1)
    z = torch.where(torch.isfinite(logits), probs,
                    torch.full_like(probs, float("-inf")))
    return F.cross_entropy(z, labels)


def _default_loss(logits, labels):
    return F.cross_entropy(logits, labels)


def soft_label_loss(logits, y_soft):
    """Soft-label CE written as JAX writes it (``engine.py:313-319``):
    ``-sum(where(y > 0, y * log_softmax, 0))`` a row, meaned. A masked class
    slot carries log_softmax = -inf, and ``0 * -inf`` would give NaN."""
    ls = torch.log_softmax(logits, dim=-1)
    per = -torch.where(y_soft > 0, y_soft * ls, 0.0).sum(-1)
    return per.mean()


def make_train_step(clip_cfg: CLIPConfig, peft_cfg: PEFTConfig, *,
                    image_size: int, mean, std, augment: bool = True,
                    use_autoaug: bool = False,
                    autoaug_policy: str = "imagenet",
                    use_cutmix: bool = False,
                    compute_dtype=torch.bfloat16, attn_impl: str = "fused",
                    forward_fn: Optional[Callable] = None,
                    loss_fn: Optional[Callable] = None,
                    cached_text: bool = False,
                    remat: bool = False, dp=None):
    """Build the online train step ``step(state, batch) -> metrics``.

    batch dict (tensors on the device):
      images  (B, H, W, C) uint8 raw samples
      labels  (B,) int64, already remapped to class-table slots
      tokens  (K, ctx) int class token table (both towers run,
              ``peft_forward``), or with ``cached_text`` (K, E) cached
              normalized text features (``peft_forward_cached_text``), or,
              with ``forward_fn``, whatever it takes: MaPLe's (K, ctx)
              class token table
      mask    (K,) f32, 0 on valid class slots, -inf on padding
    ``forward_fn(frozen, trainable, images, tokens) -> (logits, img, txt)``
    replaces the PEFT forward (JAX ``engine.py:233-236``).
    ``augment=False`` casts the raw uint8 straight to the compute dtype
    (``engine.py:277-278``); ``use_autoaug`` runs AutoAugment's
    ``autoaug_policy`` first. ``use_cutmix``: after the augmentation's draws
    each step draws one Bernoulli(0.5) from ``state.gen`` and, where it
    comes up, batch CutMix's partner permutation, area and centre
    (``preprocess.random_cutmix``); the labels become soft one-hots over
    ``tokens.shape[0]`` slots and the loss ``soft_label_loss`` (JAX
    ``engine.py:294-319``). ``remat`` checkpoints each block of the PEFT
    forward's towers, or the whole ``forward_fn`` (JAX
    ``engine.py:237-242``): the backward recomputes the forward instead of
    keeping its intermediates. With MoE PEFT and no ``forward_fn`` each
    step draws fresh gate noise for every trained tower from ``state.gen``
    after the augmentation's draws (JAX ``engine.py:252-292`` draws a fresh
    key a step; eval and text passes get none). ``dp``: the data-parallel
    mesh (JAX's ``dp_mesh``): the batch holds this rank's rows, the draws
    come from the rank's generator (``Mesh.fold_gen``, JAX
    ``dp_fold_rng``; CutMix mixes within the rank's rows) and the grads,
    loss and accuracy are averaged over the data group
    (``TrainState.apply``). The step updates ``state`` in place.
    """
    pipeline = preprocess.make_train_pipeline(
        image_size, mean, std, use_autoaug=use_autoaug,
        autoaug_policy=autoaug_policy,
        out_dtype=compute_dtype) if augment else None
    fwd = forward_fn or functools.partial(
        peft_forward_cached_text if cached_text else peft_forward,
        clip_cfg=clip_cfg, peft_cfg=peft_cfg,
        compute_dtype=compute_dtype, attn_impl=attn_impl, remat=remat)
    if forward_fn is not None and remat:
        fwd = functools.partial(torch.utils.checkpoint.checkpoint, forward_fn,
                                use_reentrant=False, preserve_rng_state=False)
    compute_loss = loss_fn or _default_loss
    draws_noise = peft_cfg is not None and peft_cfg.method == "moe" \
        and forward_fn is None

    def gate_noise(gen, state, images, tokens):
        """{tower: (L, rows, E) N(0, 1) draws} for each trained tower."""
        rows = {"vision": (clip_cfg.vision_layers, images.shape[0]),
                "text": (clip_cfg.text_layers, tokens.shape[0])}
        return {tower: moe_ops.draw_gate_noise(
                    gen, (*rows[tower], peft_cfg.moe_experts),
                    images.device)
                for tower in ("vision", "text")
                if state.trainable.get(tower) is not None}

    def step(state: TrainState, batch):
        gen = state.gen if dp is None else dp.fold_gen(state.gen)
        if pipeline is not None:
            images = pipeline(gen, batch["images"])
        else:
            images = batch["images"].to(compute_dtype)
        kw = ({"moe_noise": gate_noise(gen, state, images, batch["tokens"])}
              if draws_noise else {})
        if use_cutmix:
            y_soft = F.one_hot(batch["labels"],
                               batch["tokens"].shape[0]).float()
            if float(torch.rand((), generator=gen)) < 0.5:
                images, y_soft, _ = preprocess.random_cutmix(
                    gen, images, y_soft)
        logits, _, _ = fwd(state.frozen, state.trainable, images,
                           batch["tokens"], **kw)
        logits = logits + batch["mask"][None, :]
        loss = (soft_label_loss(logits, y_soft) if use_cutmix
                else compute_loss(logits, batch["labels"]))
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        stats = {"loss": loss.detach(), "acc": acc}
        state.apply(loss, dp, mean=stats.values())
        return stats

    return step


def make_text_feature_fn(clip_cfg: CLIPConfig, peft_cfg: PEFTConfig, *,
                         compute_dtype=torch.bfloat16,
                         attn_impl: str = "fused"):
    """Class-token table -> normalized text features; run once per change of
    the exposed class set."""

    @torch.no_grad()
    def text_features(frozen, trainable, tokens):
        txt = clip_fns.encode_text(
            frozen, tokens, clip_cfg,
            peft_cfg=peft_cfg if peft_cfg.on_text() else None,
            peft=(trainable or {}).get("text"),
            compute_dtype=compute_dtype, attn_impl=attn_impl)
        return clip_fns.normalize(txt)

    return text_features


def make_eval_step(clip_cfg: CLIPConfig, peft_cfg: PEFTConfig, *,
                   image_size: int, mean, std, compute_dtype=torch.bfloat16,
                   attn_impl: str = "fused"):
    """Eval step: uint8 images + cached text features -> (preds, logits)."""
    pipeline = preprocess.make_eval_pipeline(image_size, mean, std,
                                             out_dtype=compute_dtype)

    @torch.no_grad()
    def eval_step(frozen, trainable, images_u8, txt_features, mask):
        img = clip_fns.encode_image(
            frozen, pipeline(images_u8), clip_cfg,
            peft_cfg=peft_cfg if peft_cfg.on_vision() else None,
            peft=(trainable or {}).get("vision"),
            compute_dtype=compute_dtype, attn_impl=attn_impl)
        img = clip_fns.normalize(img)
        scale = torch.exp(frozen["logit_scale"]).float()
        logits = scale * (img.float() @ txt_features.float().T)
        logits = logits + mask[None, :]
        return logits.argmax(-1), logits

    return eval_step
