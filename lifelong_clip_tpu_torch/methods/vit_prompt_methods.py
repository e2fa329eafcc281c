"""L2P, DualPrompt and MVP on the ViT classifier (``l2p``, ``dualprompt``,
``mvp``).

Counterpart of ``lifelong_clip_tpu/methods/vit_prompt_methods.py``
(reference ``models/l2p.py``, ``models/dualprompt.py``, ``methods/mvp.py``,
``models/mvp.py``): a frozen backbone (``vit_base_patch16_224`` in the
scripts), trainable prompt pools and a linear head; the loss is the cross
entropy over the exposed classes (-inf elsewhere) plus lambda times the
mean key similarity, or MVP's loss. Each method keeps a usage counter
outside the optimizer (``frequency``, ``e_frequency``, ``count``), advanced
every step and saved with a checkpoint under the JAX package's key.
``--remat`` or ``batchsize >= 256`` checkpoints the prompted forward (JAX
``jax.checkpoint`` of the forward). The train step runs eagerly on the
device and updates the state in place. A data-parallel mesh runs it on each
rank's rows (JAX ``:75-109``, ``:230-265``, ``:339-373``, ``:456-517``): the
selection counts are summed over the data group, MVP's batch-mean head
gradient and GSF's scale averaged.
"""

from __future__ import annotations

import functools
import logging

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..models import build_clip
from ..models import vit_prompt as vp
from ..models.clip import cast_towers
from ..models.init import param_count
from ..models.mvp_clip import init_mvp_params, mvp_features
from ..ops import preprocess
from ..ops.attention import mm32
from ..parallel.mesh import local_rows
from ..utils.train_utils import make_optimizer
from .base import OnlineTrainer, pad_batch
from .engine import TrainState

log = logging.getLogger("lifelong_clip_tpu_torch")


class _PromptPoolTrainer(OnlineTrainer):
    """The trainers' shared body: frozen tower, trainable tree, a usage
    counter outside the optimizer, the train step and the eval step.
    Subclasses give ``init_trainable``, ``objective`` and ``logits``, and
    ``EXTRA`` = (checkpoint key, counter name) as the JAX trainer saves
    them. ``attn_impl``: the towers' road (``models/clip.py``)."""

    EXTRA = ("", "")
    attn_impl = "fused"

    def setup_model(self):
        cfg = self.cfg
        dev = self.device
        self.params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=dev)
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        trainable, self.counter = self.init_trainable()

        def make_opt(leaves):
            return make_optimizer(cfg.opt_name, leaves, cfg.lr,
                                  sched_name=cfg.sched_name)

        # the towers are frozen: cast them to the compute dtype once
        self.state = TrainState(
            trainable=trainable,
            frozen=cast_towers(self.params, self.compute_dtype),
            make_opt=make_opt, gen=self.next_gen())
        log.info("%s trainable params: %d", type(self).__name__,
                 param_count(trainable))
        ccfg = self.clip_cfg
        self._pipeline = preprocess.make_train_pipeline(
            ccfg.image_size, self.train_dataset.mean, self.train_dataset.std,
            use_autoaug="autoaug" in cfg.transforms,
            out_dtype=self.compute_dtype)
        self._eval_pipeline = preprocess.make_eval_pipeline(
            ccfg.image_size, self.train_dataset.mean, self.train_dataset.std,
            out_dtype=self.compute_dtype)
        self.remat = cfg.remat or cfg.batchsize >= 256
        self._dp_mesh = self.resolve_dp_mesh(cfg.batchsize)
        self._eval_dp_mesh = self.resolve_dp_mesh(cfg.test_batchsize)

    # -- the step -------------------------------------------------------------
    def train_step(self, batch):
        """One update on ``batch`` (images uint8, labels, mask on the
        device; this rank's rows under the data-parallel road):
        augmentation, the objective, backward, optimizer step; advances the
        counter by the increments of every rank. Returns the step's
        metrics."""
        state, dp = self.state, self._dp_mesh
        gen = state.gen if dp is None else dp.fold_gen(state.gen)
        images = self._pipeline(gen, batch["images"])
        loss, logits, counter = self.objective(
            state.frozen, state.trainable, images, batch, self.counter)
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        stats = {"loss": loss.detach(), "acc": acc}
        counter = counter.detach()
        inc = [] if dp is None else [counter - self.counter]
        state.apply(loss, dp, mean=stats.values(), total=inc)
        self.counter = self.counter + inc[0] if inc else counter
        return stats

    def forward(self, fn, *args, **kw):
        """``fn(*args, **kw)``, checkpointed under remat."""
        if not self.remat:
            return fn(*args, **kw)
        return torch.utils.checkpoint.checkpoint(
            functools.partial(fn, **kw), *args, use_reentrant=False,
            preserve_rng_state=False)

    def online_step(self, images, labels, indices):
        cfg = self.cfg
        images, labels, _ = pad_batch(images, labels, cfg.batchsize)
        dp = self._dp_mesh
        batch = {"images": self._tensor(local_rows(images, dp)),
                 "labels": self._tensor(local_rows(self.vocab.remap(labels),
                                                   dp), torch.int64),
                 "mask": self._tensor(self.vocab.logit_mask(),
                                      torch.float32)}
        stats = {}
        for _ in range(max(int(cfg.online_iter), 1)):
            stats = self.train_step(batch)
        return stats

    # -- eval -----------------------------------------------------------------
    def prepare_eval(self):
        self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)

    def predict(self, images):
        with torch.no_grad():
            x = self._eval_pipeline(self._tensor(images))
            logits = self.logits(self.state.frozen, self.state.trainable, x,
                                 self.counter)
            return (logits + self._mask[None, :]).argmax(-1)

    # -- the counter lives outside TrainState: without it a resumed run
    # restarts the pool's selection statistics from their initial values
    def checkpoint_extra(self):
        extra = super().checkpoint_extra()
        key, name = self.EXTRA
        extra[key] = {name: self.counter.detach().cpu()}
        return extra

    def restore_extra(self, extra):
        super().restore_extra(extra)
        key, name = self.EXTRA
        st = (extra or {}).get(key)
        if st:
            self.counter = torch.as_tensor(st[name]).to(self.device)


def _head_init(d: int, c: int, device):
    return {"w": torch.zeros(d, c, device=device),
            "b": torch.zeros(c, device=device)}


class L2P(_PromptPoolTrainer):
    """L2P (JAX ``:31``): a pool of 10 prompts of length 5, 5 selected by
    the frequency-diversified key match, lambda 0.5."""

    pool_size = 10
    selection_size = 5
    prompt_len = 5
    lambd = 0.5
    diversified = True
    EXTRA = ("l2p", "frequency")

    def init_trainable(self):
        d, c = self.clip_cfg.vision_width, self.vocab.max_classes
        trainable = {
            "pool": vp.init_prompt_pool(self.next_gen(), self.pool_size,
                                        self.prompt_len, d, self.device),
            "head": _head_init(d, c, self.device)}
        return trainable, torch.ones(self.pool_size, device=self.device)

    def _forward(self, frozen, trainable, images, frequency, train):
        return vp.l2p_forward(
            frozen, trainable, images, self.clip_cfg, frequency=frequency,
            selection_size=self.selection_size, prompt_len=self.prompt_len,
            train=train, diversified=self.diversified,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)

    def objective(self, frozen, trainable, images, batch, frequency):
        logits, sim, counts = self.forward(self._forward, frozen, trainable,
                                           images, frequency, train=True)
        logits = logits + batch["mask"][None, :]
        loss = F.cross_entropy(logits, batch["labels"]) + self.lambd * sim
        return loss, logits, frequency + counts

    def logits(self, frozen, trainable, images, frequency):
        return self._forward(frozen, trainable, images, frequency, False)[0]


class DualPrompt(_PromptPoolTrainer):
    """DualPrompt (JAX ``:182``): a g-prompt of length 5 at layers (0, 1),
    an e-pool of ``n_tasks`` prompts of length 20 at layers (2, 3, 4),
    lambda 1."""

    pos_g = (0, 1)
    pos_e = (2, 3, 4)
    len_g = 5
    len_e = 20
    lambd = 1.0
    EXTRA = ("dualprompt", "e_frequency")

    def init_trainable(self):
        d, c = self.clip_cfg.vision_width, self.vocab.max_classes
        e_pool = self.cfg.stream.n_tasks
        trainable = {
            "g_pool": vp.init_prompt_pool(
                self.next_gen(), 1, len(self.pos_g) * self.len_g, d,
                self.device),
            "e_pool": vp.init_prompt_pool(
                self.next_gen(), e_pool, len(self.pos_e) * self.len_e, d,
                self.device),
            "head": _head_init(d, c, self.device)}
        return trainable, torch.ones(e_pool, device=self.device)

    def _forward(self, frozen, trainable, images, e_frequency, train):
        return vp.dualprompt_forward(
            frozen, trainable, images, self.clip_cfg,
            e_frequency=e_frequency, pos_g=self.pos_g, pos_e=self.pos_e,
            len_g=self.len_g, len_e=self.len_e, train=train,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)

    def objective(self, frozen, trainable, images, batch, e_frequency):
        logits, sim, counts = self.forward(self._forward, frozen, trainable,
                                           images, e_frequency, train=True)
        logits = logits + batch["mask"][None, :]
        loss = F.cross_entropy(logits, batch["labels"]) + self.lambd * sim
        return loss, logits, e_frequency + counts

    def logits(self, frozen, trainable, images, e_frequency):
        return self._forward(frozen, trainable, images, e_frequency,
                             False)[0]


def mvp_head_scores(feat, w, b, y, cls_mask, class_mask, use_mask: bool,
                    margin: float, dp=None):
    """(ign_score, cps_score) per sample from the linear head (JAX ``:338``,
    reference ``methods/mvp.py:_compute_grads`` + ``_get_ignore`` /
    ``_get_compensation``) in closed form: for ``z = (f @ W + b) * m + M``
    the per-sample gradient of CE_i w.r.t. head column c is ``(p_ic -
    1{c = y_i}) * m_ic * f_i``. Features and head are not normalized and
    the bias enters the softmax. No grad flows. ``dp``: the data-parallel
    mesh; the batch-mean gradient is then the global batch's."""
    with torch.no_grad():
        f = feat.float()
        z = mm32(f, w.float()) + b.float()
        m = cls_mask.float()
        if use_mask:
            z = z * m
        z = z + class_mask[None, :]
        coef = torch.softmax(z, -1) - F.one_hot(y, z.shape[1]).float()
        if use_mask:
            coef = coef * m                                      # (B, C)
        sample_grad = coef.gather(1, y[:, None]) * f             # (B, E)
        batch_grad = mm32(coef.T, f) / y.shape[0]                # (C, E)
        if dp is not None:
            dp.all_mean([batch_grad])
        batch_grad = batch_grad[y]                               # (B, E)

        def cos(a, bb, eps=1e-8):
            na = torch.linalg.vector_norm(a, dim=-1) + eps
            nb = torch.linalg.vector_norm(bb, dim=-1) + eps
            return (a * bb).sum(-1) / (na * nb)

        ign = 1.0 - cos(sample_grad, batch_grad)
        cps = 1.0 - cos(w.float().T[y], f) + margin
    return ign, cps


class MVP(_PromptPoolTrainer):
    """MVP on the ViT classifier (JAX ``:387``; reference methods/mvp.py +
    models/mvp.py): mvp-clip's prompt machinery (``models/mvp_clip.py:
    mvp_features``) with the query read from the raw block output (no final
    LN), an e-pool of 10 and a trainable linear head in place of text
    features. The flags default off as in the reference CLI;
    ``scripts/mvp.sh`` turns on mask, contrastive, AFS and GSF."""

    use_mask = False
    use_contrastiv = False
    use_afs = False
    use_gsf = False
    use_last_layer = False
    alpha = 0.5
    gamma = 2.0
    margin = 0.5
    e_pool = 10    # reference MVP(task_num=10): get_model never passes it
    EXTRA = ("mvp_vit", "count")

    def init_trainable(self):
        c, e = self.vocab.max_classes, self.clip_cfg.embed_dim
        trainable = init_mvp_params(self.next_gen(), self.clip_cfg,
                                    e_pool=self.e_pool, num_classes=c,
                                    device=self.device)
        trainable["head"] = _head_init(e, c, self.device)
        return trainable, torch.zeros(self.e_pool, device=self.device)

    def _features(self, frozen, trainable, count, images, train):
        return mvp_features(
            frozen, trainable, count, images, self.clip_cfg,
            use_contrastiv=self.use_contrastiv,
            use_last_layer=self.use_last_layer, train=train, query_ln=False,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
            dp=self._dp_mesh if train else None)

    def _head_logits(self, trainable, img, cls_mask, class_mask=None):
        logits = mm32(img.float(), trainable["head"]["w"]) \
            + trainable["head"]["b"]
        if self.use_mask:
            logits = logits * cls_mask
        return logits if class_mask is None else logits + class_mask[None, :]

    def objective(self, frozen, trainable, images, batch, count):
        img, cls_mask, sim_loss, new_count, _ = self.forward(
            self._features, frozen, trainable, count, images, train=True)
        head = trainable["head"]
        ign, cps = mvp_head_scores(
            img.detach(), head["w"].detach(), head["b"].detach(),
            batch["labels"], cls_mask.detach(), batch["mask"],
            self.use_mask, self.margin, dp=self._dp_mesh)
        img_used = img / cps[:, None].to(img.dtype) if self.use_afs else img
        logits = self._head_logits(trainable, img_used, cls_mask,
                                   batch["mask"])
        loss = F.cross_entropy(logits, batch["labels"])
        if self.use_gsf:
            # the reference's broadcast quirk (mvp.py:248-250): the CE is
            # mean-reduced before the (B,) ign ** gamma meets it
            gsf_w = (ign ** self.gamma).mean()
            if self._dp_mesh is not None:   # ign has no grad: a constant
                self._dp_mesh.all_mean([gsf_w])
            loss = (1 - self.alpha) * loss + self.alpha * gsf_w * loss
        return loss + sim_loss, logits, new_count

    def logits(self, frozen, trainable, images, count):
        img, cls_mask, _, _, _ = self._features(frozen, trainable, count,
                                                images, False)
        return self._head_logits(trainable, img, cls_mask)
