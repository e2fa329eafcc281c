"""ProtoCLIP trainer (``adapter-clip-proto_prompt``, ``template``): two-stage
prototype and prompt online learning.

Counterpart of ``lifelong_clip_tpu/methods/proto_clip.py`` (reference
``methods/Trainer_ProtoCLIP.py``):

* stage 1, online: cross entropy over per-(sample, class) prompt-pool
  logits on the step's classes (``models/proto_clip.py``), with the
  prefix-shared text pass at the suffix length ``choose_suffix_len`` gives;
* at a task's end: one batched feature sweep of the plain tower over the
  task's samples, per-class fp64 means and covariances the first time a
  class has a prototype, the semantic-drift displacement of the old
  prototypes (``displacement``);
* at the next task's start: the optimizer reset, the pre-task features of
  the incoming samples, and the CoPL task advance with a Gram-Schmidt
  re-init of the pools;
* stage 2, from the second task on: per-class multivariate-normal feature
  draws from ``np.random.default_rng(seed + task_count)`` (the same host
  numpy draws as JAX's, bit for bit) and SGD with momentum 0.9 on an
  epoch-cosine learning rate over the text pools;
* eval through a cache of the text features of every ordered top-k prompt
  selection (90 at P = 10, k = 2), gathered per sample.

Prototypes, covariances, the task counter and the task's sample list live
outside the train state and are saved with a checkpoint
(``checkpoint_extra``). A data-parallel mesh runs stage 1 on each rank's
rows and eval on its rows (JAX ``:103-180``); stage 2 and the feature
sweeps of the task boundary run whole on every rank, as JAX's stay
replicated.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..models import build_clip
from ..models import clip as clip_fns
from ..models import proto_clip as pc
from ..models.clip import cast_towers
from ..models.init import param_count
from ..models.vit_prompt import top_k_indices
from ..ops import preprocess
from ..ops.attention import mm32
from ..parallel.mesh import local_rows
from ..utils.class_vocab import ClassVocabulary
from ..utils.train_utils import make_optimizer
from .base import OnlineTrainer, pad_batch
from .engine import TrainState, fill_missing_grads, tree_leaves

log = logging.getLogger("lifelong_clip_tpu_torch")


def displacement(Y1: np.ndarray, Y2: np.ndarray, embedding_old: np.ndarray,
                 sigma: float) -> np.ndarray:
    """Semantic-drift displacement of the old prototypes (C, e) by the
    Gaussian-kernel weighted mean of the drifts ``Y2 - Y1`` of the same
    samples under the pre- and post-task model (JAX ``:41``, reference
    ``Trainer_ProtoCLIP.py:441-450``), in fp64."""
    Y1 = np.asarray(Y1, np.float64)
    Y2 = np.asarray(Y2, np.float64)
    embedding_old = np.asarray(embedding_old, np.float64)
    DY = Y2 - Y1                                                  # (n, e)
    distance = ((Y1[None, :, :] - embedding_old[:, None, :]) ** 2
                ).sum(axis=2)                                     # (C, n)
    W = np.exp(-distance / (2 * sigma ** 2)) + 1e-5
    W_norm = W / W.sum(axis=1, keepdims=True)
    return W_norm @ DY                                            # (C, e)


def _is_pd(cov: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(cov)
        return True
    except np.linalg.LinAlgError:
        return False


class Trainer_ProtoCLIP(OnlineTrainer):
    """The JAX trainer's (``:64``) knobs; ``main.py`` maps ``--num_prompt``,
    ``--n_ctx``, ``--topK``, ``--num_sampled_pcls``, ``--ca``, ``--ssca``
    and ``--ca_epochs`` onto them."""

    num_prompt = 10
    n_ctx = 12
    top_k = 2
    num_sampled_pcls = 64
    ca_epochs = 5
    stage2_lr = 5e-3
    sigma_drift = 4.0
    copl_n_tasks = 10    # reference CoPLPrompt(768, 10, ...): always 10
    ca = True            # the stage-2 compact classifier (--ca)
    ssca = True          # semantic drift compensation (--ssca)
    attn_impl = "fused"  # the towers' road (models/clip.py)

    def setup_model(self):
        cfg = self.cfg
        dev = self.device
        self.params, self.clip_cfg = build_clip(
            cfg.model_name, cfg.pretrained_path, gen=self.next_gen(),
            device=dev)
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        prefix = " ".join(["x"] * self.n_ctx * self.top_k)
        self.vocab = ClassVocabulary(
            self.train_dataset.class_names,
            max_classes=cfg.max_classes or self.n_classes,
            template=prefix + " {}.")
        proto = pc.init_proto_params(self.next_gen(), self.clip_cfg,
                                     num_prompt=self.num_prompt,
                                     n_ctx=self.n_ctx, device=dev)

        def make_opt(leaves):
            return make_optimizer(cfg.opt_name, leaves, cfg.lr,
                                  sched_name=cfg.sched_name)

        # the towers are frozen: cast them to the compute dtype once
        self.state = TrainState(
            trainable=proto, frozen=cast_towers(self.params,
                                                self.compute_dtype),
            make_opt=make_opt, gen=self.next_gen())
        log.info("ProtoCLIP trainable params: %d", param_count(proto))
        self.step_capacity = min(self.vocab.max_classes, cfg.batchsize)
        self.task_count = 0
        self._dp_mesh = self.resolve_dp_mesh(cfg.batchsize)
        self._eval_dp_mesh = self.resolve_dp_mesh(cfg.test_batchsize)

        e = self.clip_cfg.embed_dim
        self._class_means = np.zeros((self.vocab.max_classes, e), np.float64)
        self._class_covs = np.zeros((self.vocab.max_classes, e, e),
                                    np.float64)
        self._have_proto = np.zeros((self.vocab.max_classes,), bool)
        self._task_samples: list = []
        self._old_feats = None

        ccfg = self.clip_cfg
        self._pipeline = preprocess.make_train_pipeline(
            ccfg.image_size, self.train_dataset.mean, self.train_dataset.std,
            use_autoaug="autoaug" in cfg.transforms,
            out_dtype=self.compute_dtype)
        self._eval_pipeline = preprocess.make_eval_pipeline(
            ccfg.image_size, self.train_dataset.mean, self.train_dataset.std,
            out_dtype=self.compute_dtype)
        lp = 1 + min(self.top_k, self.num_prompt) * self.n_ctx
        self.suffix_len = pc.choose_suffix_len(self.vocab.max_token_pos(), lp,
                                               ccfg.context_length)
        # --remat / bs >= 256: checkpoint the prompted image tower (the
        # text passes checkpoint each layer anyway)
        self.remat_img = cfg.remat or cfg.batchsize >= 256
        combos, lookup = pc.prompt_combinations(self.num_prompt, self.top_k)
        self._combos = None if combos is None else torch.as_tensor(
            combos, dtype=torch.int64, device=dev)
        self._comb_lookup = None if lookup is None else torch.as_tensor(
            lookup, dtype=torch.int64, device=dev)
        self._txt_comb = None

    # -- the towers -----------------------------------------------------------
    def encode_image(self, proto, images, train: bool):
        fn = pc.proto_encode_image
        kw = dict(task_count=self.task_count, n_tasks=self.copl_n_tasks,
                  train=train, compute_dtype=self.compute_dtype,
                  attn_impl=self.attn_impl)
        if train and self.remat_img:
            return torch.utils.checkpoint.checkpoint(
                lambda p, x: fn(self.state.frozen, p, x, self.clip_cfg, **kw),
                proto, images, use_reentrant=False, preserve_rng_state=False)
        return fn(self.state.frozen, proto, images, self.clip_cfg, **kw)

    def text_features(self, proto, img, tokens):
        return pc.proto_text_features(
            self.state.frozen, proto, img, tokens, self.clip_cfg,
            top_k=self.top_k, n_ctx=self.n_ctx, suffix_len=self.suffix_len,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)[0]

    def stage1_loss(self, batch):
        """Stage 1's loss and logits on a batch dict (tensors on the
        device: uint8 images, remapped labels, the class token table and
        its -inf padding mask)."""
        state, dp = self.state, self._dp_mesh
        gen = state.gen if dp is None else dp.fold_gen(state.gen)
        images = self._pipeline(gen, batch["images"])
        img = self.encode_image(state.trainable, images, train=True)
        txt = self.text_features(state.trainable, img, batch["tokens"])
        logits = pc.proto_logits(state.frozen, img, txt) \
            + batch["mask"][None, :]
        return F.cross_entropy(logits, batch["labels"]), logits

    def stage1_step(self, batch):
        loss, logits = self.stage1_loss(batch)
        with torch.no_grad():
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        stats = {"loss": loss.detach(), "acc": acc}
        self.state.apply(loss, self._dp_mesh, mean=stats.values())
        return stats

    # -- task boundary: optimizer reset, pre-task features, pool advance ----
    def online_before_task(self, task_id):
        """The reference's order (``Trainer_ProtoCLIP.py:57-91``): the
        optimizer reset, the incoming task's samples under the pre-task
        model (so the drift pairs the same images), then the CoPL task
        advance with the Gram-Schmidt re-init, first seen by this task's
        steps."""
        if task_id > 0:
            self.state.reset_optimizer()
        idx = np.asarray(self.stream.task_indices[task_id], np.int64)
        if self.cfg.debug:
            idx = idx[:500]
        self._sdc_idx = np.unique(idx)
        if self._have_proto.any():
            log.info("SDC: extracting %d samples with pre-task model",
                     len(self._sdc_idx))
            self._old_feats = self._batched_features(self._sdc_idx)
        else:
            self._old_feats = None
        if task_id > 0:
            self.task_count += 1
            with torch.no_grad():
                for leaf in self.state.trainable["copl"].values():
                    leaf.copy_(torch.from_numpy(pc.gram_schmidt(
                        leaf.detach().cpu().numpy())))

    # -- stage 1 ----------------------------------------------------------------
    def online_step(self, images, labels, indices):
        cfg = self.cfg
        images, labels, _ = pad_batch(images, labels, cfg.batchsize)
        if cfg.visible_classes == "batch":
            tokens, mask, y, _ = self.vocab.batch_table(labels,
                                                        self.step_capacity)
        else:
            tokens = self.vocab.token_table
            mask = self.vocab.logit_mask()
            y = self.vocab.remap(labels)
        dp = self._dp_mesh
        batch = {"images": self._tensor(local_rows(images, dp)),
                 "labels": self._tensor(local_rows(y, dp), torch.int64),
                 "tokens": self._tensor(tokens, torch.int64),
                 "mask": self._tensor(mask, torch.float32)}
        stats = {}
        for _ in range(max(int(cfg.online_iter), 1)):
            stats = self.stage1_step(batch)
        self._task_samples.extend(int(i) for i in indices)
        return stats

    # -- task end: prototypes, drift, stage 2 --------------------------------
    def online_after_task(self, task_id):
        idx = getattr(self, "_sdc_idx", None)
        if idx is None:
            idx = np.asarray(sorted(set(self._task_samples)), np.int64)
        if len(idx) == 0:
            return
        feats = self._batched_features(idx)
        # the old prototypes move with the drift of the same samples
        # (reference stage1_and_stage2():267-280), before new ones are built
        if self.ssca and self._old_feats is not None \
                and self._have_proto.any():
            slots = np.nonzero(self._have_proto)[0]
            self._class_means[slots] += displacement(
                self._old_feats, feats, self._class_means[slots],
                self.sigma_drift)
        # each class's mean and covariance (fp64, + 1e-3 I), once, over all
        # its train samples under the eval transform (:308-358)
        targets = np.asarray(self.train_dataset.targets)
        for c in self.vocab.exposed:
            slot = self.vocab.remap([c])[0]
            if self._have_proto[slot]:
                continue
            cls_idx = np.nonzero(targets == int(c))[0]
            if len(cls_idx) == 0:
                continue
            f = self._batched_features(cls_idx).astype(np.float64)
            self._class_means[slot] = f.mean(axis=0)
            cov = np.cov(f.T) if len(f) > 1 else np.eye(f.shape[1])
            self._class_covs[slot] = cov + 1e-3 * np.eye(f.shape[1])
            self._have_proto[slot] = True
        self._old_feats = None
        if task_id > 0 and self.ca_epochs > 0 and self.ca:
            self._stage2(task_id)
        self._task_samples = []

    def checkpoint_extra(self):
        extra = super().checkpoint_extra()
        extra["proto"] = {
            "task_count": self.task_count,
            "class_means": np.asarray(self._class_means),
            "class_covs": np.asarray(self._class_covs),
            "have_proto": np.asarray(self._have_proto),
            "task_samples": list(self._task_samples),
        }
        return extra

    def restore_extra(self, extra):
        super().restore_extra(extra)
        st = (extra or {}).get("proto")
        if not st:
            return
        self.task_count = int(st["task_count"])
        self._class_means = np.asarray(st["class_means"], np.float64)
        self._class_covs = np.asarray(st["class_covs"], np.float64)
        self._have_proto = np.asarray(st["have_proto"], bool)
        self._task_samples = list(st["task_samples"])

    @torch.no_grad()
    def extract_plain(self, images_u8):
        """Normalized features of the plain tower (no CoPL prompts), as the
        reference extracts them (``AdapterCLIP.encode_image``)."""
        x = self._eval_pipeline(images_u8)
        f = clip_fns.encode_image(self.state.frozen, x, self.clip_cfg,
                                  compute_dtype=self.compute_dtype,
                                  attn_impl=self.attn_impl)
        return clip_fns.normalize(f)

    def _batched_features(self, idx: np.ndarray) -> np.ndarray:
        bs = self.cfg.batchsize
        out = np.zeros((len(idx), self.clip_cfg.embed_dim), np.float32)
        for lo in range(0, len(idx), bs):
            chunk = idx[lo:lo + bs]
            imgs, _ = self.train_dataset.gather(chunk)
            n = len(chunk)
            if n < bs:
                imgs = np.concatenate([imgs, imgs[:bs - n]])[:bs]
            f = self.extract_plain(self._tensor(imgs)).float().cpu().numpy()
            out[lo:lo + n] = f[:n]
        return out

    def _stage2(self, task_id):
        """MVN feature draws per prototype'd class; SGD over the text pools
        (reference ``_stage2_compact_classifier():452-566``)."""
        slots = np.nonzero(self._have_proto)[0]
        if len(slots) == 0:
            return
        rng = np.random.default_rng(self.cfg.seed + self.task_count)
        task_size = max(len(self.stream.disjoint_classes[task_id]), 1)
        # SGD(momentum 0.9, no decay) under CosineAnnealingLR(T_max =
        # ca_epochs) stepped once an epoch (:476-481, :564): the rate is
        # constant within an epoch
        nb_per_epoch = max(len(slots) * self.num_sampled_pcls // 16, 1)
        leaves = tree_leaves(self.state.trainable)
        opt = torch.optim.SGD(leaves, lr=self.stage2_lr, momentum=0.9)
        tokens = self._tensor(self.vocab.token_table, torch.int64)
        # stage 2's CE runs over exactly the prototype'd classes
        mask = self._tensor(np.where(self._have_proto, 0.0, -np.inf),
                            torch.float32)
        sample_batch, step = 16, 0
        for epoch in range(self.ca_epochs):
            feats, labels = self._stage2_sample_epoch(slots, task_size, rng)
            total, nb = 0.0, len(labels) // sample_batch
            for i in range(nb):
                sl = slice(i * sample_batch, (i + 1) * sample_batch)
                e = min(step // nb_per_epoch, self.ca_epochs)
                for group in opt.param_groups:
                    group["lr"] = self.stage2_lr * 0.5 * (
                        1.0 + math.cos(math.pi * e / self.ca_epochs))
                loss = self._stage2_loss(self._tensor(feats[sl]),
                                         self._tensor(labels[sl]),
                                         tokens, mask)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                fill_missing_grads(leaves)
                opt.step()
                step += 1
                total += float(loss.detach())
            log.info("stage2 epoch %d | loss %.4f", epoch,
                     total / max(nb, 1))

    def _stage2_loss(self, feats, labels, tokens, mask):
        f = feats.float()
        img = (f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True)
                    + 1e-8)).to(self.compute_dtype)
        txt = self.text_features(self.state.trainable, img, tokens)
        logits = pc.proto_logits(self.state.frozen, img, txt) + mask[None, :]
        return F.cross_entropy(logits, labels)

    def _stage2_sample_epoch(self, slots, task_size, rng):
        """One epoch's shuffled MVN feature draws (reference :507-524): the
        ``num_sampled_pcls`` draws of each class from MVN(mean * (0.9 +
        decay), cov), concatenated, permuted."""
        feats_list, label_list = [], []
        for slot in slots:
            t_id = int(slot) // task_size
            decay = (t_id + 1) / (self.task_count + 1) * 0.1
            mean = self._class_means[slot] * (0.9 + decay)
            f = rng.multivariate_normal(
                mean, self._class_covs[slot], size=self.num_sampled_pcls,
                method="cholesky" if _is_pd(self._class_covs[slot])
                else "svd")
            feats_list.append(f.astype(np.float32))
            label_list.extend([int(slot)] * self.num_sampled_pcls)
        feats = np.concatenate(feats_list)
        labels = np.asarray(label_list, np.int64)
        perm = rng.permutation(len(labels))
        return feats[perm], labels[perm]

    # -- eval -----------------------------------------------------------------
    def prepare_eval(self):
        self._mask = self._tensor(self.vocab.logit_mask(), torch.float32)
        self._tokens = self._tensor(self.vocab.token_table, torch.int64)
        self._txt_comb = None
        if self._combos is not None:
            # the trainable tree and the class set hold for the whole
            # sweep: one pass over every prompt combination serves it
            with torch.no_grad():
                proto = self.state.trainable
                d = proto["text_prompt"].shape[-1]
                ctx = proto["text_prompt"][self._combos].reshape(
                    len(self._combos), -1, d)
                self._txt_comb = pc.text_features_for_ctx(
                    self.state.frozen, ctx, self._tokens, self.clip_cfg,
                    suffix_len=self.suffix_len,
                    compute_dtype=self.compute_dtype,
                    attn_impl=self.attn_impl)

    def predict(self, images):
        with torch.no_grad():
            proto = self.state.trainable
            x = self._eval_pipeline(self._tensor(images))
            img = self.encode_image(proto, x, train=False)
            if self._txt_comb is not None:
                prob = mm32(img.float(), proto["text_key"].float().T)
                idx = top_k_indices(prob, min(self.top_k,
                                                 prob.shape[1]))
                cid = self._comb_lookup[pc.fold_selection(idx,
                                                          self.num_prompt)]
                txt = self._txt_comb[cid]
            else:
                txt = self.text_features(proto, img, self._tokens)
            logits = pc.proto_logits(self.state.frozen, img, txt) \
                + self._mask[None, :]
            return logits.argmax(-1)
