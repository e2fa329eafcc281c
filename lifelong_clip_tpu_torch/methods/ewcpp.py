"""EWC++ (``ewc++``): online Fisher-information regularization.

Counterpart of ``lifelong_clip_tpu/methods/ewcpp.py`` (reference
``methods/ewcpp.py``): each step makes two updates, a plain cross-entropy
one and, at the updated point, cross entropy plus ``reg_coef`` times the
importance-weighted distance to the last task's parameters. The second
update, the Fisher EMA and the path-integral score see the accumulated
grad g1 + g2 (torch never zeroes the grads between the reference's two
backwards); the step count, hence Adam's count and the schedule, advances
by two. The penalty leaves the head out (``_reg_scope``): with ER's
head-only tree EWC++ is a double cross-entropy update. At a task's end the
Fisher becomes the importance and the parameters are snapshotted; a
checkpoint keeps the whole ``ewc_state``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .engine import fill_missing_grads, tree_leaves, tree_map
from .er_baseline import ER


def _reg_scope(tree):
    """The regularized set: every parameter but the classifier head's
    (reference ``named_parameters()[:-2]``, ewcpp.py:27-30)."""
    return {k: v for k, v in tree.items() if k != "head"}


def _all_finite(*tensors):
    """One device bool: every element of every tensor is finite."""
    ok = torch.isfinite(tensors[0]).all()
    for t in tensors[1:]:
        ok = ok & torch.isfinite(t).all()
    return ok


class EWCpp(ER):

    alpha = 0.5          # Fisher EMA coefficient (reference default)
    eps = 1e-3

    def setup_model(self):
        super().setup_model()
        self.reg_coef = float(self.cfg.reg_coef)
        tr = self.state.trainable
        self.ewc_state = {
            "fisher": tree_map(torch.zeros_like, tr),
            "score": tree_map(torch.zeros_like, tr),
            "importance": tree_map(torch.zeros_like, tr),
            "task_param": tree_map(lambda p: p.detach().clone(), tr),
            # 0 until the first task's end
            "has_reg": torch.zeros((), device=self.device)}

    def _ce(self, trainable, images, batch):
        """(cross entropy, masked logits); the forward checkpointed under
        remat (this step differentiates two forwards back to back)."""
        fwd = (functools.partial(torch.utils.checkpoint.checkpoint,
                                 self._fwd, use_reentrant=False,
                                 preserve_rng_state=False)
               if self.remat else self._fwd)
        logits = fwd(self.state.frozen, trainable, images, None)[0]
        logits = logits + batch["mask"][None, :]
        return F.cross_entropy(logits, batch["labels"]), logits

    def _grads(self, loss, leaves):
        """Leave ``loss``'s grads in the leaves' ``.grad`` (zeros where it
        does not reach, as optax sees them)."""
        self.state.opt.zero_grad(set_to_none=True)
        loss.backward()
        fill_missing_grads(leaves)

    def ewc_step(self, batch):
        """The double update and the Fisher/score bookkeeping (JAX
        ``step``, ``ewcpp.py:96-167``)."""
        state, ewc = self.state, self.ewc_state
        images = self._pipeline(state.gen, batch["images"])
        leaves = tree_leaves(state.trainable)

        # update 1: plain cross entropy
        loss1, _ = self._ce(state.trainable, images, batch)
        self._grads(loss1, leaves)
        g1 = tree_map(lambda p: p.grad.clone(), state.trainable)
        state.opt.step()
        state.sched.step()
        mid = tree_map(lambda p: p.detach().clone(), state.trainable)

        # update 2: cross entropy + the penalty at the updated point, on the
        # accumulated grad g1 + g2
        loss2, logits = self._ce(state.trainable, images, batch)
        scope = (_reg_scope(ewc["importance"]), _reg_scope(state.trainable),
                 _reg_scope(ewc["task_param"]))
        reg = sum((imp * (p - p0) ** 2).sum()
                  for imp, p, p0 in zip(*map(tree_leaves, scope)))
        loss2 = loss2 + self.reg_coef * ewc["has_reg"] * reg
        self._grads(loss2, leaves)
        for p, a in zip(leaves, tree_leaves(g1)):
            p.grad = a + p.grad
        g2 = tree_map(lambda p: p.grad, state.trainable)
        state.opt.step()
        state.sched.step()
        state.step += 2

        # the Fisher EMA and the path-integral score; a leaf with any inf or
        # nan in its parameters or grads keeps its old values
        def upd_score(s, a, g, pn, pm, f):
            denom = 0.5 * f * (pn - pm) ** 2 + self.eps
            return torch.where(_all_finite(pn, pm, a, g),
                               s + (a - g) * (pn - pm) / denom, s)

        def upd_fisher(f, g, pn, pm, a):
            ema = torch.where((f == 0).all(), g ** 2,
                              (1 - self.alpha) * f + self.alpha * g ** 2)
            return torch.where(_all_finite(pn, pm, a, g), ema, f)

        with torch.no_grad():
            new = tree_map(lambda p: p.detach(), state.trainable)
            ewc["score"] = tree_map(upd_score, ewc["score"], g1, g2, new,
                                    mid, ewc["fisher"])
            ewc["fisher"] = tree_map(upd_fisher, ewc["fisher"], g2, new, mid,
                                     g1)
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return {"loss": loss2.detach(), "acc": acc}

    def online_step(self, images, labels, indices):
        batch = self.stream_batch(images, labels)
        stats = {}
        for _ in range(max(int(self.cfg.online_iter), 1)):
            stats = self.ewc_step(batch)
        self.update_memory(indices, labels)
        return stats

    def online_after_task(self, task_id):
        # importance <- the Fisher; snapshot the parameters; reset the score
        ewc = self.ewc_state
        ewc["importance"] = ewc["fisher"]
        ewc["task_param"] = tree_map(lambda p: p.detach().clone(),
                                     self.state.trainable)
        ewc["score"] = tree_map(torch.zeros_like, ewc["score"])
        ewc["has_reg"] = torch.ones((), device=self.device)

    # -- without this a resumed run zeroes the Fisher and the score and loses
    # the task-end importance and parameter snapshot
    def checkpoint_extra(self):
        return {"ewc": tree_map(lambda t: t.cpu(), self.ewc_state)}

    def restore_extra(self, extra):
        st = (extra or {}).get("ewc")
        if st:
            self.ewc_state = tree_map(lambda t: t.to(self.device), st)
