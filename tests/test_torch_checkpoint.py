"""Checkpoint/resume of the port (``utils/checkpoints.py``): a round trip of
the whole state, lossless resume for each ported method (as
``tests/test_checkpoint_obs.py::test_resume_equivalence_all_methods`` holds
the JAX package's), ``--ckpt_dir`` / ``--resume_from`` through ``main``,
and the trainers' steps on images the prefetcher hands over as tensors. On
the CPU the port's arithmetic is deterministic, so a resumed step equals
the uninterrupted one bit for bit."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import os

import numpy as np
import pytest
import torch

from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.config import (PEFTConfig, StreamConfig,
                                            TrainConfig)
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods import get_method
from lifelong_clip_tpu_torch.methods.base import OnlineTrainer
from lifelong_clip_tpu_torch.methods.engine import tree_leaves
from lifelong_clip_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                       restore_trainer)
from lifelong_clip_tpu_torch.utils.stream import iter_batches


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny trainers here gain nothing from intra-op threads, and under
    the suite's parallel workers those threads oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth():
    train = make_synthetic(n_classes=8, per_class=12, image_size=32, seed=0)
    test = make_synthetic(n_classes=8, per_class=3, image_size=32, seed=0,
                          train=False)
    return train, test


def _cfg(tmp_path, method, **kw):
    base = dict(method=method, dataset="synthetic-8", model_name="debug-tiny",
                batchsize=8, test_batchsize=8, online_iter=1, lr=1e-3,
                eval_period=16, memory_size=0,
                stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1),
                transforms=("autoaug",), use_bf16=False,
                log_path=str(tmp_path / "logs"),
                ckpt_dir=str(tmp_path / "ck"), device="cpu")
    base.update(kw)
    return TrainConfig(**base)


def _trainer(cfg, synth, use_mask=False):
    cls = get_method(cfg.method)
    if use_mask:
        cls = type(cls.__name__, (cls,), {"use_mask": True})
    return cls(cfg, train_dataset=synth[0], test_dataset=synth[1])


def _drive_task(tr, task_id):
    """One task as ``run`` drives it: before, every batch, after, the
    task-end eval."""
    tr.online_before_task(task_id)
    for batch_idx in iter_batches(tr.stream.task_indices[task_id],
                                  tr.cfg.batchsize):
        images, labels = tr.train_dataset.gather(batch_idx)
        tr.vocab.expose(labels)
        tr.online_step(images, labels, batch_idx)
        tr.samples_seen += len(batch_idx)
    tr.online_after_task(task_id)
    tr._task_end_eval(task_id)


def _first_task1_step(tr):
    tr.online_before_task(1)
    batch_idx = next(iter(iter_batches(tr.stream.task_indices[1],
                                       tr.cfg.batchsize)))
    images, labels = tr.train_dataset.gather(batch_idx)
    tr.vocab.expose(labels)
    return tr.online_step(images, labels, batch_idx)


CASES = {
    "lora-clip image": dict(method="lora-clip",
                            peft=PEFTConfig(encoder="image")),
    "lora-clip both": dict(method="lora-clip",
                           peft=PEFTConfig(encoder="both")),
    "lora-clip both, replay": dict(method="lora-clip", memory_size=16,
                                   temp_batchsize=4,
                                   peft=PEFTConfig(encoder="both")),
    "mvp-clip": dict(method="mvp-clip"),
    "maple": dict(method="maple"),
    "adapter-clip image": dict(method="adapter-clip",
                               peft=PEFTConfig(encoder="image")),
    "moe-clip image": dict(method="moe-clip",
                           peft=PEFTConfig(encoder="image")),
    "moe-clip both": dict(method="moe-clip", peft=PEFTConfig(encoder="both")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_equivalence(tmp_path, synth, case):
    """Train task 0, checkpoint, restore into a fresh trainer: the first
    task-1 step's loss and accuracy, the updated trainable tensors, the
    generator (augmentation draws; moe-clip's gate noise too) and the
    method's extra state (mvp-clip's e-prompt counts) equal the
    uninterrupted run's bit for bit."""
    cfg = _cfg(tmp_path, **CASES[case])
    mask = cfg.method == "mvp-clip"
    tr = _trainer(cfg, synth, use_mask=mask)
    _drive_task(tr, 0)
    tr._maybe_checkpoint(0)
    want = _first_task1_step(tr)

    tr2 = _trainer(cfg, synth, use_mask=mask)
    cursor = restore_trainer(tr2, cfg.ckpt_dir)
    assert cursor == {"task_id": 1, "samples_seen": tr.samples_seen,
                      "next_eval": tr._next_eval}
    got = _first_task1_step(tr2)
    for k in want:
        assert float(want[k]) == float(got[k]), k
    for a, b in zip(tree_leaves(tr.state.trainable),
                    tree_leaves(tr2.state.trainable)):
        assert torch.equal(a, b)
    assert torch.equal(tr.state.gen.get_state(), tr2.state.gen.get_state())
    assert tr.vocab.exposed == tr2.vocab.exposed
    if cfg.memory_size:
        assert tr.memory.indices == tr2.memory.indices
    extra, extra2 = tr.checkpoint_extra(), tr2.checkpoint_extra()
    assert extra.keys() == extra2.keys()
    if cfg.method == "mvp-clip":
        count = extra["mvp_clip"]["count"]
        assert count.sum() > 0
        assert torch.equal(count, extra2["mvp_clip"]["count"])


def test_checkpoint_round_trip(tmp_path, synth):
    """Everything the checkpoint holds comes back: trainable tensors,
    optimizer moments, schedule, step, generator, memory, vocabulary,
    metrics and the cursor."""
    cfg = _cfg(tmp_path, "lora-clip", memory_size=16, temp_batchsize=4,
               peft=PEFTConfig(encoder="both"))
    tr = _trainer(cfg, synth)
    _drive_task(tr, 0)
    tr._maybe_checkpoint(0)
    ck = load_checkpoint(cfg.ckpt_dir)
    assert ck["cursor"]["task_id"] == 1
    assert ck["state"]["step"] == tr.state.step > 0

    tr2 = _trainer(cfg, synth)
    restore_trainer(tr2, cfg.ckpt_dir)
    for a, b in zip(tree_leaves(tr.state.trainable),
                    tree_leaves(tr2.state.trainable)):
        assert torch.equal(a, b)
    s1, s2 = tr.state.opt.state_dict(), tr2.state.opt.state_dict()
    for i in s1["state"]:
        for k in s1["state"][i]:
            assert torch.equal(torch.as_tensor(s1["state"][i][k]),
                               torch.as_tensor(s2["state"][i][k])), (i, k)
    assert tr.state.sched.state_dict() == tr2.state.sched.state_dict()
    assert tr.state.step == tr2.state.step
    assert torch.equal(tr.state.gen.get_state(), tr2.state.gen.get_state())
    assert tr.memory.state_dict()["indices"] == tr2.memory.state_dict()[
        "indices"]
    assert tr.vocab.exposed == tr2.vocab.exposed
    assert tr.metrics.task_acc == tr2.metrics.task_acc
    assert [e.step for e in tr.metrics.eval_points] == \
        [e.step for e in tr2.metrics.eval_points]


def _result(log_path):
    found = [os.path.join(d, "result.txt") for d, _, fs in os.walk(log_path)
             if "result.txt" in fs]
    assert len(found) == 1
    return open(found[0]).read()


class _Preempted(Exception):
    """Stands for a run killed right after a checkpoint."""


@pytest.mark.parametrize("method", [["--method", "lora-clip",
                                     "--peft_encoder", "both"],
                                    ["--method", "mvp-clip", "--use_mask"],
                                    ["--method", "maple"]])
def test_ckpt_dir_and_resume_from_through_main(tmp_path, monkeypatch,
                                               method):
    """The CLI with its default ``--transforms`` (AutoAugment) writes a
    checkpoint after each task. A run stopped right after task 0's
    checkpoint and resumed ``--resume_from`` it trains task 1 through
    ``run`` and ends where the uninterrupted run ends: the same result and
    result.txt, and the same trainable tensors in the last checkpoint."""
    args = ["--model_name", "debug-tiny", "--dataset", "synthetic-10x8",
            "--n_tasks", "2", "--device", "cpu"] + method
    ck_full, ck_cut = str(tmp_path / "ck_full"), str(tmp_path / "ck_cut")
    full = cli.main(args + ["--log_path", str(tmp_path / "a"),
                            "--ckpt_dir", ck_full])

    save = OnlineTrainer._maybe_checkpoint

    def preempt_after_task_0(self, task_id):
        save(self, task_id)
        if task_id == 0:
            raise _Preempted

    with monkeypatch.context() as m:
        m.setattr(OnlineTrainer, "_maybe_checkpoint", preempt_after_task_0)
        with pytest.raises(_Preempted):
            cli.main(args + ["--log_path", str(tmp_path / "b"),
                             "--ckpt_dir", ck_cut])
    assert load_checkpoint(ck_cut)["cursor"]["task_id"] == 1
    resumed = cli.main(args + ["--log_path", str(tmp_path / "c"),
                               "--ckpt_dir", ck_cut, "--resume_from", ck_cut])
    assert resumed == full
    assert _result(tmp_path / "a") == _result(tmp_path / "c")
    want, got = load_checkpoint(ck_full), load_checkpoint(ck_cut)
    assert want["cursor"] == got["cursor"] and got["cursor"]["task_id"] == 2
    for a, b in zip(want["state"]["trainable"], got["state"]["trainable"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["lora-clip both, replay", "mvp-clip",
                                  "maple"])
def test_online_step_takes_images_as_tensors(tmp_path, synth, case):
    """The prefetcher hands ``online_step`` its images as a tensor on the
    trainer's device: a step on them (padded, and concatenated with replay
    samples) equals the step on the host array bit for bit."""
    cfg = _cfg(tmp_path, **CASES[case])
    out = []
    for as_tensor in (False, True):
        tr = _trainer(cfg, synth)
        _drive_task(tr, 0)
        tr.online_before_task(1)
        idx = tr.stream.task_indices[1][:5]      # a short batch: padded
        images, labels = tr.train_dataset.gather(idx)
        if as_tensor:
            images = torch.from_numpy(images)
        tr.vocab.expose(labels)
        out.append((tr.online_step(images, labels, idx),
                    tree_leaves(tr.state.trainable)))
    (want, wl), (got, gl) = out
    assert float(want["loss"]) == float(got["loss"])
    assert all(torch.equal(a, b) for a, b in zip(wl, gl))
