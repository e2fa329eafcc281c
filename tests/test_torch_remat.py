"""``--remat`` in the port's train steps, held to the JAX package's own
tests of it (``tests/test_engine.py:235-320``, ``tests/test_remat_flag.py``):
remat is a pure scheduling change, so a step with it gives the loss, grads
and updates of the step without it; ``--remat`` and ``batchsize >= 256``
reach the lora-clip, MaPLe and mvp-clip steps; the prompt trainers' and
the ER family's (er, Finetuning, lwf with its KD step, ewc++) remat'd
online steps equal their plain ones; ``remat_fallback`` rebuilds a step
once with remat after the card runs out of memory.

On the CPU the fused ops take their plain versions, which are
deterministic, so remat'd and plain steps agree bit for bit. Torch only, on
the ``debug-tiny`` tower.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import logging

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.config import CLIP_PRESETS, PEFTConfig
from lifelong_clip_tpu_torch.methods import engine
from lifelong_clip_tpu_torch.methods.mvp_clip import (make_mvp_text_fn,
                                                      make_mvp_train_step)
from lifelong_clip_tpu_torch.models import build_clip, build_peft
from lifelong_clip_tpu_torch.models.clip import cast_towers
from lifelong_clip_tpu_torch.models.maple import (init_maple_params,
                                                  maple_forward)
from lifelong_clip_tpu_torch.models.mvp_clip import init_mvp_params
from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer

CFG = CLIP_PRESETS["debug-tiny"]
MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.26, 0.27)
N_CLS, BS = 6, 4


@pytest.fixture
def checkpoint_calls(monkeypatch):
    """Counts calls to ``torch.utils.checkpoint.checkpoint``."""
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    return calls


def _data():
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (BS, 32, 32, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, N_CLS, (BS,)))
    tokens = np.zeros((N_CLS, CFG.context_length), np.int64)
    tokens[:, 0] = 49406
    tokens[:, 1:5] = rng.integers(1000, 40000, (N_CLS, 4))
    tokens[:, 5] = 49407
    return images, labels, torch.from_numpy(tokens)


def _lora_clip(remat):
    params, cfg = build_clip("debug-tiny", gen=torch.Generator().manual_seed(0),
                             device="cpu")
    frozen = cast_towers(params, torch.float32)
    peft_cfg = PEFTConfig(method="lora", encoder="image", lora_r=4)
    peft = build_peft(torch.Generator().manual_seed(1), cfg, peft_cfg,
                      device="cpu")
    state = engine.TrainState(
        trainable=peft, frozen=frozen,
        make_opt=lambda lv: make_optimizer("adamw", lv, 1e-3),
        gen=torch.Generator().manual_seed(2))
    step = engine.make_train_step(cfg, peft_cfg, image_size=cfg.image_size,
                                  mean=MEAN, std=STD,
                                  compute_dtype=torch.float32,
                                  loss_fn=engine.ce_on_probs_loss,
                                  cached_text=True, remat=remat)
    images, labels, tokens = _data()
    txt = engine.make_text_feature_fn(cfg, peft_cfg,
                                      compute_dtype=torch.float32)(
        frozen, peft, tokens)
    batch = {"images": images, "labels": labels, "tokens": txt,
             "mask": torch.zeros(N_CLS)}
    return state, lambda: step(state, batch)["loss"]


def _maple(remat):
    params, cfg = build_clip("debug-tiny", gen=torch.Generator().manual_seed(0),
                             device="cpu")
    learner = init_maple_params(torch.Generator().manual_seed(1), params, cfg,
                                n_ctx=3, depth=3, device="cpu")
    state = engine.TrainState(
        trainable=learner, frozen=cast_towers(params, torch.float32),
        make_opt=lambda lv: make_optimizer("adamw", lv, 1e-3),
        gen=torch.Generator().manual_seed(2))
    step = engine.make_train_step(
        cfg, PEFTConfig(method="maple"), image_size=cfg.image_size,
        mean=MEAN, std=STD, compute_dtype=torch.float32,
        forward_fn=lambda f, tr, im, tok: maple_forward(
            f, tr, im, tok, cfg, 3, torch.float32),
        remat=remat)
    images, labels, tokens = _data()
    batch = {"images": images, "labels": labels, "tokens": tokens,
             "mask": torch.zeros(N_CLS)}
    return state, lambda: step(state, batch)["loss"]


def _mvp_clip(remat):
    params, cfg = build_clip("debug-tiny", gen=torch.Generator().manual_seed(0),
                             device="cpu")
    frozen = cast_towers(params, torch.float32)
    mvp = init_mvp_params(torch.Generator().manual_seed(1), cfg, e_pool=10,
                          num_classes=N_CLS, device="cpu")
    state = engine.TrainState(
        trainable=mvp, frozen=frozen,
        make_opt=lambda lv: make_optimizer("adamw", lv, 1e-3),
        gen=torch.Generator().manual_seed(2))
    step = make_mvp_train_step(cfg, image_size=cfg.image_size, mean=MEAN,
                               std=STD, compute_dtype=torch.float32,
                               use_mask=True, use_contrastiv=True,
                               use_afs=True, use_gsf=True, remat=remat)
    images, labels, tokens = _data()
    batch = {"images": images, "labels": labels,
             "txt": make_mvp_text_fn(cfg, compute_dtype=torch.float32)(
                 frozen, tokens),
             "mask": torch.zeros(N_CLS), "slot_globals": torch.arange(N_CLS)}
    return state, lambda: step(state, batch, torch.zeros(10))[1]["loss"]


STEPS = {"lora-clip": _lora_clip, "maple": _maple, "mvp-clip": _mvp_clip}


@pytest.mark.parametrize("method", list(STEPS))
def test_remat_step_matches_plain(method, checkpoint_calls):
    """Two steps with remat and without: the same losses, trainable grads
    and updated leaves, bit for bit (JAX ``test_remat_step_matches_plain``,
    ``test_remat_custom_forward_matches_plain``); only the remat'd step
    calls the checkpoint."""
    out = {}
    for remat in (False, True):
        del checkpoint_calls[:]
        state, run = STEPS[method](remat)
        losses = [float(run()) for _ in range(2)]
        leaves = engine.tree_leaves(state.trainable)
        out[remat] = (losses, [p.grad.clone() for p in leaves],
                      [p.detach().clone() for p in leaves])
        assert bool(checkpoint_calls) == remat, (remat, len(checkpoint_calls))
    assert out[False][0] == out[True][0]
    for a, b in zip(out[False][1] + out[False][2],
                    out[True][1] + out[True][2]):
        assert torch.equal(a, b)


def _trainer(tmp_path, method, *flags):
    parser = cli.base_parser()
    args = parser.parse_args(
        ["--method", method, "--model_name", "debug-tiny", "--dataset",
         "synthetic-10x8", "--n_tasks", "2", "--online_iter", "1",
         "--device", "cpu", "--transforms", "--log_path", str(tmp_path),
         *flags])
    return cli.trainer_class(method, args, parser)(cli.args_to_config(args))


@pytest.mark.parametrize("method", list(STEPS))
def test_remat_flag_and_large_batch_reach_the_step(tmp_path, method,
                                                   checkpoint_calls):
    """``--remat`` and ``batchsize >= 256`` checkpoint the tower forward in
    each method's train step, as the JAX policy ``cfg.remat or batchsize
    >= 256`` does (``tests/test_remat_flag.py``); at batch 8 without the
    flag nothing is checkpointed. Counted by calls to the checkpoint."""
    for flags, on in ((("--batchsize", "8"), False),
                      (("--batchsize", "8", "--remat"), True),
                      (("--batchsize", "256"), True)):
        tr = _trainer(tmp_path, method, *flags)
        idx = np.arange(4)
        images, labels = tr.train_dataset.gather(idx)
        tr.vocab.expose(labels)
        del checkpoint_calls[:]
        stats = tr.online_step(images, labels, idx)
        assert np.isfinite(float(stats["loss"]))
        assert bool(checkpoint_calls) == on, (flags, len(checkpoint_calls))


PROMPT_METHODS = ["l2p", "dualprompt", "mvp", "adapter-clip-proto_prompt"]


@pytest.mark.parametrize("method", PROMPT_METHODS)
def test_remat_in_the_prompt_trainers_matches_plain(tmp_path, method,
                                                    checkpoint_calls):
    """``--remat`` checkpoints the prompted forward of l2p, dualprompt and
    mvp (JAX ``jax.checkpoint`` of ``fwd_body`` / ``feats_body``) and
    ProtoCLIP's prompted image tower (its text passes checkpoint each layer
    whatever the flag): two online steps give the same losses and trainable
    tensors bit for bit, and only the flag adds checkpoint calls."""
    _two_online_steps_with_and_without_remat(tmp_path, method,
                                             checkpoint_calls)


def _two_online_steps_with_and_without_remat(tmp_path, method,
                                             checkpoint_calls):
    """Two online steps of ``method``'s trainer (bs 4, fp32) without and
    with ``--remat``: the same losses and trainable tensors bit for bit,
    and more checkpoint calls with the flag."""
    out = {}
    for flags in ((), ("--remat",)):
        tr = _trainer(tmp_path, method, "--batchsize", "4", "--no_bf16",
                      *flags)
        idx = np.arange(4)
        images, labels = tr.train_dataset.gather(idx)
        tr.vocab.expose(labels)
        del checkpoint_calls[:]
        losses = [float(tr.online_step(images, labels, idx)["loss"])
                  for _ in range(2)]
        out[flags] = (losses, len(checkpoint_calls), [
            p.detach().clone() for p in engine.tree_leaves(
                tr.state.trainable)])
    (plain, n_plain, t_plain), (remat, n_remat, t_remat) = out.values()
    assert plain == remat
    assert n_remat > n_plain, (n_plain, n_remat)
    assert all(torch.equal(a, b) for a, b in zip(t_plain, t_remat))


@pytest.mark.parametrize("method", ["er", "Finetuning", "lwf", "ewc++"])
def test_remat_in_the_er_family_matches_plain(tmp_path, method,
                                              checkpoint_calls):
    """``--remat`` in the ER family (JAX ``er_baseline.py:124-133``,
    ``lwf.py:56-113``, ``ewcpp.py:73-77``): the classifier step's whole
    forward checkpointed (Finetuning's whole trained tower with it), lwf's
    second step its KD step (the frozen tower's one pass feeds both heads,
    so the KD step has nothing to checkpoint), ewc++ both forwards of its
    double update; two online steps equal the plain ones bit for bit."""
    _two_online_steps_with_and_without_remat(tmp_path, method,
                                             checkpoint_calls)


class _State:
    def __init__(self):
        self.gen = torch.Generator().manual_seed(0)


def _fake_build(builds, fail):
    """A step factory whose steps draw from ``state.gen`` and then raise the
    card's OOM where ``fail(remat, call)`` says."""
    calls = []

    def build(remat):
        builds.append(remat)

        def step(state, x):
            draw = torch.rand(3, generator=state.gen)
            calls.append(remat)
            if fail(remat, len(calls)):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            return draw + x
        return step
    return build


def test_remat_fallback_rebuilds_once_with_the_restored_generator(caplog):
    """The first call's OOM rebuilds the step with remat, once, with one
    warning, and the retry draws what the failed call drew; the remat'd
    step then serves every later call."""
    builds = []
    step = engine.remat_fallback(_fake_build(builds, lambda r, n: not r))
    with caplog.at_level(logging.WARNING, logger="lifelong_clip_tpu_torch"):
        out = step(_State(), 0.0)
    want = torch.rand(3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, want)
    assert builds == [False, True]
    assert [r.levelname for r in caplog.records] == ["WARNING"]
    step(_State(), 0.0)
    assert builds == [False, True]


@pytest.mark.parametrize("case", ["oom after the fallback",
                                  "oom after a success"])
def test_remat_fallback_raises_a_later_oom(case):
    """An OOM of the remat'd step raises, as does one after a call has
    succeeded (the step provably fits: that is memory pressure)."""
    builds = []
    if case == "oom after the fallback":
        step = engine.remat_fallback(_fake_build(builds, lambda r, n: True))
        with pytest.raises(torch.cuda.OutOfMemoryError):
            step(_State(), 0.0)
        assert builds == [False, True]
    else:
        step = engine.remat_fallback(_fake_build(builds, lambda r, n: n > 1))
        step(_State(), 0.0)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            step(_State(), 0.0)
        assert builds == [False]
