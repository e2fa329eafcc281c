"""continual-clip (zero-shot frozen CLIP) and ``--zero_shot_evaluation``
against the JAX package: both trainers load one tiny OpenAI-layout
checkpoint written in the test (``--pretrained_path``), run the same short
Si-Blurry stream, and must give the same text features, logits,
predictions, accuracies and zero-shot accuracy. The port's "fused" road
(the kernel op's plain version on the CPU) is held against JAX's "pallas"
road in interpret mode, in fp32."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import dataclasses
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import StreamConfig as JStreamConfig
from lifelong_clip_tpu.config import TrainConfig as JTrainConfig
from lifelong_clip_tpu.data.registry import make_synthetic as jmake_synthetic
from lifelong_clip_tpu.models.convert import load_clip_params
from lifelong_clip_tpu.methods import continual_clip as jcontinual_clip
from lifelong_clip_tpu.methods import get_method as jget_method
from lifelong_clip_tpu.methods.zero_shot_eval import \
    run_zero_shot_eval as jzero_shot
from lifelong_clip_tpu.ops import attention as jattention
from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.config import StreamConfig, TrainConfig
from lifelong_clip_tpu_torch.data.registry import make_synthetic
from lifelong_clip_tpu_torch.methods import get_method
from lifelong_clip_tpu_torch.methods.zero_shot_eval import run_zero_shot_eval
from lifelong_clip_tpu_torch.utils.stream import iter_batches
from test_torch_convert import write_checkpoint

ZS = "synthetic-6x4"      # the held-out zero-shot dataset


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """A JAX and a port continual-clip trainer on one checkpoint (one layer
    a tower) and the same synthetic data, JAX on its "pallas" road."""
    d = tmp_path_factory.mktemp("cc")
    ckpt = str(d / "ViT-tiny.pt")
    write_checkpoint(ckpt, seed=3, layers=1, text_layers=1)
    kw = dict(method="continual-clip", dataset="synthetic-8",
              model_name="debug-tiny", pretrained_path=ckpt, batchsize=8,
              test_batchsize=8, eval_period=24, use_bf16=False)
    jcfg = JTrainConfig(stream=JStreamConfig(n_tasks=2, n=50, m=10, seed=1),
                        log_path=str(d / "jax"), **kw)
    tcfg = TrainConfig(stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1),
                       log_path=str(d / "port"), device="cpu", **kw)
    data = [(f(n_classes=8, per_class=6, image_size=32, seed=0),
             f(n_classes=8, per_class=3, image_size=32, seed=0, train=False))
            for f in (jmake_synthetic, make_synthetic)]
    for a, b in zip(*data):
        np.testing.assert_array_equal(a.images, b.images)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_DEFAULT_IMPL", "pallas")
        # JAX's build_clip for a file on disk: other test files swap the
        # builder in JAX's method modules for a tiny seeded tower and leave
        # it swapped in their worker process
        mp.setattr(jcontinual_clip, "build_clip",
                   lambda name, path=None, rng=None: load_clip_params(path))
        with pltpu.force_tpu_interpret_mode():
            jtr = jget_method("continual-clip")(jcfg, *data[0])
            ttr = get_method("continual-clip")(tcfg, *data[1])
            yield jtr, ttr


def test_registry_has_the_adapter_family():
    from lifelong_clip_tpu_torch.methods.adapter_clip import AdapterCLIP
    from lifelong_clip_tpu_torch.methods.continual_clip import ContinualCLIP
    assert get_method("continual-clip") is ContinualCLIP
    for name in ("lora-clip", "adapter-clip", "moe-clip"):
        assert get_method(name) is AdapterCLIP


def test_checkpoint_weights_reach_the_trainer(trainers):
    jtr, ttr = trainers
    assert dataclasses.asdict(ttr.clip_cfg) == dataclasses.asdict(
        jtr.clip_cfg)
    assert ttr.clip_cfg.vision_layers == 1
    assert not hasattr(ttr, "state")
    want = np.asarray(jtr.params["vision"]["blocks"]["attn"]["w_qkv"])
    np.testing.assert_array_equal(
        ttr.params["vision"]["blocks"]["attn"]["w_qkv"].numpy(), want)


def test_predictions_over_a_short_stream_match_jax(trainers):
    """Both trainers through the stream's two tasks as ``run`` drives them:
    online steps train nothing; after each task the text features of the
    exposed classes, the logits and predictions of every test batch, and
    the per-class counts of ``evaluate`` agree."""
    jtr, ttr = trainers
    for task_id in range(jtr.stream.n_tasks):
        np.testing.assert_array_equal(jtr.stream.task_indices[task_id],
                                      ttr.stream.task_indices[task_id])
        for idx in iter_batches(ttr.stream.task_indices[task_id], 8):
            images, labels = ttr.train_dataset.gather(idx)
            jtr.vocab.expose(labels)
            ttr.vocab.expose(labels)
            assert ttr.online_step(images, labels, idx) == {}
            assert jtr.online_step(images, labels, idx) == {}
        assert ttr.vocab.exposed == jtr.vocab.exposed
        jtr.prepare_eval()
        ttr.prepare_eval()
        assert ttr._txt_cache_n == len(ttr.vocab)
        # normalized features; the fused road rounds qkv/p/ctx to bf16 as
        # the kernel does, on both sides
        np.testing.assert_allclose(ttr._txt_cache.numpy(),
                                   np.asarray(jtr._txt_cache), atol=2e-3,
                                   rtol=0)
        n_preds = 0
        for lo in range(0, len(ttr.test_dataset), 8):
            images, _ = ttr.test_dataset.gather(np.arange(lo, lo + 8))
            tp, tl = ttr._eval_fn(ttr.params, None, torch.tensor(images),
                                  ttr._txt_cache, ttr._mask)
            jp, jl = jtr._eval_fn(jtr.params, None, images, jtr._txt_cache,
                                  jtr._mask)
            jl = np.asarray(jl)
            live = np.isfinite(jl)
            assert np.array_equal(live, np.isfinite(tl.numpy()))
            np.testing.assert_allclose(tl.numpy()[live], jl[live],
                                       atol=2e-3 * np.abs(jl[live]).max(),
                                       rtol=0)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            n_preds += len(tp)
        assert n_preds == len(ttr.test_dataset)
        for got, want in zip(ttr.evaluate(), jtr.evaluate()):
            np.testing.assert_array_equal(got, want)
        ttr._task_end_eval(task_id)
        ttr._maybe_checkpoint(task_id)   # no state, no --ckpt_dir: a no-op


def test_zero_shot_eval_matches_jax(trainers):
    """``run_zero_shot_eval`` on a held-out synthetic dataset: the same
    accuracy as JAX's (tail batch tiled up to test_batchsize), and the
    reference's line appended to result.txt."""
    jtr, ttr = trainers
    want = jzero_shot(jtr, [ZS])
    got = run_zero_shot_eval(ttr, [ZS, "no-such-dataset"])
    assert set(got) == {ZS}
    assert got[ZS] == want[ZS]
    text = open(os.path.join(ttr.result_dir(), "result.txt")).read()
    assert text.endswith(f"Dataset:{ZS} | test_acc:{got[ZS]:.4f}\n")


def test_cli_runs_continual_and_adapter_family_with_zero_shot(tmp_path):
    """``main`` with ``--pretrained_path`` and ``--zero_shot_evaluation``:
    continual-clip, and moe-clip on both towers (the zero-shot text tower
    runs through the trained text PEFT), each writing its result.txt with
    the zero-shot line."""
    ckpt = str(tmp_path / "ViT-tiny.pt")
    write_checkpoint(ckpt, layers=1, text_layers=1)
    for method in (["--method", "continual-clip"],
                   ["--method", "moe-clip", "--peft_encoder", "both"]):
        log_path = tmp_path / method[1]
        out = cli.main(method + [
            "--model_name", "debug-tiny", "--pretrained_path", ckpt,
            "--dataset", "synthetic-10x8", "--n_tasks", "2", "--batchsize",
            "8", "--test_batchsize", "8", "--eval_period", "32",
            "--transforms", "--device", "cpu", "--log_path", str(log_path),
            "--zero_shot_evaluation", "--zero_shot_dataset", ZS])
        assert set(out) == {"A_auc", "A_avg", "A_last", "F_last"}
        found = [os.path.join(d, "result.txt")
                 for d, _, fs in os.walk(log_path) if "result.txt" in fs]
        assert len(found) == 1
        text = open(found[0]).read()
        assert text.startswith("Dataset:synthetic-10x8 | A_auc ")
        assert f"Dataset:{ZS} | test_acc:" in text
