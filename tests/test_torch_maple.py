"""The port's MaPLe (model and trainer) against the JAX package's, on the
same weights and inputs.

A ``debug-tiny`` tower (6 vision, 3 text layers), so both compound prompts
replace tokens in both towers. Weights and the learner come from the JAX
init through the bridge, inputs from numpy seeds. The port's ``"unfused"``
road is held against JAX's ``"xla"`` road in fp32 (summation order only,
1e-4 of scale), its ``"fused"`` road (the kernel op's plain version on the
CPU) against JAX's ``"pallas"`` road with the Pallas kernels in interpret
mode (both round q/k/v, p and ctx to bf16 at the same points: 2e-3 of scale
for values, 1e-2 for grads, as ``test_torch_clip.py``).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lifelong_clip_tpu.config import CLIP_PRESETS as JPRESETS
from lifelong_clip_tpu.models import maple as jmaple
from lifelong_clip_tpu.models.init import init_clip_params
from lifelong_clip_tpu.ops import attention as jattention
from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.bridge import params_from_numpy
from lifelong_clip_tpu_torch.config import CLIP_PRESETS
from lifelong_clip_tpu_torch.methods import maple as tmethod
from lifelong_clip_tpu_torch.models import maple as tmaple

JCFG, TCFG = JPRESETS["debug-tiny"], CLIP_PRESETS["debug-tiny"]
N_CTX = 3
ROUTES = [("unfused", "xla"), ("fused", "pallas")]
LEARNER_KEYS = ("ctx", "proj_w", "proj_b", "compound_text",
                "compound_proj_w", "compound_proj_b")


@functools.lru_cache(maxsize=None)
def _setup():
    frozen = init_clip_params(jax.random.PRNGKey(0), JCFG)
    learner = jmaple.init_maple_params(jax.random.PRNGKey(1), frozen, JCFG,
                                       n_ctx=N_CTX, depth=3,
                                       ctx_init_tokens=[5, 6, 7, 8])
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((4, JCFG.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:5] = [5, 6, 7, 8]
    tokens[:, 5] = rng.integers(1000, 40000, 4)
    tokens[np.arange(4), [6, 7, 6, 8]] = 49407
    return (jax.tree.map(np.asarray, frozen), jax.tree.map(np.asarray, learner),
            images, tokens)


_JAX = {}


def _jax_ref(jimpl):
    """JAX's raw text and image embeddings, the logits of ``maple_forward``
    and the grads of sum(logits**2) w.r.t. the learner; one jitted run per
    road (JAX's maple blocks take the default road, set to "pallas" with
    the kernels in interpret mode for the fused comparison)."""
    if jimpl not in _JAX:
        frozen, learner, images, tokens = _setup()
        frozen = jax.tree.map(jnp.asarray, frozen)

        def fn(lp):
            txt = jmaple.maple_encode_text(frozen, lp, jnp.asarray(tokens),
                                           JCFG, N_CTX, jnp.float32)
            img = jmaple.maple_encode_image(frozen, lp, jnp.asarray(images),
                                            JCFG, N_CTX, jnp.float32)
            logits, _, _ = jmaple.maple_forward(
                frozen, lp, jnp.asarray(images), jnp.asarray(tokens), JCFG,
                N_CTX, jnp.float32)
            return jnp.sum(logits ** 2), (txt, img, logits)

        def run():
            (_, aux), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
                learner)
            return ([np.asarray(a) for a in aux],
                    jax.tree.map(np.asarray, grads))

        if jimpl == "xla":
            _JAX[jimpl] = run()
        else:
            with pytest.MonkeyPatch.context() as mp, \
                    pltpu.force_tpu_interpret_mode():
                mp.setattr(jattention, "_DEFAULT_IMPL", "pallas")
                _JAX[jimpl] = run()
    return _JAX[jimpl]


def _close(got, want, rel):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale)


@pytest.mark.parametrize("impl,jimpl", ROUTES)
def test_maple_towers_and_forward_match_jax(impl, jimpl):
    """maple_encode_text, maple_encode_image and maple_forward, and the
    grads of every learner leaf."""
    (jtxt, jimg, jlogits), jgrads = _jax_ref(jimpl)
    frozen, learner, images, tokens = _setup()
    tfrozen = params_from_numpy(frozen)
    tl = params_from_numpy(learner)
    for leaf in tl.values():
        leaf.requires_grad_(True)
    timg, ttok = torch.tensor(images), torch.tensor(tokens)
    kw = dict(compute_dtype=torch.float32, attn_impl=impl)
    with torch.no_grad():
        txt = tmaple.maple_encode_text(tfrozen, tl, ttok, TCFG, N_CTX, **kw)
        img = tmaple.maple_encode_image(tfrozen, tl, timg, TCFG, N_CTX, **kw)
    logits, _, _ = tmaple.maple_forward(tfrozen, tl, timg, ttok, TCFG, N_CTX,
                                        **kw)
    (logits ** 2).sum().backward()
    tol_y, tol_g = (1e-4, 1e-4) if impl == "unfused" else (2e-3, 1e-2)
    _close(txt.numpy(), jtxt, tol_y)
    _close(img.numpy(), jimg, tol_y)
    _close(logits.detach().numpy(), jlogits, tol_y)
    for k in LEARNER_KEYS:
        _close(tl[k].grad.numpy(), jgrads[k], tol_g)


def test_maple_init_matches_jax_layout():
    """ctx from the init phrase's embeddings; the compound projections
    share one init; nn.Linear's bounds; the JAX tree's shapes."""
    frozen, learner, *_ = _setup()
    tfrozen = params_from_numpy(frozen)
    tl = tmaple.init_maple_params(torch.Generator().manual_seed(0), tfrozen,
                                  TCFG, n_ctx=N_CTX, depth=3,
                                  ctx_init_tokens=[5, 6, 7, 8], device="cpu")
    for k in LEARNER_KEYS:
        assert tuple(tl[k].shape) == learner[k].shape, k
        assert tl[k].dtype == torch.float32
    np.testing.assert_array_equal(
        tl["ctx"].numpy(), frozen["text"]["token_embedding"][[5, 6, 7]])
    assert torch.equal(tl["compound_proj_w"][0], tl["compound_proj_w"][1])
    assert float(tl["proj_w"].abs().max()) <= (3.0 / TCFG.text_width) ** 0.5
    vals, flags = tmaple._replacement_arrays(TCFG.vision_layers,
                                             tl["compound_text"], N_CTX,
                                             TCFG.text_width, torch.float32)
    assert flags == [False, True, True, False, False, False]
    assert torch.equal(vals[2], tl["compound_text"][1])


def test_cli_cpu_maple_run_writes_result(tmp_path, monkeypatch):
    seen = {}
    orig = tmethod.MaPLe.setup_model

    def spy(self):
        orig(self)
        seen["trainer"] = self
        seen["init"] = {k: v.detach().clone()
                        for k, v in self.learner.items()}

    monkeypatch.setattr(tmethod.MaPLe, "setup_model", spy)
    out = cli.main(["--method", "maple", "--model_name", "debug-tiny",
                    "--dataset", "synthetic-10x8", "--n_tasks", "2",
                    "--batchsize", "8", "--test_batchsize", "8",
                    "--eval_period", "32", "--device", "cpu", "--transforms",
                    "--log_path", str(tmp_path)])
    assert set(out) == {"A_auc", "A_avg", "A_last", "F_last"}
    assert np.isfinite(out["A_last"])
    tr = seen["trainer"]
    assert tr.vocab.template == "a bad photo of a {}."
    moved = float((tr.state.trainable["ctx"].detach()
                   - seen["init"]["ctx"]).abs().max())
    assert moved > 0
    found = [os.path.join(d, "result.txt") for d, _, fs in os.walk(tmp_path)
             if "result.txt" in fs]
    assert len(found) == 1
