"""Rank processes for the port's mesh tests, and what each rank runs.

``RankPool`` starts ``n`` CPU processes once (``spawn``, one intra-op thread
each); ``run(fn, world, *args)`` has the first ``world`` of them join a
fresh ``gloo`` group (``file://`` rendezvous in the pool's directory, so
parallel test workers never share a port), call ``fn(rank, world, *args)``
and leave the group. A rank that raises, or a case past its timeout, fails
the call and stops the pool; the next call starts a new one.

This module imports only torch, numpy and the port, so the ranks never
import JAX. The tiny trainers run ``debug-tiny`` in fp32 with SGD and the
train pipeline replaced by the eval preprocessing (the ranks' draws differ
by design; the steps are held on the same pixels).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_CLS, IMG = 8, 32
B = 4


def _serve(rank, inbox, outbox):
    torch.set_num_threads(1)
    while True:
        task = inbox.get()
        if task is None:
            return
        fn, world, path, args = task
        try:
            dist.init_process_group(
                "gloo", init_method="file://" + path, rank=rank,
                world_size=world, timeout=datetime.timedelta(seconds=90))
            try:
                val = fn(rank, world, *args)
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
            outbox.put((rank, True, val))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))


class RankPool:
    def __init__(self, n: int, tmp: str):
        self.n, self.tmp, self._k = n, tmp, 0
        self.procs = None

    def _start(self):
        ctx = mp.get_context("spawn")
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(self.n)]
        self.procs = [ctx.Process(target=_serve, args=(r, q, self.outbox),
                                  daemon=True)
                      for r, q in enumerate(self.inboxes)]
        for p in self.procs:
            p.start()

    def run(self, fn, world, *args, timeout=150.0):
        """[fn(rank, world, *args) for each rank], from the ranks."""
        assert world <= self.n
        if self.procs is None:
            self._start()
        self._k += 1
        path = os.path.join(self.tmp, f"pg{self._k}")
        for r in range(world):
            self.inboxes[r].put((fn, world, path, args))
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < world:
            try:
                r, ok, val = self.outbox.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{fn.__name__}: ranks {sorted(out)} of "
                                   f"{world} answered in {timeout} s")
            if not ok:
                self.close()
                raise RuntimeError(f"{fn.__name__}, rank {r}:\n{val}")
            out[r] = val
        return [out[r] for r in range(world)]

    def close(self):
        if self.procs is None:
            return
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
        self.procs = None


# -- tiny trainers ------------------------------------------------------------

ALL_METHODS = ["continual-clip", "lora-clip", "adapter-clip", "moe-clip",
               "er", "Finetuning", "lwf", "ewc++", "clib", "rm", "maple",
               "mvp-clip", "adapter-clip-proto_prompt", "template", "l2p",
               "dualprompt", "mvp"]
MODEL_AXIS_METHODS = ("lora-clip", "adapter-clip", "moe-clip",
                      "continual-clip")
ER_FAMILY = ("er", "Finetuning", "lwf", "ewc++", "clib", "rm")
# per-method knobs at the tiny size (the JAX sharding tests' own)
ATTRS = {"adapter-clip-proto_prompt": dict(n_ctx=3, top_k=2, num_prompt=4,
                                           num_sampled_pcls=8, ca_epochs=1),
         "template": dict(n_ctx=3, top_k=2, num_prompt=4,
                          num_sampled_pcls=8, ca_epochs=1),
         "l2p": dict(pool_size=4, selection_size=2, prompt_len=2),
         "dualprompt": dict(pos_g=(0,), pos_e=(1,), len_g=2, len_e=4),
         "mvp-clip": dict(use_mask=True, use_contrastiv=True, use_afs=True,
                          use_gsf=True),
         "mvp": dict(use_mask=True, use_contrastiv=True, use_afs=True,
                     use_gsf=True)}


@contextlib.contextmanager
def same_pixels():
    """The train pipeline replaced by the eval preprocessing and the MoE
    gate noise by zeros while the block runs (the ranks draw theirs from
    their own generators, the 1-process step from the state's); both are
    put back after, in the ranks and in the test process alike."""
    from lifelong_clip_tpu_torch.ops import moe, preprocess
    real = preprocess.make_train_pipeline, moe.draw_gate_noise

    def make(image_size, mean, std, out_dtype=torch.float32, **_):
        pipe = preprocess.make_eval_pipeline(image_size, mean, std,
                                             out_dtype=out_dtype)
        return lambda gen, x: pipe(x)

    preprocess.make_train_pipeline = make
    moe.draw_gate_noise = lambda gen, shape, device: torch.zeros(
        shape, device=device)
    try:
        yield
    finally:
        preprocess.make_train_pipeline, moe.draw_gate_noise = real


def make_trainer(method, mesh=(1, 1), log_path="/tmp/llc_mesh", attrs=None,
                 **cfg_kw):
    """The method's trainer on ``debug-tiny`` under ``mesh`` (fp32 on the
    ``"unfused"`` road, whose products the fused kernels' plain versions
    would round to bf16; SGD at lr 0.1, transforms off, the ER family with
    replay memory); every leaf
    of its trainable tree that starts at zero gets seeded N(0, 0.05^2)
    draws, so that every grad is live."""
    from lifelong_clip_tpu_torch.config import (PEFTConfig, StreamConfig,
                                                TrainConfig)
    from lifelong_clip_tpu_torch.data.registry import make_synthetic
    from lifelong_clip_tpu_torch.methods import get_method
    from lifelong_clip_tpu_torch.methods.engine import tree_leaves

    kw = dict(method=method, dataset="synthetic-8", model_name="debug-tiny",
              batchsize=B, test_batchsize=B, online_iter=1, lr=0.1,
              opt_name="sgd", memory_size=16 if method in ER_FAMILY else 0,
              transforms=(), use_bf16=False,
              stream=StreamConfig(n_tasks=2, n=50, m=10, seed=1),
              peft=PEFTConfig(encoder="both"), log_path=log_path, seed=1,
              device="cpu", mesh_shape=tuple(mesh))
    kw.update(cfg_kw)
    cls = get_method(method)
    # the towers on the plain road where no model axis sets it (the
    # trainers of meshes name theirs ``_attn_impl``, the others
    # ``attn_impl``)
    a = dict(ATTRS.get(method, {}), attn_impl="unfused",
             _attn_impl="unfused", **(attrs or {}))
    cls = type(cls.__name__, (cls,), a)
    train = make_synthetic(n_classes=N_CLS, per_class=6, image_size=IMG,
                           seed=0)
    test = make_synthetic(n_classes=N_CLS, per_class=2, image_size=IMG,
                          seed=0, train=False)
    tr = cls(TrainConfig(**kw), train_dataset=train, test_dataset=test)
    state = getattr(tr, "state", None)
    if state is not None:
        rng = np.random.default_rng(5)
        with torch.no_grad():
            for p in tree_leaves(state.trainable):
                if not p.any():
                    p.copy_(torch.from_numpy(
                        0.05 * rng.standard_normal(tuple(p.shape))))
    return tr


def batches(n_steps=2, seed=3):
    rng = np.random.default_rng(seed)
    for i in range(n_steps):
        images = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
        labels = rng.permutation(N_CLS)[:B]
        yield images, labels, np.arange(i * B, (i + 1) * B)


def flat(tree, path=()):
    """{key path: numpy leaf} of a nested dict/list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, path + (k,)))
        elif isinstance(v, torch.Tensor):
            out[path + (k,)] = v.detach().float().cpu().numpy().copy()
        elif isinstance(v, np.ndarray):
            out[path + (k,)] = v
    return out


def counters(tr):
    """The method's state outside the optimizer, as numpy."""
    out = {}
    for name in ("counter", "count"):
        v = getattr(tr, name, None)
        if isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy().copy()
    return out


def trainer_steps(rank, world, method, mesh, n_steps=2, grads=False,
                  attrs=None, cfg_kw=None):
    """``n_steps`` online steps of ``method`` on the same batches (eval for
    continual-clip): losses, trainable leaves (and grads), counters and the
    eval counts, as numpy."""
    with same_pixels():
        tr = make_trainer(method, mesh, attrs=attrs, **(cfg_kw or {}))
        losses = []
        for images, labels, idx in batches(n_steps):
            tr.vocab.expose(labels)
            st = tr.online_step(images, labels, idx)
            if st:
                losses.append((float(st["loss"]), float(st["acc"])))
    state = getattr(tr, "state", None)
    frozen = tr.params if state is None else state.frozen
    out = {"losses": losses, "counters": counters(tr),
           "frozen_shapes": {k: v.shape for k, v in flat(frozen).items()},
           "dp": tr._dp_mesh is not None,
           "eval_dp": tr._eval_dp_mesh is not None,
           "warned": bool(getattr(tr, "_warned_mesh_skip", False))}
    if state is not None:
        out["trainable"] = flat(state.trainable)
        if grads:
            out["grads"] = {k: v for k, v in flat(
                _grad_tree(state.trainable)).items()}
    correct, total = tr.evaluate()
    out["eval"] = (correct, total)
    return out


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def model_axis_rejected(rank, world, methods):
    """{method: the ValueError's message} under a model-axis mesh."""
    out = {}
    for method in methods:
        try:
            make_trainer(method, (1, world))
        except ValueError as e:
            out[method] = str(e)
        else:
            out[method] = None
    return out


def aug_draws(rank, world):
    """Under 2x1 with the default transforms, lora-clip's pipeline outputs
    for two identical halves of a batch (rank 0 gets one, rank 1 the
    other), and the state generator's next draw after the step."""
    from lifelong_clip_tpu_torch.ops import preprocess
    seen = []
    real = preprocess.make_train_pipeline

    def recording(*a, **kw):
        pipe = real(*a, **kw)

        def run(gen, x):
            y = pipe(gen, x)
            seen.append(y.detach().numpy().copy())
            return y
        return run

    preprocess.make_train_pipeline = recording
    try:
        tr = make_trainer("lora-clip", (world, 1),
                          transforms=("cutmix", "autoaug"))
        images, labels, idx = next(batches(1))
        images = np.concatenate([images[:B // 2]] * 2)
        labels = np.concatenate([labels[:B // 2]] * 2)
        tr.vocab.expose(labels)
        tr.online_step(images, labels, idx)
    finally:
        preprocess.make_train_pipeline = real
    nxt = int(torch.randint(0, 2 ** 30, (1,), generator=tr.state.gen))
    return seen[0], nxt


def short_run(rank, world, method, tmp, ckpt=""):
    """A two-task ``run()`` under ``(world, 1)`` with rank-own log paths:
    the summary, memory, metrics and trainable state, and the files each
    rank wrote."""
    from lifelong_clip_tpu_torch.methods.zero_shot_eval import \
        run_zero_shot_eval
    log_path = os.path.join(tmp, f"{method}-rank{rank}")
    with same_pixels():
        tr = make_trainer(method, (world, 1), log_path=log_path,
                          ckpt_dir=ckpt)
        out = tr.run()
        zero_shot = (run_zero_shot_eval(tr, ["synthetic-10x8"])
                     if method in ("lora-clip", "continual-clip") else None)
    files = sorted(os.path.relpath(os.path.join(d, f), log_path)
                   for d, _, fs in os.walk(log_path) for f in fs)
    state = getattr(tr, "state", None)
    return {"summary": out, "zero_shot": zero_shot, "files": files,
            "memory": (list(tr.memory.indices), list(tr.memory.labels)),
            "task_acc": [np.asarray(a) for a in tr.metrics.task_acc],
            "trainable": None if state is None else flat(state.trainable),
            "counters": counters(tr)}


def restored(rank, world, ckpt, mesh=None):
    """A fresh lora-clip trainer under ``mesh`` (default ``(world, 1)``)
    restored from ``ckpt``: its trainable leaves, optimizer and generator
    state, memory and cursor."""
    tr = make_trainer("lora-clip", mesh or (world, 1))
    from lifelong_clip_tpu_torch.utils.checkpoints import restore_trainer
    cursor = restore_trainer(tr, ckpt)
    return {"trainable": flat(tr.state.trainable), "cursor": cursor,
            "gen": tr.state.gen.get_state().numpy(),
            "step": tr.state.step, "opt": tr.state.opt.state_dict(),
            "task_acc": [np.asarray(a) for a in tr.metrics.task_acc]}


def bridged_steps(rank, world, method, frozen, trainable, n_steps=2):
    """``trainer_steps`` under ``(world, 1)`` from another package's weights
    (numpy trees: the frozen CLIP tree, the trainable tree)."""
    from lifelong_clip_tpu_torch.bridge import params_from_numpy
    from lifelong_clip_tpu_torch.models.clip import cast_towers
    with same_pixels():
        tr = make_trainer(method, (world, 1))
        tr.state.frozen = cast_towers(params_from_numpy(frozen),
                                      torch.float32)
        want, live = flat(trainable), flat(tr.state.trainable)
        assert want.keys() == live.keys(), (sorted(want), sorted(live))
        with torch.no_grad():
            for k, p in _leaf_refs(tr.state.trainable).items():
                p.copy_(torch.from_numpy(want[k]))
        tr.state.reset_optimizer()
        losses = []
        for images, labels, idx in batches(n_steps):
            tr.vocab.expose(labels)
            st = tr.online_step(images, labels, idx)
            losses.append((float(st["loss"]), float(st["acc"])))
    return {"losses": losses, "trainable": flat(tr.state.trainable),
            "counters": counters(tr)}


def _leaf_refs(tree, path=()):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_leaf_refs(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def main_under_env(rank, world, tmp, port):
    """``main()`` as ``torchrun`` would start it on the CPU: the pool's
    group is left first, main makes and destroys its own."""
    from lifelong_clip_tpu_torch import main as cli
    dist.destroy_process_group()
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        out = cli.main(["--method", "lora-clip", "--model_name", "debug-tiny",
                        "--dataset", "synthetic-10x8", "--n_tasks", "2",
                        "--batchsize", "8", "--device", "cpu",
                        "--transforms", "--mesh", f"{world}x1",
                        "--log_path", tmp])
    finally:
        for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            os.environ.pop(k, None)
    return {"summary": out, "initialized_after": dist.is_initialized()}


# -- the depth pipeline (parallel/pipeline.py) --------------------------------

def _pp_mesh(shape):
    """The mesh of the pool's group, or the one-process (1, 1) mesh."""
    from lifelong_clip_tpu_torch.parallel import mesh as mesh_lib
    cpu = torch.device("cpu")
    if tuple(shape) == (1, 1):
        return mesh_lib.Mesh((1, 1), 0, cpu)
    return mesh_lib.make_mesh(tuple(shape), cpu)


def _rows_of_all(x, mesh):
    """The data group's rows of ``x`` in rank order."""
    from lifelong_clip_tpu_torch.parallel import mesh as mesh_lib
    return x if mesh.data == 1 else mesh_lib.gather_rows(x, mesh)


@contextlib.contextmanager
def fused_calls():
    """{'fwd', 'bwd'}: the fused block op's forward and backward calls
    while the block runs (its plain versions on the CPU); put back after."""
    from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
    calls = {"fwd": 0, "bwd": 0}
    real = fba._forward, fba._backward

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real[0](*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real[1](*a, **kw)

    fba._forward, fba._backward = fwd, bwd
    try:
        yield calls
    finally:
        fba._forward, fba._backward = real


def pp_transformer(rank, world, shape, micro, x, blocks, heads, lora=None,
                   cot=None, attn_impl="unfused", remat=False):
    """``pipelined_transformer`` under the ``(data, model)`` mesh
    ``shape`` on this rank's rows of ``x`` (numpy, the whole batch) with
    the stage's slice of ``blocks`` (and of the vision LoRA stack
    ``lora``): the output of every row (gathered over the data group); with
    ``cot``, the output's cotangent, also the grads of every row of ``x``
    and of the whole LoRA stack (gathered over the stages); the fused op's
    calls on this rank."""
    from lifelong_clip_tpu_torch.bridge import params_from_numpy
    from lifelong_clip_tpu_torch.config import PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import tree_leaves
    from lifelong_clip_tpu_torch.parallel import mesh as mesh_lib
    from lifelong_clip_tpu_torch.parallel.pipeline import \
        pipelined_transformer
    mesh = _pp_mesh(shape)
    blk = mesh_lib.shard_params_pp(
        {"vision": {"blocks": params_from_numpy(blocks)}},
        mesh)["vision"]["blocks"]
    peft = peft_cfg = None
    if lora is not None:
        peft = mesh_lib.shard_params_pp(params_from_numpy(lora), mesh,
                                        match=())
        for p in tree_leaves(peft):
            p.requires_grad_(True)
        peft_cfg = PEFTConfig(method="lora", encoder="image",
                              lora_r=lora["lora"]["a_in"].shape[-1])
    xl = mesh.local(torch.tensor(x)).requires_grad_(cot is not None)
    with fused_calls() as calls:
        out = pipelined_transformer(
            xl, blk, heads, mesh=mesh, n_microbatches=micro,
            peft_cfg=peft_cfg, peft=peft, attn_impl=attn_impl, remat=remat)
        res = {"out": _rows_of_all(out, mesh).detach().numpy().copy()}
        if cot is not None:
            (out * mesh.local(torch.from_numpy(cot))).sum().backward()
            res["gx"] = _rows_of_all(xl.grad, mesh).numpy().copy()
            if peft is not None:
                grads = mesh_lib.gather_stages(
                    _grad_tree(peft), mesh, len(blocks["ln_1"]["scale"]),
                    match=())
                res["glora"] = flat(grads)
    res["calls"] = dict(calls)
    return res


def pp_train_step(rank, world, shape, micro, cfg_kw, frozen, peft, batch,
                  remat=False, mean=(0.5,) * 3, std=(0.25,) * 3):
    """One lora-clip train step (image LoRA, AdamW 1e-3, fp32, the
    ``"unfused"`` road, the train pipeline replaced by the eval
    preprocessing) from the numpy trees ``frozen`` and ``peft`` on the
    numpy ``batch`` (whole): under ``shape`` (M > 1) with the vision tower
    pipelined (``make_pp_forward``) and this rank's rows, else the
    1-process step on all of it. The loss and the whole trainable tree
    after the step (gathered over the stages), and under a mesh one draw of
    the rank's per-row generator (``Mesh.fold_gen``)."""
    from lifelong_clip_tpu_torch.bridge import params_from_numpy
    from lifelong_clip_tpu_torch.config import CLIPConfig, PEFTConfig
    from lifelong_clip_tpu_torch.methods.engine import (TrainState,
                                                        make_train_step)
    from lifelong_clip_tpu_torch.parallel import mesh as mesh_lib
    from lifelong_clip_tpu_torch.parallel.pipeline import make_pp_forward
    from lifelong_clip_tpu_torch.utils.train_utils import make_optimizer
    cfg = CLIPConfig(**cfg_kw)
    peft_cfg = PEFTConfig(method="lora", encoder="image", lora_r=4)
    frozen, trainable = params_from_numpy(frozen), params_from_numpy(peft)
    mesh = _pp_mesh(shape) if world > 1 else None
    fwd = dp = None
    if mesh is not None:
        frozen = mesh_lib.shard_params_pp(frozen, mesh)
        trainable = mesh_lib.shard_params_pp(trainable, mesh,
                                             match=("vision",))
        fwd = make_pp_forward(cfg, peft_cfg, mesh, micro,
                              compute_dtype=torch.float32,
                              attn_impl="unfused")
        dp = mesh if mesh.data > 1 else None
    state = TrainState(trainable=trainable, frozen=frozen,
                       make_opt=lambda lv: make_optimizer("adamw", lv, 1e-3),
                       gen=torch.Generator().manual_seed(2))
    rows = (lambda a: a) if dp is None else dp.local
    b = {"images": rows(torch.from_numpy(batch["images"])),
         "labels": rows(torch.from_numpy(batch["labels"]).long()),
         "tokens": torch.from_numpy(batch["tokens"]).long(),
         "mask": torch.from_numpy(batch["mask"])}
    with same_pixels(), fused_calls() as calls:
        step = make_train_step(cfg, peft_cfg, image_size=cfg.image_size,
                               mean=mean, std=std,
                               compute_dtype=torch.float32,
                               attn_impl="unfused", forward_fn=fwd, dp=dp,
                               remat=remat)
        loss = float(step(state, b)["loss"])
    tree = state.trainable
    draw = None
    if mesh is not None:
        tree = mesh_lib.gather_stages(tree, mesh, cfg.vision_layers,
                                      match=("vision",))
        draw = int(torch.randint(0, 2 ** 30, (1,), generator=mesh.fold_gen(
            torch.Generator().manual_seed(7))))
    return {"loss": loss, "trainable": flat(tree), "calls": dict(calls),
            "draw": draw}
