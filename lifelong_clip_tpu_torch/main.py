"""CLI entry, flag-compatible with ``lifelong_clip_tpu/main.py``.

    python -m lifelong_clip_tpu_torch.main --method lora-clip \
        --model_name ViT-B/16 --dataset synthetic-20 --batchsize 64 \
        --device cuda

The flags and defaults are the JAX package's (``main.py:20-175``) plus
``--device {cuda,cpu}`` (default ``cuda``). ``--zero_shot_evaluation``
classifies ``--zero_shot_dataset`` zero-shot after the run. ``--mesh DxM``
other than ``1x1`` runs one process a device under ``torchrun``:

    torchrun --nproc_per_node 8 -m lifelong_clip_tpu_torch.main \
        --method lora-clip --mesh 8x1 ...

each rank on ``cuda:LOCAL_RANK`` in an ``nccl`` group (``gloo`` with
``--device cpu``), ``D * M`` equal to ``WORLD_SIZE``.
"""

from __future__ import annotations

import argparse
import logging
import os

from .config import PEFTConfig, StreamConfig, TrainConfig


def base_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Online continual learning with CLIP on PyTorch/CUDA "
                    "(port of lifelong_clip_tpu)")
    p.add_argument("--method", type=str, default="lora-clip")
    p.add_argument("--dataset", type=str, default="cifar100")
    p.add_argument("--n_tasks", type=int, default=5)
    p.add_argument("--n", type=int, default=50)
    p.add_argument("--m", type=int, default=10)
    p.add_argument("--rnd_NM", action="store_true", default=False)
    p.add_argument("--rnd_seed", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--model_name", type=str, default="ViT-B/16")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--batchsize", type=int, default=64)
    p.add_argument("--test_batchsize", type=int, default=64)
    p.add_argument("--temp_batchsize", type=int, default=0)
    p.add_argument("--online_iter", type=float, default=1)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--opt_name", type=str, default="adamw")
    p.add_argument("--sched_name", type=str, default="default")
    p.add_argument("--memory_size", type=int, default=0)
    # NOTE default drift vs the reference: its configuration/config.py:67
    # defaults to 100, but every shipped launch script pins 1000 — we
    # default to the scripts' value (scripts here pin their own too), so
    # only bare-CLI runs differ
    p.add_argument("--eval_period", type=int, default=1000)
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--visible_classes", type=str, default="batch",
                   choices=["batch", "all"])
    p.add_argument("--peft_encoder", type=str, default="image",
                   choices=["none", "both", "text", "image"])
    p.add_argument("--lora_r", type=int, default=4)
    p.add_argument("--lora_alpha", type=int, default=1)
    p.add_argument("--ffn_num", type=int, default=64)
    # regularization / memory knobs (reference config.py:57,77,83)
    p.add_argument("--reg_coef", type=float, default=100,
                   help="weighting for the regularization loss term (EWC++)")
    p.add_argument("--memory_epoch", type=int, default=0,
                   help="post-task memory training epochs (Rainbow Memory)")
    p.add_argument("--rm_uncertainty", action="store_true",
                   help="Rainbow Memory: rebuild memory by MC vote-ratio "
                   "uncertainty at task ends (capability add — the "
                   "reference ships this machinery as dead code)")
    p.add_argument("--imp_update_period", type=int, default=1,
                   help="period between importance updates (CLIB)")
    # CLIB adaptive-LR knobs (reference config.py:78-80)
    p.add_argument("--lr_step", type=float, default=0.95,
                   help="step of iterating lr for adaptive LR")
    p.add_argument("--lr_length", type=int, default=10,
                   help="period of iterating lr for adaptive LR")
    p.add_argument("--lr_period", type=int, default=10,
                   help="period of iterating lr for adaptive LR")
    p.add_argument("--transforms", nargs="*", default=["cutmix", "autoaug"])
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--log_path", type=str, default="results")
    p.add_argument("--note", type=str, default="")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--no_bf16", action="store_true")
    p.add_argument("--ce_on_probs", type=int, default=1,
                   help="1 (default): adapter-clip family trains CE on "
                        "softmaxed probs, mirroring the reference's "
                        "shipped math (models/adapter_clip.py:94-100); "
                        "0: plain CE on logits")
    p.add_argument("--synthetic_fallback", action="store_true",
                   help="substitute synthetic data when the real dataset "
                        "is not on disk")
    p.add_argument("--mesh", type=str, default="1x1",
                   help="device mesh 'DATAxMODEL', e.g. 8x1")
    p.add_argument("--n_worker", type=int, default=0)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default; raises when no GPU is present) or "
                        "cpu (the kernels' plain versions)")
    p.add_argument("--remat", action="store_true",
                   help="force activation rematerialization in the train "
                        "step (auto-enabled at batchsize >= 256)")
    p.add_argument("--ckpt_dir", type=str, default="",
                   help="save resume checkpoints at task boundaries")
    p.add_argument("--resume_from", type=str, default="",
                   help="restore a run from this checkpoint dir")
    # epochs per task (reference --epochNum; its default is 6 — kept at 1
    # here so the default run is a true single-pass online stream)
    p.add_argument("--epochNum", type=int, default=1)
    p.add_argument("--text_template", type=str,
                   default="a bad photo of a {}.")
    # ProtoCLIP knobs (reference config.py:24-40)
    p.add_argument("--num_prompt", type=int, default=10)
    p.add_argument("--n_ctx", type=int, default=12)
    p.add_argument("--topK", type=int, default=2)
    p.add_argument("--num_sampled_pcls", type=int, default=64)
    p.add_argument("--ca", type=bool, default=True)
    p.add_argument("--ssca", type=bool, default=True)
    p.add_argument("--ca_epochs", type=int, default=5)
    p.add_argument("--selection_size", type=int, default=1)
    # accepted for reference-script compatibility; architecture makes them
    # moot here (bf16 policy replaces AMP; augmentation is always fused
    # on device; SPMD replaces process-level GPU counts)
    p.add_argument("--use_amp", action="store_true", default=False)
    p.add_argument("--gpu_transform", action="store_true", default=False)
    p.add_argument("--num_gpus", type=int, default=1)
    p.add_argument("--workers_per_gpu", type=int, default=1)
    p.add_argument("--gpt_dir", type=str, default="datasets/gpt/gpt_data")
    p.add_argument("--init_model", action="store_true", default=False)
    p.add_argument("--init_opt", action="store_true", default=False)
    # MVP flags (reference configuration/config.py:96-105)
    p.add_argument("--use_mask", action="store_true", default=False)
    p.add_argument("--use_contrastiv", action="store_true", default=False)
    p.add_argument("--use_afs", action="store_true", default=False)
    p.add_argument("--use_gsf", action="store_true", default=False)
    p.add_argument("--use_last_layer", action="store_true", default=False)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--gamma", type=float, default=2.0)
    p.add_argument("--margin", type=float, default=0.5)
    # zero-shot eval (reference config.py:113-116)
    p.add_argument("--zero_shot_evaluation", action="store_true",
                   default=False)
    p.add_argument("--zero_shot_dataset", nargs="+", type=str,
                   default=["food101", "caltech101", "eurosat",
                            "flowers102", "oxford_pet"])
    return p


def args_to_config(args) -> TrainConfig:
    try:
        mesh = tuple(int(x) for x in args.mesh.split("x"))
        if len(mesh) != 2 or any(m < 1 for m in mesh):
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--mesh expects 'DATAxMODEL' with positive integers "
            f"(e.g. 8x1, 4x2); got {args.mesh!r}")
    return TrainConfig(
        method=args.method, dataset=args.dataset,
        model_name=args.model_name, pretrained_path=args.pretrained_path,
        batchsize=args.batchsize, test_batchsize=args.test_batchsize,
        online_iter=args.online_iter, temp_batchsize=args.temp_batchsize,
        lr=args.lr, opt_name=args.opt_name, sched_name=args.sched_name,
        memory_size=args.memory_size, eval_period=args.eval_period,
        topk=args.topk, visible_classes=args.visible_classes,
        reg_coef=args.reg_coef, memory_epoch=args.memory_epoch,
        rm_uncertainty=args.rm_uncertainty,
        imp_update_period=args.imp_update_period, lr_step=args.lr_step,
        lr_length=args.lr_length, lr_period=args.lr_period,
        peft=PEFTConfig(method="none", encoder=args.peft_encoder,
                        lora_r=args.lora_r, lora_alpha=args.lora_alpha,
                        adapter_dim=args.ffn_num),
        stream=StreamConfig(n_tasks=args.n_tasks, n=args.n, m=args.m,
                            rnd_NM=args.rnd_NM, seed=args.rnd_seed),
        transforms=tuple(args.transforms), use_bf16=not args.no_bf16,
        data_dir=args.data_dir, log_path=args.log_path,
        note=args.note or f"{args.method}_{args.visible_classes}_"
                          f"{args.peft_encoder}_{args.seed}",
        debug=args.debug, mesh_shape=mesh, n_worker=args.n_worker,
        seed=args.seed, profile=args.profile, remat=args.remat,
        ckpt_dir=args.ckpt_dir,
        resume_from=args.resume_from, epoch_num=args.epochNum,
        text_template=args.text_template,
        ce_on_probs=bool(args.ce_on_probs), device=args.device)


# method-behavior flags map onto trainer class attributes (the reference
# wires them through kwargs; here the trainer classes carry the defaults),
# as ``lifelong_clip_tpu/main.py:_ATTR_FLAGS``. flag name -> attribute name
_ATTR_FLAGS = {
    "use_mask": "use_mask", "use_contrastiv": "use_contrastiv",
    "use_afs": "use_afs", "use_gsf": "use_gsf",
    "use_last_layer": "use_last_layer", "alpha": "alpha",
    "gamma": "gamma", "margin": "margin",
    "num_prompt": "num_prompt", "n_ctx": "n_ctx", "topK": "top_k",
    "num_sampled_pcls": "num_sampled_pcls", "ca": "ca", "ssca": "ssca",
    "ca_epochs": "ca_epochs", "selection_size": "selection_size",
}


def trainer_class(method: str, args, parser):
    """The method's trainer class, subclassed with the flags the command
    line set away from their defaults (a flag left at its default keeps
    the class's own value)."""
    from .methods import get_method
    cls = get_method(method)
    overrides = {attr: getattr(args, flag)
                 for flag, attr in _ATTR_FLAGS.items()
                 if hasattr(cls, attr)
                 and getattr(args, flag) != parser.get_default(flag)}
    if overrides:
        cls = type(cls.__name__, (cls,), overrides)
    return cls


def init_process_group(mesh_shape, device: str):
    """The process group of a ``--mesh`` run under ``torchrun``
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the rendezvous address in
    the environment): ``nccl`` on ``cuda:LOCAL_RANK``, which must be
    present, ``gloo`` on the CPU. Returns the rank's device."""
    import torch
    import torch.distributed as dist
    d, m = mesh_shape
    env = [os.environ.get(k) for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK")]
    if None in env:
        raise ValueError(
            f"--mesh {d}x{m} runs one process a device: launch it with "
            f"torchrun --nproc_per_node {d * m} -m "
            f"lifelong_clip_tpu_torch.main ... (WORLD_SIZE, RANK and "
            f"LOCAL_RANK are not set)")
    world, rank, local = (int(v) for v in env)
    if d * m != world:
        raise ValueError(f"--mesh {d}x{m} needs {d * m} processes; torchrun "
                         f"started WORLD_SIZE={world}")
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card: "
                f"{torch.cuda.device_count()} CUDA device(s) visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                            rank=rank, world_size=world)
    return dev


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    parser = base_parser()
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    meshed = cfg.mesh_shape != (1, 1)
    if meshed:
        import dataclasses
        dev = init_process_group(cfg.mesh_shape, args.device)
        cfg = dataclasses.replace(cfg, device=str(dev))
    try:
        trainer = trainer_class(cfg.method, args, parser)(
            cfg, synthetic_fallback=args.synthetic_fallback)
        out = trainer.run(resume_from=args.resume_from or None)
        if args.zero_shot_evaluation:
            from .methods.zero_shot_eval import run_zero_shot_eval
            run_zero_shot_eval(trainer, args.zero_shot_dataset,
                               synthetic_fallback=args.synthetic_fallback)
    finally:
        if meshed:
            import torch.distributed as dist
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
