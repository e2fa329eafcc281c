"""CLI entry, flag-compatible with ``lifelong_clip_tpu/main.py``.

    python -m lifelong_clip_tpu_torch.main --method lora-clip \
        --model_name ViT-B/16 --dataset synthetic-20 --batchsize 64 \
        --transforms --device cuda

The flags and defaults are the JAX package's (``main.py:20-175``) plus
``--device {cuda,cpu}`` (default ``cuda``). Flags of parts not ported yet
(other methods, AutoAugment, meshes, checkpoints, zero-shot eval) raise
``NotImplementedError`` naming the ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import logging

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


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = base_parser().parse_args(argv)
    cfg = args_to_config(args)
    if args.zero_shot_evaluation:
        raise NotImplementedError("zero-shot evaluation is not ported yet "
                                  "(ROADMAP.md, queue A)")
    from .methods import get_method
    trainer = get_method(cfg.method)(
        cfg, synthetic_fallback=args.synthetic_fallback)
    return trainer.run()


if __name__ == "__main__":
    main()
